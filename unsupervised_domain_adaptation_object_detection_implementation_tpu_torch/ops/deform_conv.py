"""Deformable convolution v1 / v2 (counterpart of the JAX package's
`ops/deform_conv.py`: `_bilinear_gather`, `deform_conv2d`,
`batched_deform_conv2d`).

The JAX package writes it as XLA code, not as a Pallas kernel, and so
does the port, in plain torch with autograd:

  1. bilinear sampling of the input at `p0 + p_k + Δp(p, k)`: four row
     gathers of the (B·H·W, C) map, each corner tested inside the map on
     its own and the whole sample valid only for -1 < y < H, -1 < x < W;
  2. one product (B·Ho·Wo, K·C) x (K·C, Co) in float32, cast to the input's
     type before the bias is added.

Offsets follow mmcv: `offsets[..., 2k] = Δy_k`, `offsets[..., 2k+1] =
Δx_k`, the K taps row-major over the kernel window; v2 multiplies each
sample by its mask (no sigmoid here). Samples outside the map read 0.
Coordinates are computed in the offsets' type, as the JAX package adds
its integer grid to them (bf16 offsets give bf16 sample positions).
`floor` passes no gradient, so the offsets get the gradient of the
bilinear weights alone, at integer positions too.

Tensors are NHWC and the weight HWIO (kh, kw, C, Co), the JAX layouts.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bilinear_gather(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
                     ) -> torch.Tensor:
    """Sample x (B, H, W, C) at float (B, ...) coords, zero outside →
    (B, ..., C)."""
    b, h, w, c = x.shape
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    flat = x.reshape(b * h * w, c)
    first = (torch.arange(b, device=x.device) * (h * w)).view(
        (b,) + (1,) * (ys.dim() - 1))

    def tap(yi, xi, wgt):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + first
        vals = flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (c,))
        return vals * (wgt * inside * valid)[..., None]

    y0i = y0.long()
    x0i = x0.long()
    return (tap(y0i, x0i, (1 - wy1) * (1 - wx1))
            + tap(y0i, x0i + 1, (1 - wy1) * wx1)
            + tap(y0i + 1, x0i, wy1 * (1 - wx1))
            + tap(y0i + 1, x0i + 1, wy1 * wx1))


def batched_deform_conv2d(x: torch.Tensor,
                          offsets: torch.Tensor,
                          weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: int = 1,
                          padding: Optional[int] = None,
                          dilation: int = 1,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """x (B, H, W, C), offsets (B, Ho, Wo, 2K), weight (kh, kw, C, Co),
    mask (v2) (B, Ho, Wo, K) or None → (B, Ho, Wo, Co) in x's type, with
    Ho = (H + 2p − d·(kh−1) − 1) // s + 1."""
    b, h, w, c = x.shape
    kh, kw, wc, co = weight.shape
    if wc != c:
        raise ValueError(f'weight in_channels {wc} != input {c}')
    k = kh * kw
    if padding is None:
        padding = (dilation * (kh - 1)) // 2
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    if tuple(offsets.shape) != (b, ho, wo, 2 * k):
        raise ValueError(f'offsets {tuple(offsets.shape)} != '
                         f'{(b, ho, wo, 2 * k)}')
    dev = x.device
    oy = torch.arange(ho, device=dev) * stride - padding
    ox = torch.arange(wo, device=dev) * stride - padding
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dilation,
                            torch.arange(kw, device=dev) * dilation,
                            indexing='ij')
    base_y = oy[:, None, None] + ky.reshape(-1)[None, None, :]   # (Ho,1,K)
    base_x = ox[None, :, None] + kx.reshape(-1)[None, None, :]   # (1,Wo,K)
    off = offsets.reshape(b, ho, wo, k, 2)
    ys = base_y + off[..., 0]
    xs = base_x + off[..., 1]

    sampled = _bilinear_gather(x, ys, xs)                  # (B,Ho,Wo,K,C)
    if mask is not None:
        sampled = sampled * mask[..., None]
    out = (sampled.float().reshape(b * ho * wo, k * c)
           @ weight.reshape(k * c, co).float())
    out = out.reshape(b, ho, wo, co).to(x.dtype)
    return out if bias is None else out + bias


def deform_conv2d(x: torch.Tensor,
                  offsets: torch.Tensor,
                  weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  stride: int = 1,
                  padding: Optional[int] = None,
                  dilation: int = 1,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One image: x (H, W, C), offsets (Ho, Wo, 2K), mask (Ho, Wo, K) or
    None → (Ho, Wo, Co)."""
    return batched_deform_conv2d(
        x[None], offsets[None], weight, bias, stride, padding, dilation,
        None if mask is None else mask[None])[0]
