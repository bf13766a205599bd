"""Swin Transformer trunk (counterpart of the JAX package's
`models/backbones/swin.py`), the trunk of DeepAlign-Swin and of the zoo's
Swin Mask R-CNN configs.

The computation is the JAX module's, step for step:

- the patch embed is a 4x4/4 conv with flax's 'SAME' padding (it pads
  only a size that is not a multiple of 4, the extra row or column split
  low/high as `lax.conv` splits it), then `patch_norm`;
- each stage pads its map once to a multiple of the window (zeros at the
  bottom and right), runs its blocks on the padded map without zeroing the
  padding between them, and crops it back; the shifted blocks (every odd
  one) roll by (−s, −s) before attention and (+s, +s) after it, and their
  −100 mask is built from the padded size;
- window attention: q·k, scaled by dh^−0.5 after the product, plus the
  relative position bias (an 'ij' meshgrid index into `rel_bias`) and the
  shift mask, softmax in f32 cast back to the input's type, then ·v, in
  plain products (no fused attention: it rounds otherwise);
- the MLP's GELU is exact (erf);
- with `frozen_stages >= i + 1` the map is detached after stage i, before
  `out_norm{i}` and the patch merging; no parameter is frozen otherwise
  (the JAX trunk's frozen mask matches no Swin name);
- the patch merging crops an odd size to even and concatenates the 2x2
  neighbours dy-major, (0,0), (0,1), (1,0), (1,1), then `merge_norm{i}` and
  the bias-free `merge_reduce{i}`.

The norms are flax's `LayerNorm` (`layers/norm.py`); the convs and dense
layers compute at `dtype` (`layers/precision.py`), and the bias table and
the mask are cast to the attention's type. Inside the trunk maps are NHWC;
the stage outputs are returned as NCHW views of them, as the ResNet trunk
returns its maps. Module names mirror the flax tree (`stage0/block1` is
`stage0.block1`), so converted weights load by name.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers.norm import LayerNorm
from ..layers.precision import Conv2d, Linear


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws², ws²) indices into the (2ws−1)² relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij')).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive attention mask of the shifted windows: (nW, ws², ws²)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift),
                       slice(-shift, None)):
            img[hs, wslice] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return (win[:, :, None] != win[:, None, :]).astype(np.float32) * -100.0


# The index and mask tensors are cached per device and made outside
# inference mode, so that a model that serves first can train after.
@functools.lru_cache(maxsize=8)
def _rel_index_on(ws: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(_rel_pos_index(ws).reshape(-1), device=device)


@functools.lru_cache(maxsize=32)
def _shift_mask_on(h: int, w: int, ws: int, shift: int,
                   device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(_shift_mask(h, w, ws, shift), device=device)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window, with the relative
    position bias `rel_bias` ((2ws−1)², heads)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = Linear(dim, dim * 3, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)
        self.rel_bias = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x: (nW·B, T, C) window tokens; mask: (nW, T, T) or None."""
        n, t, _ = x.shape
        heads = self.num_heads
        dh = self.dim // heads
        q, k, v = (a.reshape(n, t, heads, dh).transpose(1, 2)
                   for a in self.qkv(x).split(self.dim, dim=-1))
        attn = (q @ k.transpose(-2, -1)) * (dh ** -0.5)
        idx = _rel_index_on(self.window_size, x.device)
        bias = self.rel_bias[idx].reshape(t, t, heads).permute(2, 0, 1)
        attn = attn + bias.to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(-1, nw, heads, t, t) + \
                mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(-1, heads, t, t)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(n, t, self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    """LayerNorm → (shifted) window attention → residual → LayerNorm →
    MLP (4x wide, exact GELU) → residual, on (B, H, W, C) maps whose H and
    W are multiples of the window."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        hidden = 4 * dim
        self.mlp_fc1 = Linear(dim, hidden, compute_dtype=dtype)
        self.mlp_fc2 = Linear(hidden, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, s = self.window_size, self.shift
        res = x
        x = self.norm1(x)
        mask = None
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = _shift_mask_on(h, w, ws, s, x.device)
        xw = x.reshape(b, h // ws, ws, w // ws, ws, c)
        xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        xw = self.attn(xw, mask)
        x = xw.reshape(b, h // ws, w // ws, ws, ws, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = res + x
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of flax's 'SAME' for size n, kernel k, stride
    s, as `lax.padtype_to_pads` splits it."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Swin-T by default (embed 96, depths 2/2/6/2, heads 3/6/12/24,
    window 7). `forward(x)` takes (B, 3, H, W) and returns the stage maps
    at `out_indices` (all four with `return_all_stages`), each (B, C_i,
    H_i, W_i) at strides 4/8/16/32 after its `out_norm{i}`."""

    def __init__(self, embed_dims: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims = embed_dims
        self.depths = tuple(depths)
        self.window_size = window_size
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.patch_embed = Conv2d(3, embed_dims, 4, stride=4,
                                  compute_dtype=dtype)
        self.patch_norm = LayerNorm(embed_dims, dtype=dtype)
        dim = embed_dims
        for i, depth in enumerate(self.depths):
            stage = nn.Module()
            for d in range(depth):
                stage.add_module(f'block{d}', SwinBlock(
                    dim, num_heads[i], window_size,
                    shift=0 if d % 2 == 0 else window_size // 2,
                    dtype=dtype))
            self.add_module(f'stage{i}', stage)
            self.add_module(f'out_norm{i}', LayerNorm(dim, dtype=dtype))
            if i < len(self.depths) - 1:
                self.add_module(f'merge_norm{i}',
                                LayerNorm(4 * dim, dtype=dtype))
                self.add_module(f'merge_reduce{i}', Linear(
                    4 * dim, 2 * dim, bias=False, compute_dtype=dtype))
                dim *= 2

    def stage_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dims * 2**i for i in range(len(self.depths)))

    def forward(self, x: torch.Tensor, return_all_stages: bool = False):
        ws = self.window_size
        ph, pw = (_same_pad(n, 4, 4) for n in x.shape[-2:])
        if any(ph + pw):
            x = F.pad(x, (*pw, *ph))
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for i, depth in enumerate(self.depths):
            b, hh, ww, dim = x.shape
            if hh % ws or ww % ws:
                x = F.pad(x, (0, 0, 0, (-ww) % ws, 0, (-hh) % ws))
            stage = getattr(self, f'stage{i}')
            for d in range(depth):
                x = getattr(stage, f'block{d}')(x)
            x = x[:, :hh, :ww]
            if self.frozen_stages >= i + 1:
                x = x.detach()
            outs.append(getattr(self, f'out_norm{i}')(x).permute(0, 3, 1, 2))
            if i < len(self.depths) - 1:
                h2, w2 = hh // 2 * 2, ww // 2 * 2
                xm = x[:, :h2, :w2].reshape(b, h2 // 2, 2, w2 // 2, 2, dim)
                xm = xm.permute(0, 1, 3, 2, 4, 5).reshape(
                    b, h2 // 2, w2 // 2, 4 * dim)
                x = getattr(self, f'merge_reduce{i}')(
                    getattr(self, f'merge_norm{i}')(xm))
        if return_all_stages:
            return tuple(outs)
        return tuple(outs[i] for i in self.out_indices)
