"""Single-level RoIAlign: the plain torch version and the CUDA kernel's
wrapper (counterpart of the JAX package's `ops/roi_align.py`).

What it computes (both versions): for each RoI and each of the o x o bins,
the mean of sr x sr bilinear samples of the feature map, with the
half-pixel offset when `aligned`, and mmcv's rule for samples — a sample
below -1 or above the axis length contributes zero, the rest clamp inward.
`sampling_ratio` is fixed (2 by default) where mmcv adapts it, as in the
JAX package.

- :func:`batched_roi_align_plain` is the JAX package's separable form
  written in torch: per-RoI axis weight matrices (R, o, W) and (R, o, H),
  then two products. It is what the CPU runs, and the yardstick the kernel
  is held against on the card.
- :func:`batched_roi_align` is the entry point. For tensors on the CPU it
  runs the plain version, whose autograd is the plain backward. For CUDA
  tensors it launches the hand-written kernels of `csrc/roi_align.cu` (or
  raises): the forward `roi_align_fwd`, counted in
  `batched_roi_align.launches`, and, when feats need a gradient, the
  backward `roi_align_bwd` through :class:`RoIAlignFunction`, counted in
  `roi_align_bwd_cuda.launches`. rois get no gradient, as in the JAX
  package.

`flatten=True` returns (B, R, o*o*C) in x-major (xbin, ybin, C) order, the
order the Shared2FC head's first layer expects (the JAX package chose it
for its TPU layout; the port keeps it so weights carry over unpermuted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import cuda_build


def _axis_weights(lo: torch.Tensor, bin_size: torch.Tensor, out_size: int,
                  sampling_ratio: int, axis_len: int) -> torch.Tensor:
    """Averaged bilinear weight matrix for one axis.

    Args:
        lo: (R,) start coordinate of each roi on this axis (feature units).
        bin_size: (R,) per-roi bin extent.

    Returns:
        (R, out_size, axis_len) weights.
    """
    sr = sampling_ratio
    bins = torch.arange(out_size, dtype=lo.dtype, device=lo.device)
    samples = (torch.arange(sr, dtype=lo.dtype, device=lo.device) + 0.5) / sr
    pos = lo[:, None, None] + \
        (bins[None, :, None] + samples[None, None, :]) * bin_size[:, None, None]
    valid = (pos >= -1.0) & (pos <= axis_len)
    pos_c = pos.clamp(0.0, axis_len - 1.0)
    x0 = torch.floor(pos_c)
    frac = pos_c - x0
    x0i = x0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=axis_len - 1)
    grid = torch.arange(axis_len, device=lo.device)
    zero = frac.new_zeros(())
    w0 = torch.where(valid, 1.0 - frac, zero)
    w1 = torch.where(valid, frac, zero)
    onehot0 = (grid == x0i[..., None]).to(lo.dtype)
    onehot1 = (grid == x1i[..., None]).to(lo.dtype)
    w = w0[..., None] * onehot0 + w1[..., None] * onehot1
    return w.sum(dim=2) / sr                                 # (R, out, L)


def _roi_weights(rois: torch.Tensor, spatial_scale: float, out_size: int,
                 sampling_ratio: int, aligned: bool, h: int, w: int):
    """Per-roi separable weights: (R, o, W) and (R, o, H)."""
    offset = 0.5 if aligned else 0.0
    scaled = rois * spatial_scale
    x1 = scaled[:, 0] - offset
    y1 = scaled[:, 1] - offset
    roi_w = scaled[:, 2] - scaled[:, 0]
    roi_h = scaled[:, 3] - scaled[:, 1]
    if not aligned:  # legacy: clamp to min size 1
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    wx = _axis_weights(x1, roi_w / out_size, out_size, sampling_ratio, w)
    wy = _axis_weights(y1, roi_h / out_size, out_size, sampling_ratio, h)
    return wx, wy


def batched_roi_align_plain(feats: torch.Tensor, rois: torch.Tensor,
                            spatial_scale: float, out_size: int = 7,
                            sampling_ratio: int = 2, aligned: bool = True,
                            flatten: bool = False,
                            roi_chunk: int = 128) -> torch.Tensor:
    """(B,H,W,C) x (B,R,4) → (B,R,o,o,C), or (B,R,o·o·C) x-major.

    The JAX package's separable form: x-interpolation first into a
    (chunk, H, o, C) intermediate, then y-interpolation, f32 accumulation,
    the intermediate and result stored in the feature dtype (so a bf16 run
    rounds where the JAX one does). RoIs go in chunks of `roi_chunk` to
    bound the intermediate.
    """
    b, h, w, c = feats.shape
    n = rois.shape[1]
    dt = feats.dtype
    outs = []
    for bi in range(b):
        wx, wy = _roi_weights(rois[bi].float(), spatial_scale, out_size,
                              sampling_ratio, aligned, h, w)
        f = feats[bi].float()
        for lo in range(0, n, roi_chunk):
            wx_c = wx[lo:lo + roi_chunk].to(dt).float()
            wy_c = wy[lo:lo + roi_chunk].to(dt).float()
            t = torch.einsum('row,hwc->rhoc', wx_c, f).to(dt).float()
            out = torch.einsum('roh,rhpc->ropc', wy_c, t).to(dt)
            outs.append(out)
    out = torch.cat(outs, 0).reshape(b, n, out_size, out_size, c) if n else \
        feats.new_zeros((b, 0, out_size, out_size, c))
    if flatten:
        return out.transpose(2, 3).reshape(b, n, out_size * out_size * c)
    return out


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load('roi_align.cu')
    for fn in (lib.roi_align_fwd, lib.roi_align_bwd):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_args(x: torch.Tensor, rois: torch.Tensor, batch: int,
                       out_size: int, sampling_ratio: int) -> None:
    """Raise on anything the kernels of `csrc/roi_align.cu` do not take; `x`
    is the forward's feats or the backward's output gradient."""
    if x.device.type != 'cuda' or rois.device != x.device:
        raise ValueError(f'tensors must be on one CUDA device, got '
                         f'{x.device} and rois on {rois.device}')
    if rois.dim() != 3 or rois.shape[-1] != 4 or rois.shape[0] != batch:
        raise ValueError(f'expected rois ({batch},R,4), got '
                         f'{tuple(rois.shape)}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'dtype {x.dtype} not supported (float32, bfloat16)')
    if rois.dtype != torch.float32:
        raise TypeError(f'rois must be float32, got {rois.dtype}')
    if not (x.is_contiguous() and rois.is_contiguous()):
        raise ValueError('tensors must be contiguous (NHWC feats)')
    if out_size * sampling_ratio > 64 or out_size < 1 or sampling_ratio < 1:
        raise ValueError(f'out_size {out_size} x sampling_ratio '
                         f'{sampling_ratio} outside the kernel (<= 64)')


def roi_align_cuda(feats: torch.Tensor, rois: torch.Tensor,
                   spatial_scale: float, out_size: int = 7,
                   sampling_ratio: int = 2, aligned: bool = True,
                   flatten: bool = False) -> torch.Tensor:
    """Launch the forward kernel `roi_align_fwd` on CUDA tensors; raise on
    anything it does not take. Records no gradient."""
    if feats.dim() != 4:
        raise ValueError(f'expected feats (B,H,W,C), got '
                         f'{tuple(feats.shape)}')
    _check_kernel_args(feats, rois, feats.shape[0], out_size, sampling_ratio)
    b, h, w, c = feats.shape
    n = rois.shape[1]
    shape = (b, n, out_size * out_size * c) if flatten else \
        (b, n, out_size, out_size, c)
    out = torch.empty(shape, dtype=feats.dtype, device=feats.device)
    if b * n == 0:
        return out
    vec = _VEC[feats.dtype]
    if c % vec or feats.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    lib = _kernel_lib()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.roi_align_fwd(
            feats.data_ptr(), rois.data_ptr(), out.data_ptr(), b, h, w, c, n,
            float(spatial_scale), out_size, sampling_ratio, int(aligned),
            int(flatten), _DTYPE_CODES[feats.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f'roi_align_fwd launch failed: cudaError {err}')
    batched_roi_align.launches += 1
    return out


def roi_align_bwd_cuda(grad: torch.Tensor, rois: torch.Tensor,
                       feats_shape: Tuple[int, int, int, int],
                       spatial_scale: float, out_size: int = 7,
                       sampling_ratio: int = 2, aligned: bool = True,
                       flatten: bool = False) -> torch.Tensor:
    """Launch the backward kernel `roi_align_bwd`: the gradient (B, H, W, C)
    with respect to feats of the forward's output gradient `grad`, either
    (B, R, o, o, C) or flat (B, R, o·o·C) x-major, f32 or bf16. Sums in an
    f32 buffer (zeroed here) and returns it in `grad`'s dtype."""
    b, h, w, c = feats_shape
    _check_kernel_args(grad, rois, b, out_size, sampling_ratio)
    n = rois.shape[1]
    shape = (b, n, out_size * out_size * c) if flatten else \
        (b, n, out_size, out_size, c)
    if tuple(grad.shape) != shape:
        raise ValueError(f'grad shape {tuple(grad.shape)}, expected {shape}')
    grad_feats = torch.zeros((b, h, w, c), dtype=torch.float32,
                             device=grad.device)
    if b * n == 0:
        return grad_feats.to(grad.dtype)
    vec = _VEC[grad.dtype]
    if c % vec or grad.data_ptr() % 16:
        vec = 1
    lib = _kernel_lib()
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = lib.roi_align_bwd(
            grad.data_ptr(), rois.data_ptr(), grad_feats.data_ptr(), b, h, w,
            c, n, float(spatial_scale), out_size, sampling_ratio,
            int(aligned), int(flatten), _DTYPE_CODES[grad.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f'roi_align_bwd launch failed: cudaError {err}')
    roi_align_bwd_cuda.launches += 1
    return grad_feats if grad.dtype == torch.float32 else \
        grad_feats.to(grad.dtype)


roi_align_bwd_cuda.launches = 0


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign on CUDA with a gradient: the forward launches `roi_align_fwd`
    and the backward `roi_align_bwd`; rois get no gradient."""

    @staticmethod
    def forward(ctx, feats, rois, spatial_scale, out_size, sampling_ratio,
                aligned, flatten):
        ctx.save_for_backward(rois)
        ctx.feats_shape = tuple(feats.shape)
        ctx.args = (spatial_scale, out_size, sampling_ratio, aligned, flatten)
        return roi_align_cuda(feats, rois, spatial_scale, out_size,
                              sampling_ratio, aligned, flatten)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        grad_feats = None
        if ctx.needs_input_grad[0]:
            grad_feats = roi_align_bwd_cuda(grad.contiguous(), rois,
                                            ctx.feats_shape, *ctx.args)
        return grad_feats, None, None, None, None, None, None


def batched_roi_align(feats: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float, out_size: int = 7,
                      sampling_ratio: int = 2, aligned: bool = True,
                      flatten: bool = False) -> torch.Tensor:
    """Batched RoIAlign: (B,H,W,C) x (B,R,4) → (B,R,o,o,C), or (B,R,o·o·C)
    in x-major order with `flatten=True`.

    CPU tensors take the plain version (and its autograd). CUDA tensors
    launch the forward kernel (counted in `batched_roi_align.launches`) or
    raise; when grad is recorded and feats require it, through
    :class:`RoIAlignFunction`, whose backward launches `roi_align_bwd`.
    """
    rois = rois.detach()
    if feats.device.type == 'cpu':
        return batched_roi_align_plain(feats, rois, spatial_scale, out_size,
                                       sampling_ratio, aligned, flatten)
    if feats.device.type == 'cuda':
        if torch.is_grad_enabled() and feats.requires_grad:
            return RoIAlignFunction.apply(feats, rois, spatial_scale,
                                          out_size, sampling_ratio, aligned,
                                          flatten)
        return roi_align_cuda(feats, rois, spatial_scale, out_size,
                              sampling_ratio, aligned, flatten)
    raise ValueError(f'no RoIAlign for device {feats.device}')


batched_roi_align.launches = 0
