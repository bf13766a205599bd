"""RoIAlign, single-level and multi-level (FPN): the plain torch versions
and the CUDA kernels' wrappers (counterpart of the JAX package's
`ops/roi_align.py`).

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
- :func:`batched_roi_align` is the single-level entry point and
  :func:`batched_roi_align_fpn` the multi-level one: each RoI is pooled
  from the level `roi_levels` gives it. CPU tensors take the plain
  versions (:func:`batched_roi_align_fpn_plain` is the JAX package's
  masked separable form) and their autograd. CUDA tensors launch one
  hand-written kernel pair for both paths (`csrc/roi_align_pyramid.cu`;
  the single-level path is its one-level case) or raise: the forward
  `roi_align_pyramid_fwd`, counted in `roi_align_pyramid_cuda.launches`,
  and, when a map needs a gradient, the backward `roi_align_pyramid_bwd`
  through :class:`RoIAlignPyramidFunction`, counted in
  `roi_align_pyramid_bwd_cuda.launches`. rois get no gradient, as in the
  JAX package.

`flatten=True` returns (B, R, o*o*C) in x-major (xbin, ybin, C) order, the
order the Shared2FC head's first layer expects (the JAX package chose it
for its TPU layout; the port keeps it so weights carry over unpermuted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_build


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. PyTorch's CUDA division by
    a Python number multiplies by the number's rounded reciprocal, one bit
    off the quotient; that would move sample positions off the kernels'
    `__fdiv_rn` ones by an ulp (1.5e-5 px at 256 px), and the output by
    ~1e-5 of its scale."""
    return x / x.new_full((), d)


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
    samples = _div(torch.arange(sr, dtype=lo.dtype, device=lo.device) + 0.5,
                   sr)
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
    return _div(w.sum(dim=2), sr)                            # (R, out, L)


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
    wx = _axis_weights(x1, _div(roi_w, out_size), out_size, sampling_ratio, w)
    wy = _axis_weights(y1, _div(roi_h, out_size), out_size, sampling_ratio, h)
    return wx, wy


def batched_roi_align_plain(feats: torch.Tensor, rois: torch.Tensor,
                            spatial_scale: float, out_size: int = 7,
                            sampling_ratio: int = 2, aligned: bool = True,
                            flatten: bool = False, roi_chunk: int = 128,
                            roi_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(B,H,W,C) x (B,R,4) → (B,R,o,o,C), or (B,R,o·o·C) x-major.

    The JAX package's separable form: x-interpolation first into a
    (chunk, H, o, C) intermediate, then y-interpolation, f32 accumulation,
    the intermediate and result stored in the feature dtype (so a bf16 run
    rounds where the JAX one does). RoIs go in chunks of `roi_chunk` to
    bound the intermediate. `roi_mask` (B, R), where given, multiplies each
    RoI's x weights (0 gives an exact zero output), as the JAX package's FPN
    form folds in its level one-hot.
    """
    b, h, w, c = feats.shape
    n = rois.shape[1]
    dt = feats.dtype
    outs = []
    for bi in range(b):
        wx, wy = _roi_weights(rois[bi].float(), spatial_scale, out_size,
                              sampling_ratio, aligned, h, w)
        if roi_mask is not None:
            wx = wx * roi_mask[bi].to(wx.dtype)[:, None, None]
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


def roi_levels(rois: torch.Tensor, num_levels: int,
               finest_scale: int = 56) -> torch.Tensor:
    """The FPN level of each RoI (B, R, 4) → (B, R) int32: clamp(floor(
    log2(sqrt(area) / finest_scale + 1e-6)), 0, num_levels - 1), in f32 as
    the JAX package computes it."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0]).clamp(min=0) *
                       (rois[..., 3] - rois[..., 1]).clamp(min=0))
    lvl = torch.floor(torch.log2(_div(scale, finest_scale) + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def batched_roi_align_fpn_plain(feats: Sequence[torch.Tensor],
                                rois: torch.Tensor,
                                strides: Sequence[int] = (4, 8, 16, 32),
                                out_size: int = 7, sampling_ratio: int = 2,
                                aligned: bool = True, finest_scale: int = 56,
                                flatten: bool = False, roi_chunk: int = 128
                                ) -> torch.Tensor:
    """Multi-level RoIAlign, the JAX package's separable form: every level
    runs for every RoI with the one-hot of the RoI's level (`roi_levels`)
    folded into its x weights, and the levels' outputs are summed (the
    off-level terms are exact zeros). feats: one (B, H_l, W_l, C) map per
    stride (more are ignored)."""
    lvl = roi_levels(rois, len(strides), finest_scale)
    total = None
    for i, s in enumerate(strides):
        out = batched_roi_align_plain(feats[i], rois, 1.0 / s, out_size,
                                      sampling_ratio, aligned, flatten,
                                      roi_chunk, roi_mask=lvl == i)
        total = out if total is None else total + out
    return total


# ---- the CUDA kernels (csrc/roi_align_pyramid.cu) --------------------------

_MAX_LEVELS = 4       # kMaxLevels of csrc/roi_align_pyramid.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}


@functools.lru_cache(maxsize=None)
def _pyramid_lib() -> ctypes.CDLL:
    lib = cuda_build.load('roi_align_pyramid.cu')
    for fn in (lib.roi_align_pyramid_fwd, lib.roi_align_pyramid_bwd):
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       *[ctypes.c_int] * 9, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_args(x: torch.Tensor, shapes, rois: torch.Tensor,
                levels: Optional[torch.Tensor], scales, out_size: int,
                sampling_ratio: int) -> None:
    """Raise on anything the kernels do not take: `x` is the forward's first
    level or the backward's output gradient, `shapes` the levels' (B, H, W,
    C), `levels` None for one level."""
    b, c = shapes[0][0], shapes[0][3]
    if x.device.type != 'cuda' or rois.device != x.device:
        raise ValueError(f'tensors must be on one CUDA device, got '
                         f'{x.device} and rois on {rois.device}')
    if rois.dim() != 3 or rois.shape[-1] != 4 or rois.shape[0] != b:
        raise ValueError(f'expected rois ({b},R,4), got {tuple(rois.shape)}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'dtype {x.dtype} not supported (float32, bfloat16)')
    if rois.dtype != torch.float32:
        raise TypeError(f'rois must be float32, got {rois.dtype}')
    if not (x.is_contiguous() and rois.is_contiguous()):
        raise ValueError('tensors must be contiguous (NHWC feats)')
    if out_size * sampling_ratio > 64 or out_size < 1 or sampling_ratio < 1:
        raise ValueError(f'out_size {out_size} x sampling_ratio '
                         f'{sampling_ratio} outside the kernel (<= 64)')
    if not 1 <= len(shapes) <= _MAX_LEVELS or len(scales) != len(shapes):
        raise ValueError(f'{len(shapes)} levels for {len(scales)} strides '
                         f'(1..{_MAX_LEVELS} levels)')
    for s in shapes:
        if len(s) != 4 or s[0] != b or s[3] != c or min(s) < 1:
            raise ValueError(f'level shapes {shapes} are not (B, H_l, W_l, '
                             'C) with one B and C')
    if levels is None:
        if len(shapes) > 1:
            raise ValueError('levels are needed for more than one level')
    elif levels.dtype != torch.int32 or levels.device != x.device or \
            tuple(levels.shape) != tuple(rois.shape[:2]) or \
            not levels.is_contiguous():
        raise ValueError(f'levels must be contiguous int32 '
                         f'{tuple(rois.shape[:2])} on {x.device}, got '
                         f'{levels.dtype} {tuple(levels.shape)} on '
                         f'{levels.device}')


def _launch(fn, name, ptrs, shapes, scales, rois, levels, out_ptr, n,
            out_size, sampling_ratio, aligned, flatten, dtype, vec, device):
    k = len(shapes)
    with torch.cuda.device(device):
        err = fn((ctypes.c_void_p * k)(*ptrs),
                 (ctypes.c_int * k)(*[s[1] for s in shapes]),
                 (ctypes.c_int * k)(*[s[2] for s in shapes]),
                 (ctypes.c_float * k)(*scales), k, rois.data_ptr(),
                 None if levels is None else levels.data_ptr(), out_ptr,
                 shapes[0][0], shapes[0][3], n, out_size, sampling_ratio,
                 int(aligned), int(flatten), _DTYPE_CODES[dtype], vec,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')


def _out_shape(b, n, c, out_size, flatten):
    return (b, n, out_size * out_size * c) if flatten else \
        (b, n, out_size, out_size, c)


def roi_align_pyramid_cuda(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                           levels: Optional[torch.Tensor],
                           scales: Sequence[float], out_size: int = 7,
                           sampling_ratio: int = 2, aligned: bool = True,
                           flatten: bool = False) -> torch.Tensor:
    """Launch the forward kernel `roi_align_pyramid_fwd`: each RoI (B, R, 4)
    samples the level `levels` (B, R) int32 gives it (None: the one level)
    from one (B, H_l, W_l, C) map per spatial scale, f32 or bf16 → (B, R,
    o, o, C), or (B, R, o·o·C) x-major. One launch for all levels, counted
    in `roi_align_pyramid_cuda.launches`; raises on anything the kernel
    does not take. Records no gradient."""
    feats = tuple(feats)
    if any(f.dim() != 4 for f in feats):
        raise ValueError('expected feats (B,H,W,C) per level')
    shapes = [tuple(f.shape) for f in feats]
    _check_args(feats[0], shapes, rois, levels, scales, out_size,
                sampling_ratio)
    for f in feats[1:]:
        if f.device != feats[0].device or f.dtype != feats[0].dtype or \
                not f.is_contiguous():
            raise ValueError('levels must share one CUDA device and dtype '
                             'and be contiguous')
    b, c, n = shapes[0][0], shapes[0][3], rois.shape[1]
    dt = feats[0].dtype
    out = torch.empty(_out_shape(b, n, c, out_size, flatten), dtype=dt,
                      device=rois.device)
    if b * n == 0:
        return out
    vec = _VEC[dt]
    if c % vec or any(t.data_ptr() % 16 for t in (*feats, out)):
        vec = 1
    _launch(_pyramid_lib().roi_align_pyramid_fwd, 'roi_align_pyramid_fwd',
            [f.data_ptr() for f in feats], shapes, scales, rois, levels,
            out.data_ptr(), n, out_size, sampling_ratio, aligned, flatten,
            dt, vec, rois.device)
    roi_align_pyramid_cuda.launches += 1
    return out


roi_align_pyramid_cuda.launches = 0


def roi_align_pyramid_bwd_cuda(grad: torch.Tensor, rois: torch.Tensor,
                               levels: Optional[torch.Tensor],
                               shapes: Sequence[Tuple[int, int, int, int]],
                               scales: Sequence[float], out_size: int = 7,
                               sampling_ratio: int = 2, aligned: bool = True,
                               flatten: bool = False
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel `roi_align_pyramid_bwd`: the gradient with
    respect to each level's (B, H_l, W_l, C) map of the forward's output
    gradient `grad` (either layout, f32 or bf16). Each RoI adds only into
    its own level. Sums in one f32 buffer (zeroed here, one view per level)
    and returns the levels in `grad`'s dtype; the launch is counted in
    `roi_align_pyramid_bwd_cuda.launches`."""
    shapes = [tuple(s) for s in shapes]
    _check_args(grad, shapes, rois, levels, scales, out_size, sampling_ratio)
    b, c, n = shapes[0][0], shapes[0][3], rois.shape[1]
    shape = _out_shape(b, n, c, out_size, flatten)
    if tuple(grad.shape) != shape:
        raise ValueError(f'grad shape {tuple(grad.shape)}, expected {shape}')
    sizes = [b * h * w * c for _, h, w, _ in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=grad.device)
    grads = [v.view(s) for v, s in zip(flat.split(sizes), shapes)]
    if b * n:
        vec = _VEC[grad.dtype]
        if c % vec or any(t.data_ptr() % 16 for t in (grad, *grads)):
            vec = 1
        _launch(_pyramid_lib().roi_align_pyramid_bwd,
                'roi_align_pyramid_bwd', [g.data_ptr() for g in grads],
                shapes, scales, rois, levels, grad.data_ptr(), n, out_size,
                sampling_ratio, aligned, flatten, grad.dtype, vec,
                grad.device)
        roi_align_pyramid_bwd_cuda.launches += 1
    if grad.dtype == torch.float32:
        return tuple(grads)
    return tuple(g.to(grad.dtype) for g in grads)


roi_align_pyramid_bwd_cuda.launches = 0


class RoIAlignPyramidFunction(torch.autograd.Function):
    """RoIAlign on CUDA with a gradient, for one level or several: the
    forward launches `roi_align_pyramid_fwd`, the backward
    `roi_align_pyramid_bwd`; rois and levels get no gradient. `args` =
    (scales, out_size, sampling_ratio, aligned, flatten); the levels' maps
    follow it."""

    @staticmethod
    def forward(ctx, rois, levels, args, *feats):
        ctx.save_for_backward(rois, levels)
        ctx.shapes = [tuple(f.shape) for f in feats]
        ctx.args = args
        return roi_align_pyramid_cuda(feats, rois, levels, *args)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        grads = (None,) * len(ctx.shapes)
        if any(ctx.needs_input_grad[3:]):
            grads = roi_align_pyramid_bwd_cuda(grad.contiguous(), rois,
                                               levels, ctx.shapes, *ctx.args)
        return (None, None, None, *grads)


def _on_card(feats, rois, levels, scales, out_size, sampling_ratio, aligned,
             flatten):
    args = (tuple(float(s) for s in scales), out_size, sampling_ratio,
            aligned, flatten)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        return RoIAlignPyramidFunction.apply(rois, levels, args, *feats)
    return roi_align_pyramid_cuda(feats, rois, levels, *args)


def batched_roi_align(feats: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float, out_size: int = 7,
                      sampling_ratio: int = 2, aligned: bool = True,
                      flatten: bool = False) -> torch.Tensor:
    """Batched RoIAlign: (B,H,W,C) x (B,R,4) → (B,R,o,o,C), or (B,R,o·o·C)
    in x-major order with `flatten=True`.

    CPU tensors take the plain version (and its autograd). CUDA tensors
    launch the kernel pair at one level, with no level array, or raise:
    the forward `roi_align_pyramid_fwd` and, when feats need a gradient,
    through :class:`RoIAlignPyramidFunction`, the backward
    `roi_align_pyramid_bwd`.
    """
    rois = rois.detach()
    if feats.device.type == 'cpu':
        return batched_roi_align_plain(feats, rois, spatial_scale, out_size,
                                       sampling_ratio, aligned, flatten)
    if feats.device.type == 'cuda':
        return _on_card((feats,), rois, None, (spatial_scale,), out_size,
                        sampling_ratio, aligned, flatten)
    raise ValueError(f'no RoIAlign for device {feats.device}')


def batched_roi_align_fpn(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                          strides: Sequence[int] = (4, 8, 16, 32),
                          out_size: int = 7, sampling_ratio: int = 2,
                          aligned: bool = True, finest_scale: int = 56,
                          flatten: bool = False) -> torch.Tensor:
    """Multi-level (FPN) RoIAlign: each RoI (B, R, 4) is pooled from the
    level `roi_levels` gives it, among one (B, H_l, W_l, C) map per stride
    (a neck's further levels are ignored and get no gradient) → (B, R, o,
    o, C), or (B, R, o·o·C) x-major with `flatten=True`.

    CPU tensors take the plain version (and its autograd). CUDA tensors
    launch the kernel pair, one launch for all levels, with the levels
    computed here in torch, or raise.
    """
    feats = tuple(feats)
    if len(feats) < len(strides):
        raise ValueError(f'{len(feats)} feature maps for {len(strides)} '
                         'strides')
    feats = feats[:len(strides)]
    rois = rois.detach()
    device = feats[0].device
    if device.type == 'cpu':
        return batched_roi_align_fpn_plain(feats, rois, strides, out_size,
                                           sampling_ratio, aligned,
                                           finest_scale, flatten)
    if device.type == 'cuda':
        levels = roi_levels(rois, len(strides), finest_scale).contiguous()
        return _on_card(feats, rois, levels, [1.0 / s for s in strides],
                        out_size, sampling_ratio, aligned, flatten)
    raise ValueError(f'no RoIAlign for device {device}')
