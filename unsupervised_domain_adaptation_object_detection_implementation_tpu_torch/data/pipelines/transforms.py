"""Data pipeline (counterpart of the JAX package's
`data/pipelines/transforms.py`: `LoadImageFromFile`, `LoadAnnotations`
with box-frame mask rasters, keep-ratio and multi-scale `Resize`,
`RandomFlip`, `RandomCrop`, `PhotoMetricDistortion`, `Normalize`, `Pad`,
`PackDetInputs`, `MultiScaleFlipAug`, `Compose`, `LoadProposals`).

Each transform is a callable on a `results` dict whose `img` is an (H, W, 3)
RGB torch tensor — uint8 until `Normalize`, float32 after — on the device
named by `results['device']` (the dataset's): the image is decoded on the
host (`jpeg.decode_jpeg`, no PIL or cv2), then moved to that device, where
every later step runs. Meta entries (`img_shape`, `scale_factor`, gt blocks and
the (n, M, M) uint8 mask rasters) are numpy arrays on the host, as in the
JAX package. Random draws (scale, flip, crop, photometric jitter) come
from `results['_rng']`, the dataset's `np.random.RandomState`, in the JAX
package's order.
"""

from __future__ import annotations

import math
import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.registry import PIPELINES
from .jpeg import decode_jpeg
from .polygon import rasterize_polygons


def _resize_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL-convention triangle-filter taps (support scales with the
    downscale factor, i.e. antialiased), as the JAX package's native resize
    builds them: (first source index (out,), float32 weights (out, kmax))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    kmax = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size)
    x = np.arange(kmax)
    v = np.abs((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
               / filterscale)
    k = np.where((v < 1.0) & (x[None, :] < (xmax - xmin)[:, None]),
                 1.0 - v, 0.0)
    total = np.zeros(out_size)
    for j in range(kmax):            # sequential, as the C++ sums
        total = total + k[:, j]
    safe = np.where(total > 0, total, 1.0)
    w = np.where(total[:, None] > 0, k / safe[:, None], 0.0)
    return xmin, w.astype(np.float32)


def _resize_pass(src: torch.Tensor, lo: np.ndarray, w: np.ndarray,
                 axis: int) -> torch.Tensor:
    """One separable pass along `axis` (0 = rows, 1 = columns) of a float32
    (H, W, C) tensor, accumulating taps in order in float32."""
    n_in = src.shape[axis]
    idx = np.minimum(lo[:, None] + np.arange(w.shape[1])[None, :], n_in - 1)
    idx_t = torch.as_tensor(idx, device=src.device)
    w_t = torch.as_tensor(w, device=src.device)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    acc = None
    for j in range(w.shape[1]):
        term = w_t[:, j].view(shape) * src.index_select(axis, idx_t[:, j])
        acc = term if acc is None else acc + term
    return acc


def imresize(img: torch.Tensor, size_wh: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (H, W, C) tensor to (w, h), as the JAX
    package's `_imresize` picks its path by the image's type.

    uint8: the antialiased PIL-convention filter of its native resize,
    horizontal pass into float32, vertical pass, rounded half up and
    clipped back to uint8. float (after `PhotoMetricDistortion`): cv2's
    `INTER_LINEAR`, a half-pixel bilinear with no antialias and edge
    replication, in float32 (within ~2e-4 of the 255 range of cv2's
    output: the two compute the taps' weights in another precision)."""
    tw, th = size_wh
    if img.is_floating_point():
        chw = img.float().permute(2, 0, 1)[None]
        out = torch.nn.functional.interpolate(
            chw, size=(th, tw), mode='bilinear', align_corners=False,
            antialias=False)
        return out[0].permute(1, 2, 0).contiguous()
    h, w = img.shape[:2]
    lo_x, w_x = _resize_taps(w, tw)
    lo_y, w_y = _resize_taps(h, th)
    tmp = _resize_pass(img.float(), lo_x, w_x, axis=1)
    out = _resize_pass(tmp, lo_y, w_y, axis=0)
    return torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)


@PIPELINES.register_module()
class LoadImageFromFile:
    """Read a JPEG file as an RGB uint8 tensor on `results['device']`
    (`jpeg.decode_jpeg`: libjpeg-turbo's output, bit for bit); another
    format raises. `to_float32` converts it to float32."""

    def __init__(self, to_float32: bool = False):
        self.to_float32 = to_float32

    def __call__(self, results):
        path = results['img_info']['filename']
        prefix = results.get('img_prefix')
        if prefix:
            path = osp.join(prefix, path)
        img = torch.from_numpy(decode_jpeg(path)).to(results['device'])
        if self.to_float32:
            img = img.float()
        results['filename'] = path
        results['img'] = img
        results['img_shape'] = tuple(img.shape[:2])
        results['ori_shape'] = tuple(img.shape[:2])
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    """The image's boxes (n, 4) float32 and labels (n,) int64 from
    `results['ann_info']`, and its ignored boxes where it has them.
    `with_mask=True` adds `gt_masks` (n, mask_size, mask_size) uint8: each
    instance's polygons drawn into its box's frame on the host
    (`polygon.rasterize_polygons`, Pillow's fill without PIL); an instance
    without polygons gets a zero raster."""

    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, mask_size: int = 112):
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask
        self.mask_size = mask_size

    def __call__(self, results):
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = \
                ann['bboxes'].astype(np.float32).reshape(-1, 4)
            if ann.get('bboxes_ignore') is not None:
                results['gt_bboxes_ignore'] = \
                    ann['bboxes_ignore'].astype(np.float32).reshape(-1, 4)
        if self.with_label:
            results['gt_labels'] = ann['labels'].astype(np.int64).reshape(-1)
        if self.with_mask:
            polys = ann.get('masks', [])
            boxes = results['gt_bboxes']
            m = self.mask_size
            rasters = np.zeros((len(boxes), m, m), np.uint8)
            for i, box in enumerate(boxes):
                if i < len(polys) and polys[i]:
                    rasters[i] = rasterize_polygons(polys[i], box, m)
            results['gt_masks'] = rasters
        return results


@PIPELINES.register_module()
class Resize:
    """Keep-ratio resize to fit inside `img_scale` = (long_edge,
    short_edge): scale = min(long / max_side, short / min_side).

    A list of scales picks one per image: `multiscale_mode='value'` (or
    more than two scales) draws one of them, `'range'` draws each edge
    uniformly between the two; `ratio_range=(lo, hi)` then jitters the
    scale. The draws come from `results['_rng']` in the JAX package's
    order."""

    def __init__(self, img_scale, keep_ratio: bool = True,
                 multiscale_mode: str = 'range', ratio_range=None):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range

    def _sample_scale(self, rng) -> Tuple[int, int]:
        sc = self.img_scale
        if isinstance(sc, (list, tuple)) and sc \
                and isinstance(sc[0], (list, tuple)):
            if self.multiscale_mode == 'value' or len(sc) != 2:
                sc = sc[int(rng.randint(len(sc)))]
            else:
                longs = sorted(max(s) for s in sc)
                shorts = sorted(min(s) for s in sc)
                sc = (int(rng.randint(longs[0], longs[1] + 1)),
                      int(rng.randint(shorts[0], shorts[1] + 1)))
        if self.ratio_range is not None:
            r = float(rng.uniform(*self.ratio_range))
            sc = (int(max(sc) * r), int(min(sc) * r))
        return tuple(sc)

    def __call__(self, results):
        h, w = results['img'].shape[:2]
        scale_hw = self._sample_scale(results.get('_rng', np.random))
        long_edge, short_edge = max(scale_hw), min(scale_hw)
        if self.keep_ratio:
            scale = min(long_edge / max(h, w), short_edge / min(h, w))
            new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
        else:
            new_w, new_h = scale_hw
        img = imresize(results['img'], (new_w, new_h))
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = img
        results['img_shape'] = tuple(img.shape[:2])
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        if 'gt_bboxes' in results:
            boxes = results['gt_bboxes'] * results['scale_factor']
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, new_w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, new_h)
            results['gt_bboxes'] = boxes
        return results


@PIPELINES.register_module()
class RandomFlip:
    """Horizontal flip with probability `flip_ratio` (one `rng.rand()` per
    image); a flipped box spans [w - x2, w - x1] of the resized width w,
    and its box-frame mask raster flips left to right with it."""

    def __init__(self, flip_ratio: float = 0.5):
        self.flip_ratio = flip_ratio

    def __call__(self, results):
        rng = results.get('_rng', np.random)
        flip = bool(rng.rand() < self.flip_ratio)
        results['flip'] = flip
        if flip:
            results['img'] = results['img'].flip(1)
            if 'gt_bboxes' in results:
                w = results['img_shape'][1]
                boxes = results['gt_bboxes'].copy()
                boxes[:, 0] = w - results['gt_bboxes'][:, 2]
                boxes[:, 2] = w - results['gt_bboxes'][:, 0]
                results['gt_bboxes'] = boxes
            if 'gt_masks' in results:
                results['gt_masks'] = results['gt_masks'][:, :, ::-1]
        return results


@PIPELINES.register_module()
class RandomCrop:
    """A random window of the image: `crop_size` (h, w) for 'absolute', or
    each side drawn from [crop_size[0], crop_size[1]] for
    'absolute_range' (`rng.randint`, h then w), each capped by the image;
    then the window's corner (y then x). The crop is a view of the image
    on its device. Boxes shift into the window and are clipped to it;
    boxes left empty are dropped with their labels and mask rasters (a
    raster lives in its box's frame and rides along unchanged, as in the
    JAX package). When no box survives and `allow_negative_crop` is False
    the image is left uncropped; with it, the image may keep no box."""

    def __init__(self, crop_size, crop_type: str = 'absolute',
                 allow_negative_crop: bool = False):
        if crop_type not in ('absolute', 'absolute_range'):
            raise NotImplementedError(
                f'RandomCrop(crop_type={crop_type!r}): only \'absolute\' and '
                f'\'absolute_range\' are ported, as in the JAX package')
        self.crop_size = crop_size
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop

    def __call__(self, results):
        rng = results.get('_rng', np.random)
        img = results['img']
        h, w = img.shape[:2]
        if self.crop_type == 'absolute_range':
            lo, hi = self.crop_size
            ch = min(rng.randint(lo, hi + 1), h)
            cw = min(rng.randint(lo, hi + 1), w)
        else:
            ch, cw = min(self.crop_size[0], h), min(self.crop_size[1], w)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        results['img'] = img[y0:y0 + ch, x0:x0 + cw]
        results['img_shape'] = (ch, cw)
        if 'gt_bboxes' in results:
            boxes = results['gt_bboxes'] - np.array([x0, y0, x0, y0],
                                                    np.float32)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            if not keep.any() and not self.allow_negative_crop:
                results['img'] = img
                results['img_shape'] = (h, w)
                return results
            results['gt_bboxes'] = boxes[keep]
            results['gt_labels'] = results['gt_labels'][keep]
            if 'gt_masks' in results:
                results['gt_masks'] = results['gt_masks'][keep]
        return results


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """The JAX package's numpy photometric jitter (not mmdet's HSV one):
    each with probability 1/2, brightness (+ U(−δ, δ)), contrast
    (× U(contrast_range)) and a saturation mix about the channel mean
    (gray + (img − gray) · U(saturation_range)), then one clip to [0, 255];
    the image becomes float32. The draws come from `results['_rng']` in
    the JAX order: for each step a `randint(2)`, then its `uniform` when it
    applies. `hue_delta` is accepted and unused, as there."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results):
        rng = results.get('_rng', np.random)
        img = results['img'].float()
        if rng.randint(2):
            img = img + float(np.float32(rng.uniform(
                -self.brightness_delta, self.brightness_delta)))
        if rng.randint(2):
            img = img * float(np.float32(rng.uniform(*self.contrast_range)))
        if rng.randint(2):
            gray = img.mean(dim=2, keepdim=True)
            alpha = float(np.float32(rng.uniform(*self.saturation_range)))
            img = gray + (img - gray) * alpha
        results['img'] = img.clamp(0, 255)
        return results


@PIPELINES.register_module()
class Normalize:
    """(img - mean) / std in float32, ImageNet RGB statistics by default.
    Images are RGB already; `to_rgb` is accepted for config compatibility."""

    def __init__(self, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375), to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results['img'].float()
        mean = torch.as_tensor(self.mean, device=img.device)
        std = torch.as_tensor(self.std, device=img.device)
        results['img'] = (img - mean) / std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std)
        return results


@PIPELINES.register_module()
class Pad:
    """Pad bottom/right to a fixed `size` (h, w) or to a multiple of
    `size_divisor`; an image larger than `size` raises."""

    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None, pad_val: float = 0.0):
        if (size is None) == (size_divisor is None):
            raise ValueError('give exactly one of size and size_divisor')
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results['img']
        h, w = img.shape[:2]
        if self.size_divisor:
            th = int(np.ceil(h / self.size_divisor)) * self.size_divisor
            tw = int(np.ceil(w / self.size_divisor)) * self.size_divisor
        else:
            th, tw = self.size
            if h > th or w > tw:
                raise ValueError(
                    f'Pad: resized image ({h}, {w}) exceeds the fixed canvas '
                    f'({th}, {tw}); it would be silently cropped. Enlarge '
                    f'`Pad.size` or tighten the Resize scale.')
        padded = img.new_full((th, tw) + tuple(img.shape[2:]), self.pad_val)
        padded[:h, :w] = img
        results['img'] = padded
        results['pad_shape'] = (th, tw)
        return results


@PIPELINES.register_module()
class PackDetInputs:
    """Terminal stage: the image plus fixed-size meta and gt blocks
    (gts padded to `max_gt` with a validity mask). `with_mask` adds
    `gt_masks` (max_gt, M, M) uint8, each gt's box-frame raster (M from
    the results' `gt_masks`, 112 without any), zero-padded. The full-image
    rasters and semantic maps of the JAX package (`with_full_masks`,
    `with_semantic`, for SOLO and panoptic heads) are not ported and
    raise."""

    def __init__(self, max_gt: int = 100, with_mask: bool = False,
                 with_full_masks: bool = False, full_mask_stride: int = 4,
                 with_semantic: bool = False, num_stuff: int = 1):
        if with_full_masks or with_semantic:
            raise NotImplementedError(
                'PackDetInputs(with_full_masks / with_semantic): full-image '
                'rasters and semantic maps feed the SOLO and panoptic heads, '
                'which are not ported')
        self.max_gt = max_gt
        self.with_mask = with_mask

    def __call__(self, results):
        n = min(len(results.get('gt_labels', [])), self.max_gt)
        gt_bboxes = np.zeros((self.max_gt, 4), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_valid = np.zeros((self.max_gt,), bool)
        if n:
            gt_bboxes[:n] = results['gt_bboxes'][:n]
            gt_labels[:n] = results['gt_labels'][:n]
            gt_valid[:n] = True
        extra = {}
        if self.with_mask:
            m = results.get('gt_masks')
            msize = m.shape[-1] if m is not None and m.size else 112
            packed = np.zeros((self.max_gt, msize, msize), np.uint8)
            if m is not None and n:
                packed[:n] = m[:n]
            extra['gt_masks'] = packed
        return dict(
            image=results['img'].float(),
            img_shape=np.asarray(results['img_shape'], np.int32),
            ori_shape=np.asarray(results['ori_shape'], np.int32),
            scale_factor=results.get(
                'scale_factor', np.ones((4,), np.float32)),
            flip=np.asarray(results.get('flip', False)),
            gt_bboxes=gt_bboxes,
            gt_labels=gt_labels,
            gt_valid=gt_valid,
            domain=np.asarray(results.get('domain', 0), np.int32),
            **extra,
        )


@PIPELINES.register_module()
class LoadProposals:
    """Precomputed proposals (`results['proposals']`, (n, 4) or (n, 5) with
    a score column, from the dataset, e.g. a saved RPN run) padded or cut
    to `num_max_proposals` rows, with `proposals_valid`; host numpy, as the
    gt blocks. `PackDetInputs` does not carry them, as in the JAX package,
    so a Fast R-CNN config's first step raises."""

    def __init__(self, num_max_proposals: int = 1000):
        self.num_max = num_max_proposals

    def __call__(self, results):
        props = np.asarray(results.get('proposals',
                                       np.zeros((0, 4), np.float32)),
                           np.float32)
        if props.shape[-1] == 5:
            props = props[:, :4]
        n = min(len(props), self.num_max)
        out = np.zeros((self.num_max, 4), np.float32)
        out[:n] = props[:n]
        results['proposals'] = out
        results['proposals_valid'] = np.arange(self.num_max) < n
        return results


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """The test-time wrapper at a single scale without flip, i.e. its inner
    pipeline; multi-scale or flip test-time augmentation raises, as in the
    JAX package."""

    def __init__(self, transforms, img_scale=None, flip=False,
                 scale_factor=None):
        if flip or (isinstance(img_scale, list) and len(img_scale) > 1):
            raise NotImplementedError(
                'MultiScaleFlipAug: multi-scale or flip test-time '
                'augmentation is not ported; use one scale and flip=False')
        self.inner = Compose(transforms)

    def __call__(self, results):
        return self.inner(results)


@PIPELINES.register_module()
class Compose:
    """Chain of transforms (callables or registry dicts)."""

    def __init__(self, transforms: Sequence):
        self.transforms = [
            t if callable(t) else PIPELINES.build(t) for t in transforms
        ]

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results
