"""Test-time data pipeline (counterpart of the JAX package's
`data/pipelines/transforms.py`: `LoadImageFromFile`, keep-ratio `Resize`,
`Normalize`, `Pad`, `PackDetInputs`, `Compose`).

Each transform is a callable on a `results` dict whose `img` is an (H, W, 3)
RGB torch tensor — uint8 until `Normalize`, float32 after — on whatever
device the caller put it. On a card the whole chain runs there. Meta entries
(`img_shape`, `scale_factor`, gt blocks) are small numpy arrays, as in the
JAX package. Training-time transforms (flip, crops, photometric jitter,
multi-scale resize) come with the dataset and loader.
"""

from __future__ import annotations

import math
import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.registry import PIPELINES


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
    """Antialiased bilinear resize of an (H, W, C) uint8 tensor to (w, h):
    horizontal pass into float32, vertical pass, round half up, clip."""
    tw, th = size_wh
    h, w = img.shape[:2]
    lo_x, w_x = _resize_taps(w, tw)
    lo_y, w_y = _resize_taps(h, th)
    tmp = _resize_pass(img.float(), lo_x, w_x, axis=1)
    out = _resize_pass(tmp, lo_y, w_y, axis=0)
    return torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)


@PIPELINES.register_module()
class LoadImageFromFile:
    """Read an image file as an RGB uint8 tensor (PIL decodes it)."""

    def __call__(self, results):
        from PIL import Image
        path = results['img_info']['filename']
        prefix = results.get('img_prefix')
        if prefix:
            path = osp.join(prefix, path)
        with Image.open(path) as im:
            img = torch.from_numpy(np.asarray(im.convert('RGB')).copy())
        results['filename'] = path
        results['img'] = img
        results['img_shape'] = tuple(img.shape[:2])
        results['ori_shape'] = tuple(img.shape[:2])
        return results


@PIPELINES.register_module()
class Resize:
    """Keep-ratio resize to fit inside `img_scale` = (long_edge,
    short_edge): scale = min(long / max_side, short / min_side)."""

    def __init__(self, img_scale, keep_ratio: bool = True):
        if isinstance(img_scale, (list, tuple)) and img_scale \
                and isinstance(img_scale[0], (list, tuple)):
            raise NotImplementedError('multi-scale Resize comes with the '
                                      'train transforms')
        self.img_scale = tuple(img_scale)
        self.keep_ratio = keep_ratio

    def __call__(self, results):
        h, w = results['img'].shape[:2]
        long_edge, short_edge = max(self.img_scale), min(self.img_scale)
        if self.keep_ratio:
            scale = min(long_edge / max(h, w), short_edge / min(h, w))
            new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
        else:
            new_w, new_h = self.img_scale
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
    (gts padded to `max_gt` with a validity mask)."""

    def __init__(self, max_gt: int = 100):
        self.max_gt = max_gt

    def __call__(self, results):
        n = min(len(results.get('gt_labels', [])), self.max_gt)
        gt_bboxes = np.zeros((self.max_gt, 4), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_valid = np.zeros((self.max_gt,), bool)
        if n:
            gt_bboxes[:n] = results['gt_bboxes'][:n]
            gt_labels[:n] = results['gt_labels'][:n]
            gt_valid[:n] = True
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
        )


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
