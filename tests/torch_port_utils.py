"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs and weights come from `np.random.RandomState`; both packages get the
same numpy values.
"""

from __future__ import annotations

import numpy as np

JAX_PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu'
PORT_PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu_torch'


def fill_variables(shapes, rs: np.random.RandomState, path=()):
    """Numpy values for a tree of shapes (from `jax.eval_shape` of
    `model.init`): conv/dense kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1),
    frozen-BN scale/var ~ U(0.5, 1.5), means ~ N(0, 0.1)."""
    if hasattr(shapes, 'items'):
        return {k: fill_variables(v, rs, path + (k,))
                for k, v in shapes.items()}
    shape = tuple(shapes.shape)
    name = path[-1]
    if name == 'kernel' and len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
        return (rs.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    if name in ('scale', 'var'):
        return rs.uniform(0.5, 1.5, shape).astype(np.float32)
    return (0.1 * rs.standard_normal(shape)).astype(np.float32)


def edge_case_rois(rs: np.random.RandomState, b: int, n: int, h: int, w: int,
                   stride: int = 16) -> np.ndarray:
    """(b, n, 4) float32 RoIs in image coordinates of an (h, w) feature map
    at `stride`: random boxes plus boxes crossing and beyond the border,
    boxes under one feature pixel, and zero (padded) boxes."""
    ih, iw = h * stride, w * stride
    x1 = rs.uniform(-0.2 * iw, iw, (b, n))
    y1 = rs.uniform(-0.2 * ih, ih, (b, n))
    bw = rs.uniform(0.5, 0.8 * iw, (b, n))
    bh = rs.uniform(0.5, 0.8 * ih, (b, n))
    rois = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    special = np.array([
        [0, 0, 0, 0],                          # padded slot
        [-3 * stride, -2 * stride, 2 * stride, 3 * stride],  # crosses 0
        [iw - stride, ih - stride, iw + 4 * stride, ih + 3 * stride],
        [iw + stride, ih + stride, iw + 5 * stride, ih + 6 * stride],
        [-9 * stride, -9 * stride, -2 * stride, -3 * stride],  # beyond
        [5.3, 7.1, 5.9, 7.4],                  # under one feature pixel
        [0.5 * iw, 0.5 * ih, 0.5 * iw + 3.0, 0.5 * ih + 2.0],
    ], np.float64)
    k = min(len(special), n)
    rois[:, :k] = special[:k]
    return rois.astype(np.float32)


SYNTH_CONFIG = 'configs/da/faster_rcnn_r18_synth_shapes.py'
SYNTH_DATA = 'tests/data/synth_da_small'


def synth_overrides(root) -> dict:
    """Dotted overrides that point every split of the synth-shapes config at
    the committed subset under `root` (the config builds its paths from
    `data_root` when it loads, so each split's own paths are set)."""
    out = {}
    for key, sub, split in (('data.train.datasets.0', 'shapes_clear', 'train'),
                            ('data.train.datasets.1', 'shapes_foggy', 'train'),
                            ('data.val', 'shapes_foggy', 'test'),
                            ('data.test', 'shapes_foggy', 'test')):
        base = f'{root}/{SYNTH_DATA}/{sub}/'
        out[f'{key}.ann_file'] = f'{base}ImageSets/Main/{split}.txt'
        out[f'{key}.img_prefix'] = base
    return out
