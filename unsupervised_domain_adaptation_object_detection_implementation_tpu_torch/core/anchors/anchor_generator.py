"""Anchor generation (numpy copy of the JAX package's
`core/anchors/anchor_generator.py`).

Same anchor math and ordering as the reference `AnchorGenerator`
(location-major, anchor-minor), so decoded proposals match. Anchors are
computed on the host and moved to the feature map's device by the caller.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ...utils.registry import ANCHOR_GENERATORS


@ANCHOR_GENERATORS.register_module()
class AnchorGenerator:
    """Multi-level anchor generator.

    Args:
        strides: per-level feature strides, e.g. [16] for the DC5 trunk.
        ratios: h/w aspect ratios.
        scales: anchor scales (multiples of base size = stride).
        base_sizes: override per-level base sizes (defaults to strides).
        center_offset: relative center offset inside the stride cell.
    """

    def __init__(self,
                 strides: Sequence[int],
                 ratios: Sequence[float],
                 scales: Sequence[float] = None,
                 base_sizes: Sequence[int] = None,
                 scale_major: bool = True,
                 octave_base_scale: int = None,
                 scales_per_octave: int = None,
                 center_offset: float = 0.0):
        self.strides = [(s, s) if isinstance(s, int) else tuple(s)
                        for s in strides]
        self.base_sizes = list(base_sizes) if base_sizes is not None else \
            [min(s) for s in self.strides]
        if scales is None:
            if octave_base_scale is None or scales_per_octave is None:
                raise ValueError('give scales, or octave_base_scale and '
                                 'scales_per_octave')
            octave_scales = np.array(
                [2**(i / scales_per_octave) for i in range(scales_per_octave)])
            scales = octave_scales * octave_base_scale
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.center_offset = center_offset
        self.base_anchors = [self._single_level_base_anchors(bs)
                             for bs in self.base_sizes]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def _single_level_base_anchors(self, base_size: int) -> np.ndarray:
        w = h = float(base_size)
        x_center = self.center_offset * w
        y_center = self.center_offset * h
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack([
            x_center - 0.5 * ws, y_center - 0.5 * hs,
            x_center + 0.5 * ws, y_center + 0.5 * hs
        ], axis=-1).astype(np.float32)

    def grid_priors(self, featmap_sizes: Sequence[Tuple[int, int]]
                    ) -> List[np.ndarray]:
        """Anchors for each level: [(H*W*A, 4)], location-major, anchor-minor."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f'{len(featmap_sizes)} feature maps for '
                             f'{self.num_levels} anchor levels')
        return [
            self._single_level_grid(featmap_sizes[i], self.strides[i],
                                    self.base_anchors[i])
            for i in range(self.num_levels)
        ]

    @staticmethod
    def _single_level_grid(featmap_size, stride, base_anchors) -> np.ndarray:
        feat_h, feat_w = featmap_size
        shift_x = np.arange(feat_w, dtype=np.float32) * stride[0]
        shift_y = np.arange(feat_h, dtype=np.float32) * stride[1]
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()],
                          axis=-1)
        all_anchors = base_anchors[None, :, :] + shifts[:, None, :]
        return all_anchors.reshape(-1, 4)


def anchor_inside_flags(anchors, img_shape, allowed_border: int = 0):
    """Flags for anchors (..., 4) lying inside the (h, w) of `img_shape`
    (..., 2) within `allowed_border` (torch counterpart of the JAX package's
    `anchor_inside_flags`); leading dims broadcast, so (B, 1, 2) shapes
    against (N, 4) anchors give (B, N). With `allowed_border < 0` every
    anchor is inside."""
    import torch
    h, w = img_shape[..., 0], img_shape[..., 1]
    if allowed_border < 0:
        return torch.ones(anchors.shape[:-1], dtype=torch.bool,
                          device=anchors.device)
    return ((anchors[..., 0] >= -allowed_border) &
            (anchors[..., 1] >= -allowed_border) &
            (anchors[..., 2] < w + allowed_border) &
            (anchors[..., 3] < h + allowed_border))
