"""Polygon fill on the host, equal to Pillow's `ImageDraw.polygon(fill=1)`
on a mode 'L' image, which the JAX package draws its mask rasters with
(the card machine has no PIL).

Pillow's scanline fill, as this module reproduces it:

- each vertex coordinate is cast to int (truncated toward zero);
- an edge runs from one vertex to the next, and a closing edge from the
  last vertex back to the first unless they coincide; a horizontal edge
  is drawn as a run of pixels on its row and takes no further part;
- every other edge keeps its first vertex (x0, y0) and its slope
  dx = float(x1 - x0) / (y1 - y0) in float32, and crosses row y at
  float32 (y - y0) * dx + x0;
- rows run from the edges' least y (at most the last row, at least 0) to
  their greatest y (at most the image height): on each, every edge whose
  rows include y gives its crossing, in edge order, and twice on its last
  row unless that row is the last of all;
- corners: a sloped edge's crossing that lands on a whole number (and is
  not doubled) is checked against each earlier edge of the table (in edge
  order) of the same slope sign that starts (or ends) on this row with it
  at the same rounded x; the first such edge that also crosses the next
  row (the previous one on the last row) settles it: when both crossings
  there lie more than a pixel to one side, the crossing moves next to them
  (round(max) + 1, or round(min) - 1);
- the sorted crossings pair up, and each pair (a, b) fills the pixels from
  round-half-up(a) to round-half-down(b) (in float32, a half away from
  zero), clipped to the image.

`tests/test_torch_coco_masks.py` holds it to Pillow bit for bit on the
polygons the datasets carry (squares, 16-gons, convex and concave
polygons, polygons past the box, narrow boxes); outlines that run back over
themselves, so that three or more edges meet at one vertex, can still
differ from Pillow in a few pixels of that vertex's row: 3 of 300 and 7
of 1000 fuzzed outlines there (`ROADMAP.md` Queue 3).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_F32 = np.float32
_HALF = _F32(0.5)


def _round_half_up(f: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP of float32 values: floor(f + 0.5f), the sum
    rounded in float32, mirrored for negative f."""
    a = np.abs(f)
    r = np.floor((a + _HALF).astype(np.float64))
    return np.where(f >= 0, r, -r).astype(np.int64)


def _round_half_down(f: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN: ceil(f - 0.5f), mirrored for negative f."""
    a = np.abs(f)
    r = np.ceil((a - _HALF).astype(np.float64))
    return np.where(f >= 0, r, -r).astype(np.int64)


def _roundf(v) -> float:
    """C roundf: halves away from zero."""
    v = float(v)
    return float(np.copysign(np.floor(abs(v) + 0.5), v))


def _hline(img: np.ndarray, x0: int, y: int, x1: int):
    h, w = img.shape
    if 0 <= y < h and x0 < w and x1 >= 0:
        img[y, max(x0, 0):min(x1, w - 1) + 1] = 1


def fill_polygon(img: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Fill the polygon of float vertices `points` (n, 2) [x, y] into the
    (h, w) uint8 image `img` with 1, in place, as Pillow does; returns
    `img`."""
    h = img.shape[0]
    xy = np.trunc(np.asarray(points, np.float64)).astype(np.int64)
    a = xy
    b = np.roll(xy, -1, axis=0)
    if (xy[-1] == xy[0]).all():
        a, b = a[:-1], b[:-1]
    if not len(a):
        return img
    ymin_e = np.minimum(a[:, 1], b[:, 1])
    ymax_e = np.maximum(a[:, 1], b[:, 1])
    flat = ymin_e == ymax_e
    for (xa, ya), (xb, _) in zip(a[flat], b[flat]):
        _hline(img, min(xa, xb), int(ya), max(xa, xb))
    y_lo = max(min(h - 1, int(ymin_e.min())), 0)
    y_hi = min(max(0, int(ymax_e.max())), h)
    sloped = ~flat
    if y_lo > y_hi or not sloped.any():
        return img
    x0, y0 = a[sloped, 0], a[sloped, 1]
    e_lo, e_hi = ymin_e[sloped], ymax_e[sloped]
    dx = ((b[sloped, 0] - x0).astype(_F32)
          / (b[sloped, 1] - y0).astype(_F32))
    x0f = x0.astype(_F32)

    def cross(rows, edges=slice(None)):
        """float32 crossings (len(rows), edges) of the sloped edges."""
        d = (rows[:, None] - y0[None, edges]).astype(_F32)
        return d * dx[None, edges] + x0f[None, edges]

    rows = np.arange(y_lo, y_hi + 1)
    xs = cross(rows)
    active = (rows[:, None] >= e_lo[None]) & (rows[:, None] <= e_hi[None])
    twice = active & (rows[:, None] == e_hi[None]) & (rows[:, None] < y_hi)
    count = np.cumsum(active.astype(np.int64) + twice, axis=1)
    cand = active & ~twice & (dx[None] != 0) & (xs == np.floor(xs))
    for r, i in zip(*np.nonzero(cand)):
        y = int(rows[r])
        xi = xs[r, i]
        starts = y == e_lo[i]
        for k in range(i):
            if (dx[i] > 0 and dx[k] <= 0) or \
                    (dx[i] < 0 and dx[k] >= 0):
                continue
            if not ((starts and y == e_lo[k]) or
                    (y == e_hi[i] and y == e_hi[k])):
                continue
            if _roundf(xi) != _roundf(cross(np.array([y]), k)[0, 0]):
                continue
            nxt = y - 1 if y == y_hi else y + 1
            if e_lo[k] <= nxt <= e_hi[k]:
                there = cross(np.array([nxt]), np.array([i, k]))[0]
                if xi > there[0] + 1 and xi > there[1] + 1:
                    xs[r, i] = _F32(_roundf(there.max()) + 1)
                elif xi < there[0] - 1 and xi < there[1] - 1:
                    xs[r, i] = _F32(_roundf(there.min()) - 1)
                break
    # the row's crossings, sorted, with the doubled ones twice
    vals = np.concatenate([np.where(active, xs, np.inf),
                           np.where(twice, xs, np.inf)], axis=1)
    vals.sort(axis=1)
    n = count[:, -1]
    pairs = np.arange(vals.shape[1] // 2)
    used = pairs[None] < (n // 2)[:, None]
    lo = _round_half_up(np.where(used, vals[:, 0::2], 0))
    hi = _round_half_down(np.where(used, vals[:, 1::2], 0))
    w = img.shape[1]
    ok = used & (hi >= lo) & (lo < w) & (hi >= 0) & (rows < h)[:, None]
    r_i, p_i = np.nonzero(ok)
    lo_c = np.clip(lo[r_i, p_i], 0, w - 1)
    hi_c = np.clip(hi[r_i, p_i], 0, w - 1)
    cover = np.zeros((len(rows), w + 1), np.int64)
    np.add.at(cover, (r_i, lo_c), 1)
    np.add.at(cover, (r_i, hi_c + 1), -1)
    filled = np.cumsum(cover[:, :w], axis=1) > 0
    keep = rows < h
    img[rows[keep]] |= filled[keep].astype(np.uint8)
    return img


def rasterize_polygons(polygons: Sequence[Sequence[float]], box,
                       mask_size: int) -> np.ndarray:
    """An instance's (mask_size, mask_size) uint8 box-frame raster: each
    polygon [x0, y0, x1, y1, ...] of at least 3 points, in image
    coordinates, scaled into the frame of `box` (x1, y1, x2, y2; float32)
    as the JAX package scales it, then filled with 1."""
    m = mask_size
    x1, y1, x2, y2 = box
    sx = m / max(x2 - x1, 1e-3)
    sy = m / max(y2 - y1, 1e-3)
    img = np.zeros((m, m), np.uint8)
    for poly in polygons:
        if len(poly) // 2 < 3:
            continue
        p = np.asarray(poly[:len(poly) // 2 * 2], np.float32).reshape(-1, 2)
        pts = np.stack([(p[:, 0] - x1) * _F32(sx), (p[:, 1] - y1) * _F32(sy)],
                       axis=1)
        fill_polygon(img, pts)
    return img
