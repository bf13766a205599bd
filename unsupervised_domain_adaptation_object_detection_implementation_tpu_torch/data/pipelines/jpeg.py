"""Baseline JPEG decoder in numpy, equal to libjpeg-turbo's default output.

PIL and cv2 both decode through libjpeg(-turbo) with its defaults; this
module reproduces that output bit for bit, so the port needs neither:

- the `JDCT_ISLOW` integer IDCT (`jidctint.c`: 13-bit constants, 2 extra
  bits after the column pass, and the range limit that wraps the descaled
  value through a table of 1024 entries);
- fancy upsampling of subsampled chroma (`jdsample.c`): the triangle filter
  with 3/4 and 1/4 weights and the alternating rounding biases (+1/+2 in
  h2v1, +8/+7 in h2v2), edge samples replicated, and plain replication for
  planes of two or fewer samples in width;
- the fixed-point YCbCr→RGB tables of `jdcolor.c` (16 fractional bits).

It reads baseline and extended sequential Huffman files with 8-bit samples:
grayscale, and three components sampled 4:4:4, 4:2:2 or 4:2:0, interleaved
or not, with restart markers and DQT/DHT/DRI anywhere before a scan.
Progressive, lossless, hierarchical or arithmetic-coded files, 12-bit
samples, four components (CMYK/YCCK), other sampling factors and anything
that is not a JPEG (a PNG) raise `NotImplementedError` naming the file.

Only the entropy decode is a Python loop (one table lookup per Huffman
symbol); dequantisation, IDCT, upsampling and colour conversion are numpy
over all blocks of a component at once. It runs on the host, on the CPU and
on the card's machine alike.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Union

import numpy as np

# zigzag position k -> natural (row-major) index in the 8x8 block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)
_NATURAL_LIST = _NATURAL.tolist()

# jidctint.c fixed-point constants, CONST_BITS = 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172

# IDCT_range_limit: the descaled output x maps to table[x & 1023]; 0..127
# give 128..255, 128..511 saturate at 255, 512..895 (x < -128) at 0, and
# 896..1023 (x = -128..-1) give 0..127
_IDCT_LIMIT = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384),
    np.arange(0, 128)]).astype(np.uint8)

_SOF_NAMES = {0xC2: 'progressive', 0xC3: 'lossless', 0xC5: 'hierarchical',
              0xC6: 'hierarchical progressive', 0xC7: 'hierarchical lossless',
              0xC9: 'arithmetic-coded', 0xCA: 'arithmetic-coded progressive',
              0xCB: 'arithmetic-coded lossless',
              0xCD: 'arithmetic-coded hierarchical',
              0xCE: 'arithmetic-coded hierarchical progressive',
              0xCF: 'arithmetic-coded hierarchical lossless'}


def _ycc_tables():
    """jdcolor.c `build_ycc_rgb_table`: Cr→R, Cb→B rounded; Cb→G and
    Cr→G scaled by 2^16 (ONE_HALF folded into Cb→G)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c, shift):
    """One jidctint.c pass over eight coefficient arrays c[0..7] (int64);
    returns the eight outputs descaled by `shift`."""
    # even part
    z1 = (c[2] + c[6]) * _F0541
    tmp2 = z1 + c[6] * (-_F1847)
    tmp3 = z1 + c[2] * _F0765
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    # odd part
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * (-_F0899), z2 * (-_F2562)
    z3, z4 = z3 * (-_F1961) + z5, z4 * (-_F0390) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients and a (64,) natural-order
    quantisation table -> (N, 8, 8) uint8 samples, `jpeg_idct_islow`."""
    d = (coefs.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (vertical frequencies along axis 1), scaled by 2^2
    ws = np.stack(_idct_1d([d[:, k, :] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS), axis=1)
    # pass 2: rows, descaled by 2^(2 + 3) more; then the range limit
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)
    return _IDCT_LIMIT[out & 1023]


def _fancy_h2(plane: np.ndarray, width: int) -> np.ndarray:
    """h2v1 fancy upsampling of the first `width` columns of an
    (rows, cols) int plane: (rows, 2 * width)."""
    p = plane[:, :width].astype(np.int64)
    if width <= 2:                       # jdsample.c: plain replication
        return np.repeat(p, 2, axis=1)
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * width), np.int64)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def _fancy_h2v2(plane: np.ndarray, width: int, height: int) -> np.ndarray:
    """h2v2 fancy upsampling of the first (height, width) samples:
    (2 * height, 2 * width). Each output row mixes its nearest input row
    (3/4) with the next nearest (above for even rows, below for odd; edges
    replicate), then each column pair as h2v1 does with biases 8 and 7."""
    p = plane[:height, :width].astype(np.int64)
    if width <= 2:                       # jdsample.c: plain replication
        return np.repeat(np.repeat(p, 2, axis=0), 2, axis=1)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    colsum = np.empty((2 * height, width), np.int64)
    colsum[0::2] = 3 * p + above
    colsum[1::2] = 3 * p + below
    last = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
    nxt = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
    out = np.empty((2 * height, 2 * width), np.int64)
    out[:, 0::2] = (3 * colsum + last + 8) >> 4
    out[:, 1::2] = (3 * colsum + nxt + 7) >> 4
    return out


def _huffman_lut(bits: List[int], vals: List[int]) -> List[int]:
    """65536-entry lookup on the next 16 bits: (code length << 8) | symbol,
    0 where no code matches."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | vals[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Component:
    __slots__ = ('cid', 'h', 'v', 'tq', 'bw', 'bh', 'coefs', 'width',
                 'height')


def _windows(seg: bytes) -> List[int]:
    """For each byte offset of `seg`, the 40 bits starting there (zeros past
    its end), as Python ints."""
    a = np.frombuffer(seg + b'\x00' * 8, np.uint8).astype(np.int64)
    n = len(seg) + 3
    w = np.zeros(n, np.int64)
    for j in range(5):
        w = (w << 8) | a[j:j + n]
    return w.tolist()


def _decode_scan(segments: List[bytes], comps: List[_Component],
                 tables: List[tuple], mcux: int, mcuy: int,
                 restart: int, name: str):
    """Entropy-decode one baseline scan into the components' coefficient
    lists. `tables` holds (dc lut, ac lut) per scan component."""
    single = len(comps) == 1
    if single:
        c = comps[0]
        nx = -(-c.width // 8)
        ny = -(-c.height // 8)
        units = [[(0, 0)]]
    else:
        nx, ny = mcux, mcuy
        units = [[(by, bx) for by in range(c.v) for bx in range(c.h)]
                 for c in comps]
    total = nx * ny
    nat = _NATURAL_LIST
    seg_i, mcu = 0, 0
    while mcu < total:
        if seg_i >= len(segments):
            raise ValueError(f'{name}: scan data ends after {mcu} of '
                             f'{total} MCUs')
        win = _windows(segments[seg_i])
        seg_i += 1
        end = total if not restart else min(total, mcu + restart)
        pos = 0
        preds = [0] * len(comps)
        for m in range(mcu, end):
            my, mx = divmod(m, nx)
            for ci, c in enumerate(comps):
                dc_lut, ac_lut = tables[ci]
                out = c.coefs
                for by, bx in units[ci]:
                    if single:
                        row, col = my, mx
                    else:
                        row, col = my * c.v + by, mx * c.h + bx
                    base = (row * c.bw + col) * 64
                    # DC: category s, then s bits
                    w = win[pos >> 3]
                    sh = pos & 7
                    e = dc_lut[(w >> (24 - sh)) & 0xFFFF]
                    if not e:
                        raise ValueError(f'{name}: bad Huffman code')
                    ln, s = e >> 8, e & 255
                    if s:
                        val = (w >> (40 - sh - ln - s)) & ((1 << s) - 1)
                        if val < (1 << (s - 1)):
                            val -= (1 << s) - 1
                        preds[ci] += val
                    pos += ln + s
                    out[base] = preds[ci]
                    # AC: (run, size) symbols until EOB
                    k = 1
                    while k < 64:
                        w = win[pos >> 3]
                        sh = pos & 7
                        e = ac_lut[(w >> (24 - sh)) & 0xFFFF]
                        if not e:
                            raise ValueError(f'{name}: bad Huffman code')
                        ln, rs = e >> 8, e & 255
                        s = rs & 15
                        if s:
                            k += rs >> 4
                            if k > 63:
                                raise ValueError(f'{name}: AC run past the '
                                                 'block')
                            val = (w >> (40 - sh - ln - s)) & ((1 << s) - 1)
                            if val < (1 << (s - 1)):
                                val -= (1 << s) - 1
                            out[base + nat[k]] = val
                            pos += ln + s
                            k += 1
                        elif rs == 0xF0:
                            pos += ln
                            k += 16
                        else:
                            pos += ln
                            break
        mcu = end


def _split_scan(data: bytes, start: int):
    """The entropy-coded data after an SOS header at `start`: its restart
    segments (byte stuffing removed) and the offset of the marker that ends
    it."""
    m = re.compile(rb'\xff[^\x00\xd0-\xd7]').search(data, start)
    stop = m.start() if m else len(data)
    segs = re.split(rb'\xff[\xd0-\xd7]', data[start:stop])
    return [s.replace(b'\xff\x00', b'\xff') for s in segs], stop


def decode_jpeg(src: Union[str, bytes], name: Optional[str] = None
                ) -> np.ndarray:
    """Decode a baseline JPEG (a path or its bytes) to an (H, W, 3) RGB
    uint8 array equal to libjpeg-turbo's default decode (what PIL's
    `Image.open(p).convert('RGB')` and cv2's `imread` give); grayscale is
    replicated to three channels. Raises `NotImplementedError` with the
    file name on anything else (see the module docstring)."""
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
        name = name or '<bytes>'
    else:
        name = name or str(src)
        with open(src, 'rb') as f:
            data = f.read()
    if data[:2] != b'\xff\xd8':
        raise NotImplementedError(f'{name}: not a JPEG file (no SOI marker); '
                                  'the decoder reads baseline JPEG only')
    qt: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, List[int]] = {}
    ac_tabs: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    width = height = 0
    restart = 0
    adobe_transform = None
    saw_jfif = False
    hmax = vmax = 1
    pos = 2
    scans = 0
    while True:
        # next marker: skip fill bytes
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                        # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        seg_len = int.from_bytes(data[pos:pos + 2], 'big')
        seg = data[pos + 2:pos + seg_len]
        pos += seg_len
        if marker in _SOF_NAMES:
            raise NotImplementedError(f'{name}: {_SOF_NAMES[marker]} JPEG; '
                                      'the decoder reads baseline only')
        if marker in (0xC0, 0xC1):                # baseline / extended
            precision = seg[0]
            height = int.from_bytes(seg[1:3], 'big')
            width = int.from_bytes(seg[3:5], 'big')
            n = seg[5]
            if precision != 8:
                raise NotImplementedError(f'{name}: {precision}-bit samples;'
                                          ' the decoder reads 8-bit only')
            if n not in (1, 3):
                raise NotImplementedError(
                    f'{name}: {n} components (CMYK/YCCK or other); the '
                    'decoder reads grayscale and YCbCr/RGB only')
            if height == 0:
                raise NotImplementedError(f'{name}: height set by a DNL '
                                          'marker')
            for i in range(n):
                c = _Component()
                c.cid, hv, c.tq = seg[6 + 3 * i], seg[7 + 3 * i], \
                    seg[8 + 3 * i]
                c.h, c.v = hv >> 4, hv & 15
                comps.append(c)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            for c in comps:
                ratio = (hmax // c.h, vmax // c.v)
                if n > 1 and (hmax % c.h or vmax % c.v
                              or ratio not in ((1, 1), (2, 1), (2, 2))):
                    raise NotImplementedError(
                        f'{name}: sampling factors '
                        f'{[(k.h, k.v) for k in comps]}; the decoder reads '
                        '4:4:4, 4:2:2 and 4:2:0')
                c.width = -(-width * c.h // hmax)
                c.height = -(-height * c.v // vmax)
                mcux = -(-width // (8 * hmax))
                mcuy = -(-height // (8 * vmax))
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.coefs = [0] * (c.bw * c.bh * 64)
        elif marker == 0xC4:                      # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = list(seg[i + 1:i + 17])
                nv = sum(bits)
                vals = list(seg[i + 17:i + 17 + nv])
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lut(bits, vals)
                i += 17 + nv
        elif marker == 0xDB:                      # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + size],
                                    '>u2' if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_NATURAL] = raw
                qt[tq] = table
                i += 1 + size
        elif marker == 0xDD:                      # DRI
            restart = int.from_bytes(seg[:2], 'big')
        elif marker == 0xE0 and seg[:5] == b'JFIF\x00':
            saw_jfif = True
        elif marker == 0xEE and seg[:5] == b'Adobe' and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:                      # SOS
            if not comps:
                raise ValueError(f'{name}: scan before the frame header')
            ns = seg[0]
            scomps, tabs = [], []
            for i in range(ns):
                cid, td_ta = seg[1 + 2 * i], seg[2 + 2 * i]
                c = next(k for k in comps if k.cid == cid)
                scomps.append(c)
                tabs.append((dc_tabs[td_ta >> 4], ac_tabs[td_ta & 15]))
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            if ss != 0 or se != 63:
                raise NotImplementedError(f'{name}: spectral selection '
                                          f'{ss}..{se} (progressive)')
            segments, pos = _split_scan(data, pos)
            _decode_scan(segments, scomps, tabs,
                         -(-width // (8 * hmax)), -(-height // (8 * vmax)),
                         restart, name)
            scans += 1
    if not scans:
        raise ValueError(f'{name}: no scan data')

    planes = []
    for c in comps:
        coefs = np.asarray(c.coefs, np.int64).reshape(-1, 64)
        blocks = idct_islow(coefs, qt[c.tq]).reshape(c.bh, c.bw, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        if len(comps) > 1 and (c.h, c.v) != (hmax, vmax):
            if vmax // c.v == 2:
                plane = _fancy_h2v2(plane, c.width, c.height)
            else:
                plane = _fancy_h2(plane[:c.height], c.width)
        planes.append(plane[:height, :width].astype(np.int64))
    if len(comps) == 1:
        g = planes[0].astype(np.uint8)
        return np.repeat(g[:, :, None], 3, axis=2)
    # jdapimin.c: JFIF means YCbCr; else an Adobe marker's transform
    # decides; else component ids 'R', 'G', 'B' mean RGB
    if not saw_jfif and (adobe_transform == 0 if adobe_transform is not None
                         else [c.cid for c in comps] == [82, 71, 66]):
        return np.stack(planes, -1).astype(np.uint8)
    y, cb, cr = planes
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
