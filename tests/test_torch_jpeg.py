"""The port's JPEG decoder (`data/pipelines/jpeg.py`) against PIL, which
decodes with libjpeg-turbo's defaults: equal, bit for bit
(`np.array_equal`), on the committed fixtures and on images PIL encodes
here at several qualities, subsamplings and sizes. What the decoder does not
read raises `NotImplementedError`."""

import importlib
import io
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from .torch_port_utils import JAX_PKG, PORT_PKG

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / 'tests/data').rglob('*.jpg'))

jpeg = importlib.import_module(f'{PORT_PKG}.data.pipelines.jpeg')
ttf = importlib.import_module(f'{PORT_PKG}.data.pipelines.transforms')
jtf = importlib.import_module(f'{JAX_PKG}.data.pipelines.transforms')


def _pil(data_or_path):
    src = io.BytesIO(data_or_path) if isinstance(data_or_path, bytes) \
        else data_or_path
    with Image.open(src) as im:
        return np.asarray(im.convert('RGB'))


def _encode(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'JPEG', **kw)
    return buf.getvalue()


def _image(h, w, seed, smooth):
    rs = np.random.RandomState(seed)
    if not smooth:
        return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    ramp = np.linspace(0, 255, w)[None, :, None] + \
        np.linspace(0, 120, h)[:, None, None]
    return np.clip(ramp + rs.standard_normal((h, w, 3)) * 12, 0,
                   255).astype(np.uint8)


def test_the_fixtures_are_there():
    """The 48 synth JPEGs, the 500 of the synth clear→foggy set, the 250
    of the polygon split, the 7 VOC-style fixtures and one synth image at
    Cityscapes size (2048x1024)."""
    assert len([f for f in FILES if 'synth_da_small' in f]) == 48
    assert len([f for f in FILES if 'synth_da/' in f]) == 500
    assert len([f for f in FILES if 'synth_seg' in f]) == 250
    assert 'tests/data/jpeg_2048x1024/synth_clear.jpg' in FILES
    assert len(FILES) == 806


@pytest.mark.parametrize('path', FILES)
def test_fixture_jpegs_equal_pil(path):
    got = jpeg.decode_jpeg(str(ROOT / path))
    ref = _pil(str(ROOT / path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('quality', [50, 75, 95])
@pytest.mark.parametrize('subsampling', [0, 1, 2])     # 4:4:4, 4:2:2, 4:2:0
@pytest.mark.parametrize('smooth', [False, True])
def test_encoded_97x61_equals_pil(quality, subsampling, smooth):
    data = _encode(_image(61, 97, quality + subsampling, smooth),
                   quality=quality, subsampling=subsampling)
    assert np.array_equal(jpeg.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize('hw', [(1, 1), (2, 2), (3, 3), (5, 5), (8, 8),
                                (9, 17), (17, 33), (33, 7), (16, 48)])
@pytest.mark.parametrize('subsampling', [0, 1, 2])
def test_odd_sizes_equal_pil(hw, subsampling):
    """MCU padding and cropping, and the upsamplers' edge columns and rows,
    down to planes of one or two samples (plain replication there)."""
    data = _encode(_image(*hw, seed=sum(hw), smooth=False), quality=90,
                   subsampling=subsampling)
    assert np.array_equal(jpeg.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize('hw', [(61, 97), (1, 1), (33, 7)])
def test_grayscale_equals_pil(hw):
    data = _encode(_image(*hw, seed=3, smooth=True)[..., 0], quality=80)
    got = jpeg.decode_jpeg(data)
    assert got.shape == hw + (3,)
    assert np.array_equal(got, _pil(data))


@pytest.mark.parametrize('kw', [dict(restart_marker_blocks=1),
                                dict(restart_marker_blocks=3, subsampling=0),
                                dict(restart_marker_rows=1, subsampling=1),
                                dict(optimize=True),
                                dict(quality=100, subsampling=0)])
def test_restart_markers_and_own_tables_equal_pil(kw):
    data = _encode(_image(61, 97, seed=5, smooth=False), **kw)
    if 'restart_marker_blocks' in kw or 'restart_marker_rows' in kw:
        assert b'\xff\xdd' in data                        # a DRI segment
    assert np.array_equal(jpeg.decode_jpeg(data), _pil(data))


def test_cityscapes_width_equals_pil():
    """2048x1024: MCU rows and strides at Cityscapes width."""
    h, w = 1024, 2048
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256],
                   -1).astype(np.uint8)
    img[100:300, 300:700] = np.random.RandomState(0).randint(
        0, 256, (200, 400, 3))
    data = _encode(img, quality=90)
    assert np.array_equal(jpeg.decode_jpeg(data), _pil(data))


def test_tables_may_follow_the_frame_header():
    """DQT and DHT anywhere before the scan: move the frame header (SOF0)
    in front of the tables."""
    data = _encode(_image(24, 40, seed=1, smooth=True), quality=85)
    segs, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], 'big')
        segs.append(data[pos:pos + 2 + n])
        pos += 2 + n
    sof = [s for s in segs if s[1] == 0xC0]
    rest = [s for s in segs if s[1] != 0xC0]
    moved = data[:2] + b''.join(sof + rest) + data[pos:]
    assert moved != data
    assert np.array_equal(jpeg.decode_jpeg(moved), _pil(data))


def _patched(data, marker_from, marker_to=None, byte_after=None):
    i = data.index(marker_from)
    out = bytearray(data)
    if marker_to is not None:
        out[i:i + 2] = marker_to
    if byte_after is not None:
        out[i + 4] = byte_after                    # SOF precision byte
    return bytes(out)


@pytest.mark.parametrize('what,make,match', [
    ('progressive', lambda d, a: _encode(a, progressive=True),
     'progressive'),
    ('png', lambda d, a: _png(a), 'not a JPEG'),
    ('cmyk', lambda d, a: _encode_cmyk(a), 'CMYK'),
    ('arithmetic', lambda d, a: _patched(d, b'\xff\xc0', b'\xff\xc9'),
     'arithmetic'),
    ('12-bit', lambda d, a: _patched(d, b'\xff\xc0', byte_after=12),
     '12-bit'),
    ('lossless', lambda d, a: _patched(d, b'\xff\xc0', b'\xff\xc3'),
     'lossless'),
])
def test_what_it_does_not_read_raises_with_the_name(what, make, match):
    arr = _image(16, 16, seed=0, smooth=True)
    data = make(_encode(arr), arr)
    with pytest.raises(NotImplementedError, match=match) as e:
        jpeg.decode_jpeg(data, name=f'{what}.file')
    assert f'{what}.file' in str(e.value)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'PNG')
    return buf.getvalue()


def _encode_cmyk(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).convert('CMYK').save(buf, 'JPEG')
    return buf.getvalue()


def test_a_file_path_is_named_in_the_error(tmp_path):
    p = tmp_path / 'picture.png'
    p.write_bytes(_png(_image(8, 8, seed=0, smooth=False)))
    with pytest.raises(NotImplementedError, match='picture.png'):
        jpeg.decode_jpeg(str(p))


def test_load_image_from_file_matches_jax():
    """The port's LoadImageFromFile (no PIL) against the JAX package's
    (cv2 where present, else PIL) on a fixture."""
    res = dict(img_info=dict(filename='JPEGImages/voc_001.jpg'),
               img_prefix=str(ROOT / 'tests/data/voc_target'), device='cpu')
    got = ttf.LoadImageFromFile()(dict(res))
    ref = jtf.LoadImageFromFile()(dict(res))
    assert isinstance(got['img'], torch.Tensor)
    assert np.array_equal(got['img'].numpy(), ref['img'])
    assert got['img_shape'] == tuple(ref['img_shape'])
    assert got['filename'] == ref['filename']
    assert ttf.LoadImageFromFile(to_float32=True)(dict(res))['img'].dtype \
        == torch.float32
