"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs and weights come from `np.random.RandomState`; both packages get the
same numpy values.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import importlib
import importlib.util
import os
import subprocess
import tempfile

import numpy as np
import torch

JAX_PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu'
PORT_PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu_torch'


def _share_the_cores():
    """Under pytest-xdist, torch's intra-op pool gets this worker's share
    of the cores: with its default (every core in every worker) six
    workers on eight cores run a port test several times slower than one
    does alone (the pools' threads spin against each other)."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


_share_the_cores()


def _native_reason(native) -> str:
    """Why the JAX package's native library does not load: `g++`'s error
    on its sources, or the loader's on the library it builds."""
    nat = os.path.join(os.path.dirname(native.__file__), '..', 'native')
    srcs = [os.path.join(nat, 'tpfp.cpp'), os.path.join(nat, 'imageproc.cpp')]
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, 'libudaod_native.so')
        try:
            run = subprocess.run(
                ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', '-fopenmp',
                 *srcs, '-o', so], capture_output=True, text=True)
        except OSError as e:
            return f'g++ did not run: {e}'
        if run.returncode:
            return f'g++ exited {run.returncode}: {run.stderr.strip()}'
        try:
            ctypes.CDLL(so)
        except OSError as e:
            return f'g++ built it, but it does not load: {e}'
    return 'g++ builds and loads it here; the cached copy fails'


def native_library():
    """The JAX package's native C++ library (`utils/native.py`, which the
    JAX `_imresize` uses for uint8 images), built and loaded under an
    `fcntl.flock` on a lock file beside the cached `.so`. The JAX module
    builds it on its first call in each process, with no lock, and gives up
    for the rest of the process on any error: xdist workers that start
    together on a cold cache read each other's half-written file, and their
    uint8 resizes fall back to cv2's (no antialias). Under the lock one
    process builds and the others load the finished file. Should the load
    still fail, the JAX module's state is reset and the build retried under
    the lock; a second failure raises with `g++`'s reason."""
    native = importlib.import_module(f'{JAX_PKG}.utils.native')
    if native._LIB is not None:
        return native._LIB
    cache = os.path.join(os.environ.get('XDG_CACHE_HOME',
                                        os.path.expanduser('~/.cache')),
                         'udaod_tpu')
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, 'libudaod_native.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for _ in range(2):
                native._TRIED, native._LIB = False, None
                if native.has_native():
                    return native._LIB
            raise RuntimeError('the JAX package has no native library, so '
                               'its uint8 resize is not the one the port '
                               f'copies: {_native_reason(native)}')
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# the first build and load of each process happen under the lock (where
# the JAX package is installed: the card's machine has none); a failure
# shows again, with its reason, in the tests that need the library
if importlib.util.find_spec('jax') is not None:
    try:
        native_library()
    except RuntimeError:
        pass

# the intra-op thread count at which the tiny DAF-family train steps were
# held to JAX: their updates sit within 1e-4 of scale of JAX's at 8
# threads, while 1, 2 or 4 reorder the CPU's sums and miss by up to 10x
PARITY_THREADS = 8


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op pool at `n` threads inside the block."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


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


# the tiny fixture's RPN conv and box head narrowed (from 2048 and 1024
# wide) for the tests that hold the port against itself: a step, and a
# checkpoint (params, momentum and EMA: 680 → 207 MB), cost a fraction
NARROW = {'model.rpn_head.feat_channels': 64,
          'model.roi_head.bbox_head.fc_out_channels': 64}
NARROW_OPTIONS = [f'{k}={v}' for k, v in NARROW.items()]

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
