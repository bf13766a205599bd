"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/*.cu` file has a plain C interface and includes no file of its
own. It is compiled with `nvcc` for Hopper (`sm_90a`) at first use into
`build/kernels/` at the root of the checkout, under a name keyed by a hash
of the source, and bound with `ctypes`. Nothing is compiled when a module is
imported. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def find_nvcc() -> str:
    """`nvcc` from `$CUDA_HOME`, `$PATH` or /usr/local/cuda, else raise."""
    candidates = [os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                  shutil.which('nvcc') or '',
                  '/usr/local/cuda/bin/nvcc']
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'cannot be built')


def build(source: str) -> Tuple[Path, float, str]:
    """Compile `csrc/<source>` unless a library for its current content is
    already built. Returns (library path, build seconds, compiler log)."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f'{src.stem}_{digest}.so'
    if lib.exists():
        return lib, 0.0, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}) for {src}:\n'
                           f'{log}')
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>`; one handle per process."""
    lib, _, _ = build(source)
    return ctypes.CDLL(str(lib))


def build_all() -> Dict[str, Tuple[Path, float, str]]:
    """Build every `csrc/*.cu` in parallel, one `nvcc` per source."""
    from concurrent.futures import ThreadPoolExecutor
    sources = sorted(p.name for p in CSRC.glob('*.cu'))
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        results = list(pool.map(build, sources))
    return dict(zip(sources, results))
