"""The JAX package's native library under the port tests' lock
(`torch_port_utils.native_library`): processes that start together on a
cold cache, as xdist workers do, each get the library, so the JAX uint8
resize the parity tests hold the port to is the native one in every one
of them (unlocked, some of them read a half-written file and fell back to
cv2's resize, grey levels off on downscales)."""

import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# import the helpers (which build and load the library under the lock),
# then ask the JAX module itself
CHILD = (
    'import importlib, sys; sys.path.insert(0, sys.argv[1]); '
    'from tests import torch_port_utils as u; '
    'lib = u.native_library(); '
    "n = importlib.import_module(u.JAX_PKG + '.utils.native'); "
    "print('native', lib is not None and n.has_native() "
    'and n._LIB is lib)')


def test_processes_started_together_on_a_cold_cache_each_load_it(tmp_path):
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path / 'cache'),
               OMP_NUM_THREADS='1')
    procs = []
    for _ in range(8):
        procs.append(subprocess.Popen(
            [sys.executable, '-c', CHILD, str(ROOT)], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        time.sleep(0.2)
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split()[-2:] == ['native', 'True'], (out, err[-2000:])
    assert (tmp_path / 'cache' / 'udaod_tpu' / 'libudaod_native.so').exists()
