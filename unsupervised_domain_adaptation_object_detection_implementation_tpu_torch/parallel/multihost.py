"""Process-group set-up and rank launch (counterpart of the JAX package's
`parallel/multihost.py`).

`init_multihost` is `jax.distributed.initialize` for `torch.distributed`:
one process a rank, from a `dist_params` block (`coordinator_address`,
`num_processes`, `process_id`, and mmdet's `backend`) or the usual
`MASTER_ADDR` / `MASTER_PORT` / `RANK` / `WORLD_SIZE` environment. The
backend is NCCL on the card and gloo on the CPU unless `backend` names one
(gloo lets two ranks share one card, which NCCL refuses).

`run_ranks(fn, n)` is what `n_devices=n` gives a caller of one process:
it starts n ranks itself (spawned processes, one card each, or gloo ranks
on the CPU), runs `fn` in each and returns their results. A rank that
fails, or a run that outlasts its time limit, fails the call, and every
rank is stopped.

Each rank feeds its own rows of the global batch: the loader walks the
global sampler and keeps this rank's contiguous rows
(`data/builder.py:DataLoader(rows=)`), as each JAX host does before
`jax.make_array_from_process_local_data`.
"""

from __future__ import annotations

import datetime
import os
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def rank_device(device: Union[str, torch.device], rank: int
                ) -> torch.device:
    """The device of a rank: `device` as given when it names a card or the
    CPU, else card `LOCAL_RANK` (or `rank` modulo the cards) made current."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return dev
    if dev.index is None:
        local = int(os.environ.get('LOCAL_RANK', rank))
        dev = torch.device('cuda', local % max(torch.cuda.device_count(), 1))
    torch.cuda.set_device(dev)
    return dev


def process_index(dist_params=None) -> int:
    """This process's rank before its process group exists: a
    `dist_params` block's `process_id`, else `RANK`, else 0."""
    pid = (dist_params or {}).get('process_id')
    return int(pid if pid is not None else os.environ.get('RANK', 0))


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device: Union[str, torch.device] = 'cuda',
                   timeout_s: float = 600.0) -> int:
    """Initialise the default process group (no-op when it is); returns
    this process's rank. `coordinator_address` is `host:port` (or a
    `tcp://` / `file://` URL) of rank 0; without it the environment's
    `MASTER_ADDR` / `MASTER_PORT`, or, for a single process, a free local
    port. `num_processes` and `process_id` default to `WORLD_SIZE` and
    `RANK` (1 and 0). The backend is `backend`, else NCCL for a CUDA
    `device` and gloo for the CPU; collectives time out after
    `timeout_s`."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get('WORLD_SIZE', 1))
    rank = int(process_id if process_id is not None else env.get('RANK', 0))
    if coordinator_address:
        init = coordinator_address if '://' in coordinator_address \
            else f'tcp://{coordinator_address}'
    elif 'MASTER_ADDR' in env:
        init = 'env://'
    elif world == 1:
        init = f'tcp://127.0.0.1:{_free_port()}'
    else:
        raise ValueError(f'{world} processes need a coordinator_address in '
                         'dist_params, or MASTER_ADDR and MASTER_PORT')
    dev = torch.device(device)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    if dev.type == 'cuda':
        rank_device(dev, rank)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def to_host(obj: Any) -> Any:
    """`obj` with every tensor in it (dicts, lists, tuples) as a numpy
    array: what a rank hands back to the process that started it."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, '_fields'):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world, init, device, backend, threads, timeout_s,
               args, queue):
    """A spawned rank: set up its process group, run `fn(*args)`, hand the
    result back (or the traceback, then exit with an error)."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
        if dev.type == 'cuda':
            rank_device(dev, rank)
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = to_host(fn(*args))
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except Exception:      # a rank's boundary: report, then fail the rank
        queue.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn: Callable, nprocs: int, args: Sequence = (),
              device: Union[str, torch.device] = 'cpu',
              backend: Optional[str] = None, threads: Optional[int] = None,
              timeout_s: Optional[float] = 900.0) -> List[Any]:
    """Run `fn(*args)` on `nprocs` spawned ranks of a new process group and
    return their results in rank order (tensors as numpy arrays). `fn`
    and `args` are pickled (`fn` by its import path). On the card each
    rank takes its own card unless `device` names one (with `backend`
    gloo, ranks may share it); more ranks than cards raises. `threads`
    sets each rank's torch threads. A failed rank, or a run past
    `timeout_s` (None: no limit), raises, and every rank is stopped; a
    collective waits at most `timeout_s`, or 30 minutes."""
    import multiprocessing as mp
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        cards = torch.cuda.device_count()
        if nprocs > cards:
            raise ValueError(f'{nprocs} ranks of one card each, but this '
                             f'machine has {cards} card(s)')
    ctx = mp.get_context('spawn')
    queue = ctx.SimpleQueue()
    store = tempfile.mkdtemp(prefix='rendezvous_')
    init = 'file://' + os.path.join(store, 'store')
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, init, str(dev), backend,
                               threads, min(timeout_s or 1800.0, 1800.0),
                               tuple(args), queue))
             for r in range(nprocs)]
    results = {}
    deadline = time.monotonic() + (timeout_s or float('inf'))
    try:
        for p in procs:
            p.start()
        while len(results) < nprocs:
            if not queue.empty():
                rank, ok, payload = queue.get()
                if not ok:
                    raise RuntimeError(f'rank {rank} failed:\n{payload}')
                results[rank] = payload
                continue
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in results]
            if dead and queue.empty():
                raise RuntimeError(f'rank(s) {dead} exited with codes '
                                   f'{[procs[r].exitcode for r in dead]}')
            if time.monotonic() > deadline:
                raise TimeoutError(f'{nprocs} ranks ran past {timeout_s} s')
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30 if len(results) == nprocs else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        shutil.rmtree(store, ignore_errors=True)
    return [results[r] for r in range(nprocs)]
