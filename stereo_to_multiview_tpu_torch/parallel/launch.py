"""Start N ranks on this machine and collect what each returns.

    results = launch(fn, 4, args=(cfg,), backend="gloo")

runs fn(*args) in four new processes (torch.multiprocessing, spawn),
ranks 0-3 of a default process group brought up by
`distributed.init` with a `FileStore` rendezvous in a temporary
directory (no TCP port, which parallel test workers would fight over).
Each rank's return value comes back to the caller with its tensors
moved to the CPU; if any rank fails, the others are stopped and this
raises with the failing rank's traceback.  Every process it starts has
ended when it returns.

On a GPU machine each rank's current device is local_rank %
device_count (`distributed.init`); ranks sharing one card time-share it.
Kernels compile on first use: a caller that launches ranks onto a card
calls `kernels.build_kernels()` first, so that the ranks load the
libraries instead of each running nvcc.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp


class _HostTensor:
    """A tensor's values as a numpy array, pickled by value: a torch
    tensor put on a multiprocessing queue travels in shared memory that
    its sending process must outlive."""

    def __init__(self, t: torch.Tensor):
        self.array = t.detach().cpu().numpy()


def _map(obj, fn, kind):
    """obj with fn applied to every `kind` in it (in tuples, lists and
    dicts)."""
    if isinstance(obj, kind):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(o, fn, kind) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn, kind) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               places, threads, fn, args, out_q):
    import torch.distributed as dist
    from stereo_to_multiview_tpu_torch.parallel import distributed
    try:
        if threads:
            torch.set_num_threads(threads)
        node, local = places[rank] if places else (0, rank)
        # the rank's place, where torchrun would put it
        os.environ.update(NODE_RANK=str(node), LOCAL_RANK=str(local))
        distributed.init(backend, store=dist.FileStore(store_path, world),
                         world_size=world, rank=rank, timeout_s=900.0)
        out = _map(fn(*args), _HostTensor, torch.Tensor)
        dist.barrier()
        out_q.put((rank, True, out))
    except BaseException:                           # noqa: BLE001
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: Sequence = (),
           backend: str = "gloo", places: Optional[Sequence] = None,
           threads: Optional[int] = None, timeout_s: float = 1800.0):
    """fn(*args) on `world_size` new ranks; returns [rank 0's result, ...].
    `places`: each rank's (node, local rank), to lay ranks out as on
    several nodes (default: one node).  `threads`: torch's CPU threads
    in each rank.  Raises RuntimeError if a rank fails or the ranks take
    longer than `timeout_s`."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="stm_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, store, backend, places,
                               threads, fn, tuple(args), out_q),
                         daemon=True)
             for r in range(world_size)]
    results, t0 = {}, time.monotonic()
    try:
        for p in procs:
            p.start()
        while len(results) < world_size:
            try:
                rank, ok, out = out_q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() - t0 > timeout_s:
                    raise RuntimeError(f"ranks still running after "
                                       f"{timeout_s:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = _map(out, lambda h: torch.from_numpy(h.array),
                                 _HostTensor)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        out_q.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
