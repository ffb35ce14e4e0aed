"""Multi-process execution over `torch.distributed`.

Two complementary strategies, as in the JAX package:

1. **Frame pipelining** -- streams are parallel across frames: process k
   takes frames k, k+P, k+2P, ... and no process talks to another.
   `frame_shard` slices any frame iterator that way.

2. **Single-frame scale-out** -- one frame's rows sharded over every
   rank of every node: build the mesh with `global_row_mesh()` and hand
   it to parallel.halo.  Its exchanges cross nodes only at the shard
   seams between nodes.

Bring-up: every process calls `init()` before it builds a mesh.  The
backend is the caller's explicit choice: NCCL where every rank has a
GPU of its own, gloo across CPU processes and across ranks that share
one card.  Nothing here switches backend or device for the caller.
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Iterable, Iterator, Optional

import torch
import torch.distributed as dist

from stereo_to_multiview_tpu_torch.parallel.mesh import Mesh, make_mesh

def init(backend: str = "nccl", init_method: Optional[str] = None,
         world_size: Optional[int] = None, rank: Optional[int] = None,
         store=None, timeout_s: float = 1800.0) -> None:
    """`torch.distributed.init_process_group`.  Where a GPU is present the
    rank's current CUDA device becomes local_rank % device_count (the
    environment's LOCAL_RANK, as torchrun sets it; else the rank), the
    device the sharded entries take by default.  With no init_method and
    no store the process group reads the environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE)."""
    kw = {}
    if store is not None:
        kw["store"] = store
    elif init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def place() -> tuple:
    """(node, local rank) of this process: the environment's NODE_RANK
    (or GROUP_RANK) and LOCAL_RANK, as torchrun sets them; node 0 and the
    global rank without them."""
    env = os.environ
    return (int(env.get("NODE_RANK", env.get("GROUP_RANK", 0))),
            int(env.get("LOCAL_RANK", dist.get_rank())))


def local_major_ranks() -> list:
    """Every rank of the default group ordered by node, then by local
    rank: the order in which the JAX package enumerates its devices, so
    neighbouring row shards stay on one node wherever they can."""
    places = [None] * dist.get_world_size()
    dist.all_gather_object(places, (*place(), dist.get_rank()))
    return [r for _, _, r in sorted(places)]


def global_row_mesh(view_devices: int = 1) -> Mesh:
    """A 1-D ("row",) or 2-D ("row", "view") mesh over every rank of
    every node, local-major, for the halo path.  Collective."""
    ranks = local_major_ranks()
    if view_devices > 1:
        if len(ranks) % view_devices:
            raise ValueError("device count not divisible by view_devices")
        return make_mesh((len(ranks) // view_devices, view_devices),
                         ("row", "view"), ranks)
    return make_mesh((len(ranks),), ("row",), ranks)


def frame_shard(frames: Iterable, process_id: Optional[int] = None,
                num_processes: Optional[int] = None) -> Iterator:
    """Round-robin frame assignment for strategy 1: this process's
    subsequence (frames process_id, process_id + P, ...), by default this
    rank's of the default group (all frames outside a process group)."""
    on = dist.is_available() and dist.is_initialized()
    pid = (dist.get_rank() if on else 0) if process_id is None else process_id
    n = ((dist.get_world_size() if on else 1) if num_processes is None
         else num_processes)
    return itertools.islice(frames, pid, None, n)
