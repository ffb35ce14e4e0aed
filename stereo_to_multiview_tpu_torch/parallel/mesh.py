"""Rank meshes, row shards and the collectives of the sharded paths.

A mesh lays ranks of the default process group of `torch.distributed`
out row-major over named axes, as the JAX package's device meshes do:

  row    -- H-tile data parallelism with explicit halos (parallel.halo,
            parallel.sharded)
  disp   -- disparity-plane parallelism of the stereo core
            (parallel.dispshard)
  view   -- the synthesis' view fan-out, a second axis beside row

Each axis carries one process group per line of the mesh along it
(`torch.distributed.new_group`), so a ("row", "view") mesh reduces over
its view axis alone.  There is no partitioner: `shard_rows` and
`gather_rows` give a rank its slice of a frame's rows and assemble a
row-sharded output.

The collectives the shard functions need are the functions below: the
neighbour exchange of a halo (as an all-gather of every shard's edge
rows: a halo is at most 3 * usd rows), all-gather, all-to-all and an
all-reduce sum.  The backend is the caller's choice (`distributed.init`
or `launch.launch`).  Where it lacks the CUDA form of a collective
(gloo has only all-reduce and broadcast on CUDA tensors), `route`
stages the collective through pinned host memory; under NCCL nothing is
staged.  Each mesh counts its collectives' calls, staged calls, bytes
and seconds in `Mesh.stats` (the device synchronized before and after
each, so the time is the exchange's own).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the collectives gloo runs on CUDA tensors; every other one is staged
GLOO_CUDA = frozenset({"all_reduce"})


class Mesh:
    """Ranks of the default process group laid out over named axes.

    `ranks` is the (shape) array of global ranks; `axis_names` the axes'
    names; this process's coordinates and, per axis, the process group of
    its line along that axis.  A rank outside the mesh has no coordinates
    (`member` is False) and runs none of its shard functions.  `stats`:
    {collective: {calls, staged, bytes, seconds}} of the collectives run
    over this mesh (clear it to start a count)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 groups: dict, line_ranks: dict):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        where = np.argwhere(ranks == self.rank)
        self.member = len(where) == 1
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if self.member else {})
        self._groups = groups
        self._line_ranks = line_ranks
        self.stats = {}

    def axis_index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in this mesh")
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        self.axis_index(axis)
        return self._groups[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's line along `axis`, in order."""
        self.axis_index(axis)
        return self._line_ranks[axis]

    def group_order(self, axis: str) -> list:
        """For each position along `axis`, its rank's index in the axis'
        process group, whose ranks `new_group` numbers in ascending order
        of their global ranks (a local-major mesh need not be)."""
        line = self.axis_ranks(axis)
        ordered = sorted(line)
        return [ordered.index(r) for r in line]

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks={self.ranks.tolist()}, "
                f"backend={self.backend})")


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("row",),
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over `ranks` (default: every rank of the default process
    group, in order), reshaped row-major to `shape` (default: one axis
    over all of them).  Collective: every rank of the default group calls
    it with the same arguments, in the same order as its other
    `new_group` calls, members of the mesh or not."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not "
                           "initialized (parallel.distributed.init)")
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if shape is None:
        shape = (len(ranks),)
    n = int(np.prod(shape))
    if n > len(ranks) or len(axis_names) != len(shape):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} ranks and "
                         f"{len(shape)} axis names")
    arr = np.asarray(ranks[:n], dtype=np.int64).reshape(tuple(shape))
    me = dist.get_rank()
    groups, line_ranks = {}, {}
    for a, name in enumerate(axis_names):
        moved = np.moveaxis(arr, a, -1)
        for idx in itertools.product(*map(range, moved.shape[:-1])):
            line = [int(r) for r in moved[idx]]
            g = dist.new_group(line)
            if me in line:
                groups[name], line_ranks[name] = g, line
    return Mesh(arr, axis_names, groups, line_ranks)


def route(op: str, x: torch.Tensor, backend: str) -> bool:
    """True where collective `op` on tensor `x` is staged through pinned
    host memory: a CUDA tensor under a backend that lacks the CUDA form
    of the collective (gloo, but for all-reduce); never under NCCL, and
    never for a CPU tensor."""
    if x.device.type != "cuda" or backend == "nccl":
        return False
    if backend == "gloo":
        return op not in GLOO_CUDA
    raise ValueError(f"no collective route for backend {backend!r}")


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


@contextlib.contextmanager
def _timed(mesh: Mesh, op: str, tensors, staged: bool):
    """One collective call over `mesh`: synchronize the device around it,
    count the call, its bytes and its seconds in `mesh.stats`."""
    cuda = tensors[0].device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(tensors[0].device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(tensors[0].device)
    s = mesh.stats.setdefault(op, {"calls": 0, "staged": 0, "bytes": 0,
                                   "seconds": 0.0})
    s["calls"] += 1
    s["staged"] += int(staged)
    s["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    s["seconds"] += time.perf_counter() - t0


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """Every shard's x along `axis`, in the axis' order (x of one shape
    on every rank)."""
    group, backend = mesh.group(axis), mesh.backend
    n = mesh.shape[axis]
    x = x.contiguous()
    staged = route("all_gather", x, backend)
    with _timed(mesh, "all_gather", [x], staged):
        src = _to_host(x) if staged else x
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        if staged:
            parts = [p.to(x.device) for p in parts]
    return [parts[k] for k in mesh.group_order(axis)]


def all_to_all(chunks: Sequence[torch.Tensor], mesh: Mesh,
               axis: str) -> list:
    """chunks[j] goes to the j-th shard along `axis`; returns the chunk
    each shard sent here, in the axis' order (every chunk of one shape,
    on every rank).  One `all_to_all_single` of the chunks laid end to
    end, the form gloo implements."""
    group, backend = mesh.group(axis), mesh.backend
    shape = chunks[0].shape
    order = mesh.group_order(axis)
    by_group = [None] * len(order)
    for pos, k in enumerate(order):
        by_group[k] = chunks[pos]
    flat = torch.cat([c.reshape(-1) for c in by_group])
    staged = route("all_to_all", flat, backend)
    with _timed(mesh, "all_to_all", [flat], staged):
        src = _to_host(flat) if staged else flat
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        if staged:
            out = out.to(flat.device)
    parts = out.chunk(len(chunks))
    return [parts[k].reshape(shape) for k in order]


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over the shards along `axis` (a new tensor)."""
    group, backend = mesh.group(axis), mesh.backend
    x = x.contiguous().clone()
    staged = route("all_reduce", x, backend)
    with _timed(mesh, "all_reduce", [x], staged):
        buf = _to_host(x) if staged else x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if staged:
            x.copy_(buf)
    return x


def shard_rows(x, mesh: Mesh, axis: str = "row"):
    """This rank's slice of rows (dim 0) of x: the i-th of mesh.shape[axis]
    equal slices along `axis` (the rows must divide)."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)
    h = x.shape[0]
    if h % n:
        raise ValueError(f"{h} rows do not divide over {n} shards")
    loc = h // n
    return x[i * loc:(i + 1) * loc]


def gather_rows(x: torch.Tensor, mesh: Mesh,
                axis: str = "row") -> torch.Tensor:
    """The whole frame's rows of a row-sharded x: every shard's x along
    `axis` concatenated along dim 0."""
    return torch.cat(all_gather(x, mesh, axis))
