"""Multi-process helpers of the port (`parallel.distributed`,
`parallel.mesh`, `parallel.launch`) and strategy A (`parallel.sharded`)
on the CPU over gloo ranks: the frame shard of each process, the
local-major rank order of `global_row_mesh`, the two-node case of
tests/test_distributed.py as four ranks in two groups, and the XLA
engine row-sharded, against the port's `process_frame` and, in one case,
the JAX package's `sharded_process_frame` on conftest's virtual mesh.

Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models.pipeline import process_frame
from stereo_to_multiview_tpu_torch.parallel import distributed
from stereo_to_multiview_tpu_torch.parallel.launch import launch

torch.set_num_threads(1)

# four ranks laid out as two nodes of two, the global ranks interleaved
# across the nodes: rank r on node r % 2, local rank r // 2
PLACES = [(0, 0), (1, 0), (0, 1), (1, 1)]


def _frame(rows, cols):
    """tests/_dist_worker.py's frame."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (rows, cols + 4, 3)).astype(np.float32)
    k = np.ones(3) / 3.0
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    return np.concatenate([base[:, :cols].astype(np.uint8),
                           base[:, 2:2 + cols].astype(np.uint8)], axis=1)


def _cfg(**kw):
    """tests/_dist_worker.py's config at 16 rows a rank."""
    base = dict(num_rows=64, num_cols=64, num_rows_out=64, num_cols_out=64,
                num_disp=8, zero_disp=4, usd=5, lsd=2, num_views=4,
                irv_iterations=1, bilateral_radius=2, feather_radius=2,
                engine="xla", xla_agg_qscale=8.0)
    base.update(kw)
    return PipelineConfig(**base)


def _ranks():
    import torch.distributed as dist
    from stereo_to_multiview_tpu_torch.ops.demux import demux_sbs
    from stereo_to_multiview_tpu_torch.parallel import (
        disp_sharded_disparities, gather_rows, halo_process_frame,
        make_mesh, shard_rows, sharded_compute_disparities,
        sharded_process_frame)
    from stereo_to_multiview_tpu_torch.parallel.mesh import all_to_all
    out = {"rank": dist.get_rank(), "place": distributed.place(),
           "frames": list(distributed.frame_shard(range(10)))}
    mesh = distributed.global_row_mesh()
    mesh2 = distributed.global_row_mesh(view_devices=2)
    out["order"] = mesh.ranks.tolist()
    out["order_2d"] = mesh2.ranks.tolist()
    out["row_group_2d"] = mesh2.axis_ranks("row")
    out["view_group_2d"] = mesh2.axis_ranks("view")
    cfg = _cfg()
    sbs = _frame(cfg.num_rows, cfg.num_cols)
    # the two-node case: this rank's own rows, with its global offset
    row0 = mesh.axis_index("row") * (cfg.num_rows // 4)
    res = halo_process_frame(mesh, cfg, device="cpu")(shard_rows(sbs, mesh))
    out["two_node"] = (row0, res)
    # strategy A: the XLA engine row-sharded, over ranks in order
    plain = make_mesh((4,), ("row",))
    for name, c in (("sharded", cfg), ("sharded_median",
                                       cfg.replace(use_median=True))):
        res = sharded_process_frame(plain, c, device="cpu")(
            shard_rows(sbs, plain))
        out[name] = [gather_rows(r, plain) for r in res]
    img_l, img_r = demux_sbs(torch.from_numpy(sbs))
    res = sharded_compute_disparities(plain, cfg.replace(engine="band"),
                                      device="cpu")(
        shard_rows(img_l, plain), shard_rows(img_r, plain))
    out["sharded_disparities"] = [gather_rows(r, plain) for r in res]
    # collectives over a mesh whose order is not the ranks' order
    perm = make_mesh((4,), ("disp",), [0, 2, 1, 3])
    pos = perm.axis_index("disp")
    got = all_to_all([torch.tensor([10 * pos + j]) for j in range(4)], perm,
                     "disp")
    out["all_to_all"] = (pos, [int(t) for t in got])
    out["perm_hslo"] = disp_sharded_disparities(
        perm, _cfg(engine="band", use_hslo=True), device="cpu")(
        img_l.contiguous(), img_r.contiguous())
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch(_ranks, 4, places=PLACES, threads=1)


def test_frame_shard_round_robin():
    frames = list(range(10))
    assert list(distributed.frame_shard(frames, 0, 3)) == [0, 3, 6, 9]
    assert list(distributed.frame_shard(frames, 1, 3)) == [1, 4, 7]
    assert list(distributed.frame_shard(frames, 2, 3)) == [2, 5, 8]
    # outside a process group the defaults give this process every frame
    assert list(distributed.frame_shard(frames)) == frames


def test_frame_shard_defaults_in_ranks(ranks):
    """Inside a process group the defaults are the rank and the world."""
    for r in ranks:
        assert r["frames"] == list(range(r["rank"], 10, 4))


def test_global_row_mesh_local_major(ranks):
    """Ranks ordered by node, then local rank, as the JAX package orders
    its devices: ranks 0 and 2 on node 0, then 1 and 3 on node 1; a view
    axis of two pairs them along the same order."""
    for r in ranks:
        assert r["place"] == PLACES[r["rank"]]
        assert r["order"] == [0, 2, 1, 3]
        assert r["order_2d"] == [[0, 2], [1, 3]]
    by_rank = {r["rank"]: r for r in ranks}
    assert by_rank[0]["view_group_2d"] == [0, 2]
    assert by_rank[0]["row_group_2d"] == [0, 1]
    assert by_rank[3]["row_group_2d"] == [2, 3]


def test_two_node_halo_matches_single(ranks):
    """Four ranks in two groups run halo_process_frame over the
    local-major global mesh; each rank's rows equal the single process's
    rows at its global offset (integer-quantized XLA engine)."""
    cfg = _cfg()
    ref = process_frame(_frame(cfg.num_rows, cfg.num_cols), cfg,
                        device="cpu")
    seen = set()
    for r in ranks:
        row0, res = r["two_node"]
        seen.add(row0)
        for got, want in zip(res, ref):
            assert torch.equal(got, want[row0:row0 + got.shape[0]]), row0
    assert seen == {0, 16, 32, 48}


@pytest.mark.parametrize("name", ["sharded", "sharded_median"])
def test_sharded_process_frame_matches_single(ranks, name):
    """Strategy A runs the XLA engine row-sharded with explicit halos and,
    unlike the halo path, the median where the config asks for it (the
    JAX partitioned graph is the whole process_frame)."""
    cfg = _cfg(use_median=name.endswith("median"))
    ref = process_frame(_frame(cfg.num_rows, cfg.num_cols), cfg,
                        device="cpu")
    for got, want in zip(ranks[0][name], ref):
        assert torch.equal(got, want)


def test_sharded_compute_disparities(ranks):
    """The stereo half of strategy A takes the XLA engine whatever the
    config's engine: its disparities equal the XLA engine's frame."""
    cfg = _cfg()
    ref = process_frame(_frame(cfg.num_rows, cfg.num_cols), cfg,
                        device="cpu")
    dl, dr, ol, orr = ranks[0]["sharded_disparities"]
    assert torch.equal(dl, ref[0]) and torch.equal(dr, ref[1])
    assert ol.dtype == torch.uint8 and ol.shape == dl.shape


def test_sharded_matches_jax(ranks):
    """The one direct comparison: the JAX package's sharded_process_frame
    (the pjit partitioner over its XLA engine) on conftest's virtual mesh
    of four devices, same frame and config."""
    import jax
    from stereo_to_multiview_tpu.config import PipelineConfig as JConfig
    from stereo_to_multiview_tpu.parallel import (
        make_mesh, sharded_process_frame)
    cfg = _cfg()
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "num_rows", "num_cols", "num_rows_out", "num_cols_out", "num_disp",
        "zero_disp", "usd", "lsd", "num_views", "irv_iterations",
        "bilateral_radius", "feather_radius", "engine", "xla_agg_qscale")})
    mesh = make_mesh((4,), ("row",), jax.devices()[:4])
    ref = sharded_process_frame(mesh, jcfg)(_frame(64, 64))
    for got, want in zip(ranks[0]["sharded"], ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fails():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()
    return "unreachable"


def test_launch_reports_a_failing_rank():
    """A rank that raises stops the launch, which raises with the rank's
    traceback; no rank outlives the call."""
    with pytest.raises(RuntimeError, match="rank one fails"):
        launch(_fails, 2, threads=1, timeout_s=120.0)


def test_collectives_follow_mesh_order(ranks):
    """On a mesh laid out as ranks 0, 2, 1, 3 (a process group numbers
    its ranks in ascending order), the all-to-all hands position j the
    chunks meant for j, in position order, and the disparity-plane
    sharding with use_hslo (its all-to-all and all-gathers) equals the
    unsharded band core."""
    from stereo_to_multiview_tpu_torch.ops.band import (
        band_stereo_core_chunked)
    from stereo_to_multiview_tpu_torch.ops.cross import cross_arms_lr
    from stereo_to_multiview_tpu_torch.ops.demux import demux_sbs
    for r in ranks:
        pos, got = r["all_to_all"]
        assert got == [10 * j + pos for j in range(4)]
    cfg = _cfg(engine="band", use_hslo=True)
    img_l, img_r = (t.contiguous() for t in demux_sbs(torch.from_numpy(
        _frame(cfg.num_rows, cfg.num_cols))))
    arms = cross_arms_lr(img_l, img_r, cfg.ucd, cfg.lcd, cfg.usd, cfg.lsd)
    ref = band_stereo_core_chunked(img_l, img_r, *arms, cfg)
    for got, want in zip(ranks[0]["perm_hslo"], ref):
        assert torch.equal(got, want)
