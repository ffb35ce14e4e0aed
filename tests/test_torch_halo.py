"""The port's row-sharded frame with explicit halos
(`parallel.halo.halo_process_frame`) over four gloo ranks on the CPU,
against the port's unsharded `process_frame` on the same frames and
configs (the configs of tests/test_halo.py), which the other
tests/test_torch_*.py hold against the JAX package; one case also
directly against the JAX package's `halo_process_frame` on conftest's
virtual mesh.

The ranks start once for the file (`launch`, a module fixture) and run
every case; each test reads its case.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models.pipeline import process_frame
from stereo_to_multiview_tpu_torch.parallel.launch import launch

torch.set_num_threads(1)


def _frame(h, w, seed, shift):
    """The JAX halo tests' frame: smoothed noise, the right eye `shift`
    columns over."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + 2 * shift, 3)).astype(np.float32)
    k = np.ones(3) / 3.0
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    return np.concatenate([base[:, :w].astype(np.uint8),
                           base[:, shift:shift + w].astype(np.uint8)],
                          axis=1)


def _cfg(h, w, **kw):
    base = dict(num_rows=h, num_cols=w, num_rows_out=h, num_cols_out=w,
                num_disp=8, zero_disp=4, usd=7, lsd=3, irv_iterations=2,
                bilateral_radius=2, feather_radius=3, num_views=4)
    base.update(kw)
    return PipelineConfig(**base)


FRAME_96 = (96, 64, 7, 4)
FRAME_96B = (96, 64, 11, 4)
FRAME_64 = (64, 48, 3, 3)
FRAME_HSLO = (96, 48, 23, 3)
HSLO = dict(usd=5, lsd=2, irv_iterations=1, feather_radius=2, use_hslo=True)

# name: (mesh, view axis, config, frame)
CASES = {
    "xla_q8": ("row4", None, _cfg(96, 64, engine="xla", xla_agg_qscale=8.0),
               FRAME_96),
    "xla_q8_up": ("row4", None, _cfg(96, 64, num_rows_out=152,
                                     num_cols_out=96, engine="xla",
                                     xla_agg_qscale=8.0), FRAME_96B),
    "xla_q8_down": ("row4", None, _cfg(96, 64, num_rows_out=64,
                                       num_cols_out=48, engine="xla",
                                       xla_agg_qscale=8.0), FRAME_96B),
    "band_down": ("row4", None, _cfg(96, 64, num_rows_out=64,
                                     num_cols_out=48, engine="band"),
                  FRAME_96B),
    "band": ("row4", None, _cfg(96, 64, engine="band"), FRAME_96B),
    "band_2": ("row2", None, _cfg(96, 64, engine="band"), FRAME_96B),
    "view_row_only": ("row2", None, _cfg(64, 48, irv_iterations=1,
                                         engine="xla"), FRAME_64),
    "view_2d": ("row2_view2", "view", _cfg(64, 48, irv_iterations=1,
                                           engine="xla"), FRAME_64),
    "view_2d_q8": ("row2_view2", "view",
                   _cfg(64, 48, irv_iterations=1, engine="xla",
                        xla_agg_qscale=8.0), FRAME_64),
    "view_2d_band": ("row2_view2", "view",
                     _cfg(64, 48, irv_iterations=1, num_views=8,
                          engine="band"), FRAME_64),
    "hslo_band": ("row4", None, _cfg(96, 48, engine="band", **HSLO),
                  FRAME_HSLO),
    "hslo_xla": ("row4", None, _cfg(96, 48, engine="xla",
                                    xla_agg_qscale=8.0, **HSLO), FRAME_HSLO),
    "median_band": ("row4", None, _cfg(96, 64, engine="band",
                                       use_median=True), FRAME_96B),
}

# the JAX package's refusals, each with its message
REFUSED = {
    "rows": (_cfg(97, 64), None, "not divisible by mesh axis"),
    "shard": (_cfg(96, 64, usd=9, lsd=3), None, "smaller than the largest "
              "halo"),
    "views": (_cfg(96, 64, num_views=5), "view", "not divisible by view"),
    "resample_view": (_cfg(96, 64, num_rows_out=48), "view",
                      "row-sharded only"),
    "band_usd": (_cfg(96 * 9, 64, usd=65, lsd=3, engine="band"), None,
                 "requires usd <= 64"),
    "rows_out": (_cfg(96, 64, num_rows_out=90), None,
                 "num_rows_out 90 not divisible"),
}

EXCHANGE = np.arange(32 * 5, dtype=np.float32).reshape(32, 5)


def _ranks(cases, refused):
    """Every case on the ranks; returns rank 0's assembled outputs."""
    from stereo_to_multiview_tpu_torch.parallel import (
        gather_rows, halo_exchange, halo_process_frame, make_mesh,
        shard_rows)
    meshes = {"row4": make_mesh((4,), ("row",)),
              "row2": make_mesh((2,), ("row",), [0, 1]),
              "row2_view2": make_mesh((2, 2), ("row", "view"))}
    out = {}
    x = torch.from_numpy(EXCHANGE)
    mesh = meshes["row4"]
    for edge in ("clamp", "zero", "bleed"):
        ext = halo_exchange(shard_rows(x, mesh), 2, 3, mesh, edge=edge)
        out["exchange_" + edge] = gather_rows(ext, mesh)
    for name, (mesh_name, view, cfg, frame) in cases.items():
        mesh = meshes[mesh_name]
        if not mesh.member:
            continue
        fn = halo_process_frame(mesh, cfg, view_axis=view, device="cpu")
        res = fn(shard_rows(_frame(*frame), mesh))
        out[name] = [gather_rows(r, mesh) for r in res]
    for name, (cfg, view, _) in refused.items():
        try:
            halo_process_frame(meshes["row2_view2" if view else "row4"], cfg,
                               view_axis=view, device="cpu")
            out["refused_" + name] = None
        except ValueError as e:
            out["refused_" + name] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch(_ranks, 4, args=(CASES, REFUSED), threads=1)[0]


def _single(name):
    _, _, cfg, frame = CASES[name]
    return process_frame(_frame(*frame), cfg, device="cpu")


def _equal(got, ref):
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, i
        assert torch.equal(g, r), f"output {i}: {int((g != r).sum())} differ"


@pytest.mark.parametrize("edge", ["clamp", "zero", "bleed"])
def test_halo_exchange_edges(ranks, edge):
    """halo_exchange(lo=2, hi=3) of a 32-row plane in four shards: the
    neighbours' rows inside the frame; at its edges clamped rows, zeros,
    or the bleed rule (above: rows 2, 1 mirrored; below: rows n-2, n-3,
    n-4)."""
    blk = ranks["exchange_" + edge].numpy().reshape(4, 13, 5)
    x, h = EXCHANGE, 32
    for i in range(4):
        np.testing.assert_array_equal(blk[i, 2:10], x[i * 8:i * 8 + 8])
        top = np.arange(i * 8 - 2, i * 8)
        bot = np.arange(i * 8 + 8, i * 8 + 11)
        if edge == "clamp":
            want_top, want_bot = x[np.clip(top, 0, h - 1)], x[np.clip(
                bot, 0, h - 1)]
        else:
            want_top = x[top % h] if i > 0 else (
                np.zeros((2, 5)) if edge == "zero" else x[[2, 1]])
            want_bot = x[bot % h] if i < 3 else (
                np.zeros((3, 5)) if edge == "zero" else x[[h - 2, h - 3,
                                                           h - 4]])
        np.testing.assert_array_equal(blk[i, :2], want_top)
        np.testing.assert_array_equal(blk[i, 10:], want_bot)


def test_halo_process_frame_matches_single(ranks):
    """The XLA engine at xla_agg_qscale 8 (integer costs: exact prefix
    sums), four shards of 24 rows."""
    _equal(ranks["xla_q8"], _single("xla_q8"))


@pytest.mark.parametrize("name", ["xla_q8_up", "xla_q8_down", "band_down"])
def test_halo_process_frame_resampled_matches_single(ranks, name):
    """A resampled output, up (152x96) and down (64x48): the view-row
    halo and the shard's slice of the frame's lerp taps."""
    _equal(ranks[name], _single(name))


@pytest.mark.parametrize("name", ["band", "band_2"])
def test_halo_band_engine_exact(ranks, name):
    """The band engine (B1's halo-shard mode, B2-B6, B7, B8/B9 a round at
    a time, B10, B7's hits, B11, G1, B12's view stack) over four and two
    shards."""
    _equal(ranks[name], _single(name))


def test_halo_view_sharded_matches_row_only(ranks):
    """A (row, view) mesh: the view axis' partial interlaces and their
    all-reduce equal the row-only mesh (XLA engine, float costs); at
    xla_agg_qscale 8 and on the band engine both equal `process_frame`."""
    _equal(ranks["view_2d"], ranks["view_row_only"])
    _equal(ranks["view_2d_q8"], _single("view_2d_q8"))
    _equal(ranks["view_2d_band"], _single("view_2d_band"))


@pytest.mark.parametrize("name", ["hslo_band", "hslo_xla"])
def test_halo_hslo_exact(ranks, name):
    """use_hslo: every shard scans full-width rows (B13 on the band
    engine, the XLA engine's scan at xla_agg_qscale 8)."""
    _equal(ranks[name], _single(name))


def test_halo_skips_median(ranks):
    """Found in the reference: the JAX package's sharded paths have no
    median stage, so with use_median the halo frame equals
    `process_frame` without the median, and differs from it with."""
    _, _, cfg, frame = CASES["median_band"]
    sbs = _frame(*frame)
    _equal(ranks["median_band"],
           process_frame(sbs, cfg.replace(use_median=False), device="cpu"))
    with_median = process_frame(sbs, cfg, device="cpu")
    assert not torch.equal(ranks["median_band"][0], with_median[0])


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_halo_rejects_bad_geometry(ranks, name):
    """The JAX path's refusals, with its messages."""
    msg = ranks["refused_" + name]
    assert msg is not None and REFUSED[name][2] in msg, msg


def test_halo_matches_jax_halo(ranks):
    """The one direct comparison: the JAX package's halo_process_frame on
    conftest's virtual mesh of four devices, same frame and config."""
    import jax
    from stereo_to_multiview_tpu.config import PipelineConfig as JConfig
    from stereo_to_multiview_tpu.parallel import make_mesh
    from stereo_to_multiview_tpu.parallel.halo import halo_process_frame
    _, _, cfg, frame = CASES["xla_q8"]
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "num_rows", "num_cols", "num_rows_out", "num_cols_out", "num_disp",
        "zero_disp", "usd", "lsd", "irv_iterations", "bilateral_radius",
        "feather_radius", "num_views", "engine", "xla_agg_qscale")})
    mesh = make_mesh((4,), ("row",), jax.devices()[:4])
    ref = halo_process_frame(mesh, jcfg)(_frame(*frame))
    for g, r in zip(ranks["xla_q8"], ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
