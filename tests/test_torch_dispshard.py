"""The port's disparity-plane sharding (`parallel.dispshard`) over four
gloo ranks on the CPU, with the configs of tests/test_distributed.py,
against the port's unsharded cores and `process_frame` (which the other
tests/test_torch_*.py hold against the JAX package); one case also
directly against the JAX package's `disp_sharded_disparities` on
conftest's virtual mesh.

The ranks start once for the file and run every case.  Every comparison
is exact.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models.pipeline import (
    process_frame, xla_stereo_core)
from stereo_to_multiview_tpu_torch.ops.band import band_stereo_core_chunked
from stereo_to_multiview_tpu_torch.ops.cross import cross_arms_lr
from stereo_to_multiview_tpu_torch.parallel.dispshard import replicated_tail
from stereo_to_multiview_tpu_torch.parallel.launch import launch

torch.set_num_threads(1)


def _pair(h, w, seed):
    """The JAX tests' pair: smoothed noise, the right eye 3 columns
    over."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + 6, 3)).astype(np.float32)
    k = np.ones(3) / 3.0
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    return base[:, :w].astype(np.uint8), base[:, 3:3 + w].astype(np.uint8)


def _cfg(h, w, **kw):
    base = dict(num_rows=h, num_cols=w, num_rows_out=h, num_cols_out=w,
                num_disp=8, zero_disp=4, usd=6, lsd=3)
    base.update(kw)
    return PipelineConfig(**base)


HSLO = dict(usd=5, lsd=2, num_views=4, use_hslo=True)
FRAME = dict(irv_iterations=1, num_views=4, bilateral_radius=2,
             feather_radius=3)
# name: (kind, config, pair)
CASES = {
    "wta_xla": ("core", _cfg(48, 64, engine="xla"), (48, 64, 17)),
    "core_band": ("core", _cfg(48, 64, engine="band"), (48, 64, 23)),
    "frame_xla": ("frame", _cfg(48, 64, engine="xla", **FRAME),
                  (48, 64, 19)),
    "frame_band": ("frame", _cfg(48, 64, engine="band", **FRAME),
                   (48, 64, 19)),
    "hslo_band": ("core", _cfg(32, 48, engine="band", **HSLO), (32, 48, 31)),
    "hslo_xla": ("core", _cfg(32, 48, engine="xla", **HSLO), (32, 48, 31)),
    "core_band_2": ("core2", _cfg(48, 64, engine="band"), (48, 64, 23)),
}


def _ranks(cases):
    from stereo_to_multiview_tpu_torch.parallel import (
        disp_sharded_disparities, disp_sharded_process_frame, make_mesh)
    meshes = {4: make_mesh((4,), ("disp",)),
              2: make_mesh((2,), ("disp",), [0, 1])}
    out = {}
    for name, (kind, cfg, pair) in cases.items():
        mesh = meshes[2 if kind == "core2" else 4]
        if not mesh.member:
            continue
        img_l, img_r = _pair(*pair)
        if kind == "frame":
            fn = disp_sharded_process_frame(mesh, cfg, device="cpu")
            out[name] = fn(np.concatenate([img_l, img_r], axis=1))
        else:
            fn = disp_sharded_disparities(mesh, cfg, device="cpu")
            out[name] = fn(img_l, img_r)
    for name, cfg in (("planes", _cfg(48, 64, num_disp=10, zero_disp=4)),
                      ("hslo_rows", _cfg(30, 48, **HSLO))):
        try:
            fn = disp_sharded_disparities(meshes[4], cfg, device="cpu")
            fn(*_pair(30, 48, 1))
            out["refused_" + name] = None
        except ValueError as e:
            out["refused_" + name] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch(_ranks, 4, args=(CASES,), threads=1)[0]


def _core(name):
    """The unsharded core of the case's engine, with its inputs."""
    _, cfg, pair = CASES[name]
    img_l, img_r = (torch.from_numpy(t) for t in _pair(*pair))
    arms = cross_arms_lr(img_l, img_r, cfg.ucd, cfg.lcd, cfg.usd, cfg.lsd)
    core = xla_stereo_core if cfg.engine == "xla" else \
        band_stereo_core_chunked
    return core(img_l, img_r, *arms, cfg), (img_l, img_r, arms, cfg)


def _equal(got, ref):
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, i
        assert torch.equal(g, r), f"output {i}: {int((g != r).sum())} differ"


def test_disp_sharded_wta_exact(ranks):
    """The XLA engine: D-sharded cost and float32 aggregation, the WTA's
    all-gather keeping the first minimum across ranks."""
    _equal(ranks["wta_xla"], _core("wta_xla")[0])


@pytest.mark.parametrize("name", ["core_band", "core_band_2"])
def test_disp_sharded_band_core_exact(ranks, name):
    """The band engine: each rank's planes quantized and aggregated with
    B4/B5, bit-equal to the unsharded band core (B2-B6), over four and
    two ranks."""
    _equal(ranks[name], _core(name)[0])


def test_disp_sharded_process_frame_matches_single(ranks):
    """The whole frame on the XLA engine equals `process_frame`."""
    _, cfg, pair = CASES["frame_xla"]
    sbs = np.concatenate(_pair(*pair), axis=1)
    _equal(ranks["frame_xla"], process_frame(sbs, cfg, device="cpu"))


def test_disp_sharded_process_frame_band(ranks):
    """On the band engine the frame is the band core followed by the XLA
    engine's tail (`replicated_tail`), as the JAX package's disparity-
    sharded frame runs it."""
    (dl, dr), (img_l, img_r, arms, cfg) = _core("frame_band")
    _equal(ranks["frame_band"],
           replicated_tail(img_l, img_r, dl, dr, *arms, cfg))


@pytest.mark.parametrize("name", ["hslo_band", "hslo_xla"])
def test_disp_sharded_hslo_matches_single(ranks, name):
    """use_hslo: the all-to-all from disparity slices to row slabs, the
    scanline (B13 on the band engine) on each slab, the rows gathered."""
    _equal(ranks[name], _core(name)[0])


def test_disp_sharded_refusals(ranks):
    assert "not divisible by disp axis" in ranks["refused_planes"]
    assert "num_rows divisible" in ranks["refused_hslo_rows"]


def test_disp_sharded_matches_jax(ranks):
    """The one direct comparison: the JAX package's disp_sharded_
    disparities (XLA engine) on conftest's virtual mesh of four devices,
    same pair and config."""
    import jax
    from stereo_to_multiview_tpu.config import PipelineConfig as JConfig
    from stereo_to_multiview_tpu.parallel import (
        disp_sharded_disparities, make_mesh)
    _, cfg, pair = CASES["wta_xla"]
    jcfg = JConfig(num_rows=48, num_cols=64, num_rows_out=48,
                   num_cols_out=64, num_disp=8, zero_disp=4, usd=6, lsd=3,
                   engine="xla")
    mesh = make_mesh((4,), ("disp",), jax.devices()[:4])
    ref = disp_sharded_disparities(mesh, jcfg)(*_pair(*pair))
    for g, r in zip(ranks["wta_xla"], ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
