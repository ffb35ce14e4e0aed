"""The PyTorch port's frame stages against the JAX package, on the CPU.

Same inputs (numpy, from seeds) through the JAX function and its port;
exact unless a tolerance is stated beside the assert.  The JAX side runs
its XLA-engine functions, which the JAX tests hold equal to its band
kernels (the port's main path semantics).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu import config as jconfig
from stereo_to_multiview_tpu.models import pipeline as jpipe
from stereo_to_multiview_tpu.ops import dibr as jdibr
from stereo_to_multiview_tpu.utils.bmp import read_bmp as jread_bmp

from stereo_to_multiview_tpu_torch import config as tconfig
from stereo_to_multiview_tpu_torch.models import pipeline as tpipe
from stereo_to_multiview_tpu_torch.ops import (
    cost as tcost, cross as tcross, dcc as tdcc, demux as tdemux,
    dibr as tdibr, filters as tfilters, irv as tirv, mux as tmux)
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
H, W, ND, ZD = 36, 52, 12, 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def images():
    """A real crop of the bud pair (half resolution) and random noise."""
    l = read_bmp(os.path.join(DATA, "bud_2.bmp"))[100:172:2, 200:304:2]
    r = read_bmp(os.path.join(DATA, "bud_3.bmp"))[100:172:2, 200:304:2]
    return np.ascontiguousarray(l), np.ascontiguousarray(r)


@pytest.fixture(scope="module")
def disps():
    rng = np.random.default_rng(7)
    dl = rng.integers(-ZD, ND - ZD, (H, W)).astype(np.float32)
    dr = rng.integers(-ZD, ND - ZD, (H, W)).astype(np.float32)
    return dl, dr


# ---- config, import isolation, device policy --------------------------

@pytest.mark.parametrize("name", ["BUD", "FISH", "HD1080_D128"])
def test_config_from_dict_reproduces_every_field(name):
    jc = getattr(jconfig, name)
    tc = tconfig.config_from_dict(dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc == getattr(tconfig, name)
    assert (tc.disp_range, tc.sbs_shape, tc.out_shape) == (
        jc.disp_range, jc.sbs_shape, jc.out_shape)


def test_config_checks_and_unknown_fields():
    with pytest.raises(ValueError):
        tconfig.config_from_dict({"num_rows": 8, "not_a_knob": 1})
    with pytest.raises(ValueError):
        tconfig.PipelineConfig(num_disp=8, zero_disp=9)
    with pytest.raises(ValueError):
        tconfig.PipelineConfig(usd=4, lsd=5)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the JAX
    package (a fresh interpreter, so this test's own imports don't count),
    the runtime's modules, its native binding, the apps, the sharded paths
    (parallel/) and their launch module included."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import stereo_to_multiview_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'stereo_to_multiview_tpu'"
        " or m.startswith('stereo_to_multiview_tpu.')]\n"
        "print(bad)\n"
        "print(' '.join(names))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    walked = set(res.stdout.split())
    pkg = "stereo_to_multiview_tpu_torch."
    for name in ("apps.image_io", "apps.video_io", "models.stream",
                 "native", "utils.device", "utils.dump", "utils.imageio",
                 "utils.preview", "utils.timing", "utils.y4m", "ops.wta",
                 "parallel.mesh", "parallel.distributed", "parallel.halo",
                 "parallel.dispshard", "parallel.sharded", "parallel.launch",
                 "ops.postkern", "ops.irvkern"):
        assert pkg + name in walked, name
    # chip_smoke.py, the port's script on the card, imports neither
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "import jax" not in src and "stereo_to_multiview_tpu." not in \
        src.replace("stereo_to_multiview_tpu_torch", "")


def test_process_frame_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.PipelineConfig(num_rows=8, num_cols=16, num_rows_out=8,
                                 num_cols_out=16, num_disp=4, zero_disp=2,
                                 usd=2, lsd=1)
    sbs = np.zeros(cfg.sbs_shape, np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.process_frame(sbs, cfg)


@pytest.mark.parametrize("knob", [
    dict(engine="xla"), dict(engine="xla", band_qscale=20000.0),
    dict(engine="xla", band_lossy_wta=True, band_digits=0)])
def test_unported_knobs_raise(knob):
    """No knob is refused any more: the XLA engine (ROADMAP A.4) runs,
    and the band engine's dials, out of the band engine's range too, do
    not reach it (the JAX package's XLA engine never reads them)."""
    base = dict(num_rows=8, num_cols=16, num_rows_out=8, num_cols_out=16,
                num_disp=4, zero_disp=2, usd=2, lsd=1)
    cfg = tconfig.PipelineConfig(**{**base, **knob})
    rng = np.random.default_rng(3)
    sbs = rng.integers(0, 256, cfg.sbs_shape, dtype=np.uint8)
    got = tpipe.process_frame(sbs, cfg, device="cpu")
    ref = tpipe.process_frame(
        sbs, tconfig.PipelineConfig(**base, engine="xla"), device="cpu")
    assert [tuple(x.shape) for x in got] == [(8, 16), (8, 16), (8, 16, 3)]
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_kernel_wrapper_rejects_other_devices():
    """A wrapper takes the plain version only for a CPU tensor; any other
    device launches the kernel or raises -- never a silent fallback."""
    from stereo_to_multiview_tpu_torch.ops.band import h_pass_sum
    vol = torch.empty((4, 8, 4), dtype=torch.uint8, device="meta")
    arm = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        h_pass_sum(vol, arm, arm, 0, 2)


# ---- frame stages ------------------------------------------------------

def test_read_bmp_matches_jax_reader():
    for name in ("bud_1", "fish_1"):
        p = os.path.join(DATA, f"{name}.bmp")
        np.testing.assert_array_equal(read_bmp(p), jread_bmp(p))


def test_demux_sbs(images):
    l, r = images
    sbs = np.concatenate([l, r], axis=1)
    jl, jr = jops.demux_sbs(jnp.asarray(sbs))
    tl, tr = tdemux.demux_sbs(_t(sbs))
    np.testing.assert_array_equal(_np(jl), _np(tl))
    np.testing.assert_array_equal(_np(jr), _np(tr))


def test_mux_average(images):
    rng = np.random.default_rng(3)
    for img in (images[0], rng.integers(0, 256, (17, 23, 3), np.uint8)):
        np.testing.assert_array_equal(
            _np(jops.mux_average(jnp.asarray(img))),
            _np(tmux.mux_average(_t(img))))


def test_mux_merge_ab():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (H, W, 3), np.uint8)
    b = rng.integers(0, 256, (H, W, 3), np.uint8)
    m = rng.random((H, W)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(jops.mux_merge_ab(jnp.asarray(b), jnp.asarray(a),
                              jnp.asarray(m))),
        _np(tmux.mux_merge_ab(_t(b), _t(a), _t(m))))


def test_census_transform_9x7(images):
    rng = np.random.default_rng(5)
    for gray in (_np(tmux.mux_average(_t(images[0]))),
                 rng.integers(0, 256, (19, 29), np.uint8)):
        ref = _np(jops.census_transform_9x7(jnp.asarray(gray)))
        got = _np(tcost.census_transform_9x7(_t(gray)))
        np.testing.assert_array_equal(ref.astype(np.int64), got)
        a, b = ref[:-1], ref[1:]
        np.testing.assert_array_equal(
            _np(jops.hamming48(jnp.asarray(a), jnp.asarray(b))),
            _np(tcost.hamming48(_t(got[:-1]), _t(got[1:]))))


@pytest.mark.parametrize("eye", [0, 1])
@pytest.mark.parametrize("arm_params", [(6.0, 20.0, 9, 4),
                                        (6.0, 20.0, 34, 17)])
def test_cross_arms(images, eye, arm_params):
    img = images[eye]
    ref = jops.cross_arms(jnp.asarray(img), *arm_params)
    got = tcross.cross_arms(_t(img), *arm_params)
    np.testing.assert_array_equal(_np(ref), _np(got))


def test_dr_dcc(disps):
    dl, dr = disps
    ref = jops.dr_dcc(jnp.asarray(dl), jnp.asarray(dr), 1.0, num_disp=ND,
                      zero_disp=ZD)
    got = tdcc.dr_dcc(_t(dl), _t(dr), 1.0)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_dibr_occl_float_disparities(disps):
    """Occlusion hits on refined (float) disparities: trunc toward zero,
    negative values included."""
    rng = np.random.default_rng(8)
    dl = disps[0] + rng.random((H, W)).astype(np.float32) * 0.9
    dr = disps[1] - rng.random((H, W)).astype(np.float32) * 0.9
    ref = jops.dibr_occl(jnp.asarray(dl), jnp.asarray(dr), num_disp=ND,
                         zero_disp=ZD)
    got = tdibr.dibr_occl(_t(dl), _t(dr))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_dr_irv(images, disps):
    usd = 9
    arms = jops.cross_arms(jnp.asarray(images[0]), 6.0, 20.0, usd, 4)
    rng = np.random.default_rng(9)
    outl = (rng.random((H, W)) < 0.4).astype(np.uint8)
    ref = jops.dr_irv(jnp.asarray(disps[0]), jnp.asarray(outl), arms, 5,
                      0.4, ND, ZD, usd, 3)
    got = tirv.dr_irv(_t(disps[0]), _t(outl), _t(_np(arms)), 5, 0.4, ND,
                      ZD, usd, 3)
    np.testing.assert_array_equal(_np(ref[0]), _np(got[0]))
    np.testing.assert_array_equal(_np(ref[1]), _np(got[1]))


def test_filter_bilateral(disps):
    rng = np.random.default_rng(10)
    d = disps[0] + rng.random((H, W)).astype(np.float32) * 0.5
    ref = jops.filter_bilateral(jnp.asarray(d), 3, 5.0, 10.0, ND)
    got = tfilters.filter_bilateral(_t(d), 3, 5.0, 10.0)
    # f32 sums in another order (the port follows the band kernel's
    # dx-outer tap order) and exp rounding of XLA vs torch
    np.testing.assert_allclose(_np(ref), _np(got), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("radius", [1, 2])
def test_filter_bleed(radius):
    rng = np.random.default_rng(11 + radius)
    occ = (rng.random((H, W)) < 0.3).astype(np.uint8)
    np.testing.assert_array_equal(
        _np(jops.filter_bleed(jnp.asarray(occ), radius)),
        _np(tfilters.filter_bleed(_t(occ), radius)))


def test_dibr_feather_mask():
    rng = np.random.default_rng(12)
    m = (rng.random((H, W)) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        _np(jdibr.dibr_feather_mask(jnp.asarray(m), 10, 15.0)),
        _np(tdibr.dibr_feather_mask(_t(m), 10, 15.0)))


@pytest.mark.parametrize("shift", [0.25, -0.5, 0.857142865657806])
def test_dibr_backward_warp(images, disps, shift):
    rng = np.random.default_rng(13)
    d = disps[0] + rng.random((H, W)).astype(np.float32) * 0.9
    m = (rng.random((H, W)) > 0.2).astype(np.float32)
    ref = jops.dibr_backward_warp(jnp.asarray(images[0]), jnp.asarray(m),
                                  jnp.asarray(d), shift, ND, ZD)
    got = tdibr.dibr_backward_warp(_t(images[0]), _t(m), _t(d), shift)
    np.testing.assert_array_equal(_np(ref), _np(got))


def test_synthesize_views_and_interlace(images):
    """synthesize_views + mux_multiview on identical input disparities,
    against the JAX pair and against its fused band-engine chain (the JAX
    tests hold the two equal on such fractional disparities)."""
    l, r = images
    cfg = jconfig.PipelineConfig(num_rows=H, num_cols=W, num_rows_out=H,
                                 num_cols_out=W, num_disp=ND, zero_disp=ZD,
                                 num_views=8, engine="xla",
                                 bilateral_radius=2, feather_radius=3)
    rng = np.random.default_rng(14)
    dl = (rng.integers(-6, 6, (H, W)).astype(np.float32)
          + rng.random((H, W)).astype(np.float32) * 0.9)
    dr = (rng.integers(-6, 6, (H, W)).astype(np.float32)
          + rng.random((H, W)).astype(np.float32) * 0.9)
    args = [jnp.asarray(a) for a in (l, r, dl, dr)]
    views = jpipe.synthesize_views(*args, cfg)
    ref = _np(jops.mux_multiview(views, H, W, cfg.angle))
    # the port's band route (B12's view stack): the JAX pair's op order
    tcfg = tconfig.config_from_dict(dataclasses.asdict(cfg)).replace(
        engine="band")
    tviews = tpipe.synthesize_views(_t(l), _t(r), _t(dl), _t(dr), tcfg)
    np.testing.assert_array_equal(_np(views), _np(tviews))
    got = _np(tmux.mux_multiview(tviews, H, W, cfg.angle))
    np.testing.assert_array_equal(ref, got)
    fused = jpipe.synthesize_interlace(*args, cfg.replace(engine="band"))
    np.testing.assert_array_equal(_np(fused), got)


def test_synth_shifts_and_bounds():
    for v in (2, 4, 8, 16):
        assert tpipe._synth_shifts(v) == jpipe._synth_shifts(v)
    for kw in ({}, dict(num_rows_disp=8, num_cols_disp=8, disp_scale=0.5)):
        jc = jconfig.PipelineConfig(**kw)
        tc = tconfig.config_from_dict(dataclasses.asdict(jc))
        assert tpipe.synth_disp_bounds(tc) == jpipe.synth_disp_bounds(jc)


def test_stage_scope_names_without_timer():
    from stereo_to_multiview_tpu_torch.utils.profiling import stage_scope
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with stage_scope("stereo_core"):
            torch.ones(4).sum()
    assert any(e.key == "stereo_core" for e in prof.key_averages())
