"""The optional-stage paths as a whole: the port's process_frame with
the optional stages on, bleed radius 2, a resampled output, two views
only, and process_frame_lowres (device="cpu") against the JAX package
with engine="band", its Pallas kernels in interpret mode.

Held exact where the scanline optimisation is off: the disparities
before the median and bilateral filters and the outlier labels.  With it
on, the JAX band path runs its TPU kernel, whose forward direction
starts from a column of zeros where the scan (which the port and the
golden follow) starts from the column's own cost (see
tests/test_torch_hslo.py), so a few disparities may differ; the bound is
stated at the assert.  Final disparities differ by float32 rounding of
the bilateral's exp.  The port's synthesis run on the JAX disparities is
held exact against the JAX package's unfused synthesis
(synthesize_views with engine="xla" + mux_multiview).
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import config as jconfig
from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.models import pipeline as jpipe

from stereo_to_multiview_tpu_torch import config as tconfig
from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.models import pipeline as tpipe
from stereo_to_multiview_tpu_torch.ops.mux import mux_multiview
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
H, W = 36, 52
BASE = JaxConfig(num_rows=H, num_cols=W, num_rows_out=H, num_cols_out=W,
                 num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=8,
                 irv_iterations=3, irv_thresh_s=5, bilateral_radius=2,
                 feather_radius=3, engine="band")
CONFIGS = {
    "hslo_median_resampled": BASE.replace(
        use_hslo=True, use_median=True, num_views=6, num_rows_out=45,
        num_cols_out=64, hslo_H1=8.0, hslo_H2=24.0),
    "bleed_radius_2": BASE.replace(bleed_radius=2),
    "lowres": BASE.replace(num_rows_disp=18, num_cols_disp=26,
                           disp_scale=0.5, num_disp=8, zero_disp=4),
    "two_views": BASE.replace(num_views=2),
}


@pytest.fixture(scope="module")
def sbs():
    l = read_bmp(os.path.join(DATA, "bud_2.bmp"))[100:172:2, 200:304:2]
    r = read_bmp(os.path.join(DATA, "bud_3.bmp"))[100:172:2, 200:304:2]
    return np.concatenate([l, r], axis=1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_optional_paths_match_jax_band(sbs, name):
    cfg = CONFIGS[name]
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    l, r = jops.demux_sbs(jnp.asarray(sbs))
    tl, tr = (_t(x) for x in (l, r))
    if cfg.lowres:
        jentry, tentry = jpipe.process_frame_lowres, tpipe.process_frame_lowres
        lo = [jops.tx_scale_bilinear(x, cfg.num_rows_disp, cfg.num_cols_disp)
              for x in (l, r)]
        tlo = [_t(x) for x in lo]
    else:
        jentry, tentry = jpipe.process_frame, tpipe.process_frame
        lo, tlo = [l, r], [tl, tr]

    # before the median and bilateral filters: the JAX pipeline with both
    # switched off (radius 0 makes the bilateral the identity)
    ref_raw = [np.asarray(x) for x in jpipe.compute_disparities(
        lo[0], lo[1], cfg.replace(use_median=False, bilateral_radius=0))]
    got_raw = [x.numpy() for x in tpipe.raw_disparities(tlo[0], tlo[1], tcfg)]
    if cfg.use_hslo:
        # the TPU kernel's zero first column (module docstring): JAX bounds
        # its own kernel-vs-scan mismatch at 1e-3 of the pixels, and dcc
        # and IRV can hand a differing pixel on to a neighbour.  (On this
        # frame the two agree at every pixel.)
        for a, b in zip(ref_raw, got_raw):
            assert np.mean(a != b) < 2e-3
    else:
        for a, b in zip(ref_raw, got_raw):
            np.testing.assert_array_equal(a, b)

    ref_dl, ref_dr, ref_il = (np.asarray(x) for x in
                              jentry(jnp.asarray(sbs), cfg))
    dl, dr, il = (x.numpy() for x in tentry(sbs, tcfg, device="cpu"))
    assert dl.shape == (H, W) and dl.dtype == np.float32
    assert il.shape == (cfg.num_rows_out, cfg.num_cols_out, 3)
    assert il.dtype == np.uint8
    if cfg.use_hslo:
        # as above, smoothed over the bilateral's window
        assert np.mean(np.abs(dl - ref_dl) > 1e-5) < 1e-2
        assert np.mean(np.abs(dr - ref_dr) > 1e-5) < 1e-2
    else:
        # float32 rounding of the bilateral filter (exp and sum order) and,
        # on the lowres path, of the upscale's lerps times 1 / disp_scale
        np.testing.assert_allclose(dl, ref_dl, rtol=0, atol=1e-5)
        np.testing.assert_allclose(dr, ref_dr, rtol=0, atol=1e-5)

    # the synthesis on the JAX disparities: exact against the JAX unfused
    # synthesis, whichever route the port takes
    views = jpipe.synthesize_views(l, r, jnp.asarray(ref_dl),
                                   jnp.asarray(ref_dr),
                                   cfg.replace(engine="xla"))
    unfused = np.asarray(jops.mux_multiview(views, cfg.num_rows_out,
                                            cfg.num_cols_out, cfg.angle))
    tviews = tpipe.synthesize_views(tl, tr, _t(ref_dl), _t(ref_dr), tcfg)
    assert tviews.shape == (cfg.num_views, H, W, 3)
    got = mux_multiview(tviews, cfg.num_rows_out, cfg.num_cols_out,
                        cfg.angle).numpy()
    np.testing.assert_array_equal(got, unfused)
    # ... and the one synthesis route of process_frame (B12's interlace
    # mode; its plain version on the CPU) gives the same frame
    np.testing.assert_array_equal(tpipe.synthesize_interlace(
        tl, tr, _t(ref_dl), _t(ref_dr), tcfg).numpy(), unfused)
    # the port's own frame, from its own disparities
    share = 0.99 if cfg.use_hslo else 0.999
    assert np.mean(il == unfused) >= share


def test_process_frame_lowres_needs_lowres_config():
    cfg = config_from_dict(dataclasses.asdict(BASE))
    with pytest.raises(ValueError, match="num_rows_disp"):
        tpipe.process_frame_lowres(np.zeros(cfg.sbs_shape, np.uint8), cfg,
                                   device="cpu")


def test_synth_disp_bounds_cover_the_lowres_disparities(sbs):
    tcfg = config_from_dict(dataclasses.asdict(CONFIGS["lowres"]))
    assert tpipe.synth_disp_bounds(tcfg) == jpipe.synth_disp_bounds(
        CONFIGS["lowres"]) == (15, 8)
    dl, dr, _ = tpipe.process_frame_lowres(sbs, tcfg, device="cpu")
    for d in (dl, dr):
        assert float(d.min()) >= -8 and float(d.max()) < 15 - 8


def test_row_chunks_stay_exact_with_hslo(sbs):
    cfg = config_from_dict(dataclasses.asdict(
        BASE.replace(use_hslo=True, hslo_H1=8.0, hslo_H2=24.0)))
    whole = tpipe.process_frame(sbs, cfg, device="cpu")
    chunked = tpipe.process_frame(sbs, cfg.replace(band_row_chunk=8),
                                  device="cpu")
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("knob", [
    dict(engine="xla"), dict(engine="xla", band_qscale=255.0),
    dict(engine="xla", band_lossy_wta=True)])
def test_check_ported_still_refuses(knob):
    """Nothing is refused now: the XLA engine (ROADMAP A.4) is accepted,
    whatever the band engine's dials say; only an xla_agg_qscale whose
    prefix sums would pass 2^24 at the geometry raises ValueError."""
    cfg = tconfig.PipelineConfig(**{**dict(usd=2, lsd=1), **knob})
    tpipe.check_ported(cfg)
    tpipe.check_ported(cfg.replace(xla_agg_qscale=8.0))
    with pytest.raises(ValueError, match="xla_agg_qscale"):
        tpipe.check_ported(cfg.replace(xla_agg_qscale=1000.0))


@pytest.mark.parametrize("knob", [
    dict(use_hslo=True), dict(use_median=True), dict(bleed_radius=3),
    dict(num_rows_disp=4, num_cols_disp=8), dict(num_cols_out=32),
    dict(num_views=2), dict(band_digits=1), dict(band_digits=2),
    dict(irv_row_chunk=8), dict(band_row_chunk=8, irv_row_chunk=16),
    dict(band_qscale=64.0), dict(band_qscale=255.0), dict(band_qscale=510.0),
    dict(band_qscale=1020.0), dict(band_qscale=16383.0),
    dict(band_lossy_wta=True), dict(band_lossy_wta=True, band_digits=1)])
def test_check_ported_accepts_the_optional_stages(knob):
    tpipe.check_ported(tconfig.PipelineConfig(**knob))


def test_config_round_trips_lowres_fields_and_presets():
    jcfg = CONFIGS["lowres"]
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.lowres and (tcfg.num_rows_disp, tcfg.num_cols_disp) == (18,
                                                                         26)
    hslo_4k = jconfig.HD1080_D128.replace(
        use_hslo=True, use_median=True, num_rows_out=2160, num_cols_out=3840)
    assert dataclasses.asdict(tconfig.HD1080_D128_HSLO_4K) == \
        dataclasses.asdict(hslo_4k)
    lowres = JaxConfig(
        num_rows=1080, num_cols=1920, num_rows_out=1080, num_cols_out=1920,
        num_rows_disp=540, num_cols_disp=960, disp_scale=0.5, num_disp=64,
        zero_disp=32, num_views=8)
    assert dataclasses.asdict(tconfig.HD1080_LOWRES) == \
        dataclasses.asdict(lowres)
    assert tpipe.synth_disp_bounds(tconfig.HD1080_LOWRES) == (127, 64)
