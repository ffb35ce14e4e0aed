"""Configurations at the edges of the port's kernels, against the JAX
band engine on the CPU (its Pallas kernels in interpret mode): a
bilateral radius above 8 (where the band engine runs the XLA filter), a
num_disp that is no multiple of 4, and more than 32 intermediate views.

Held as `test_torch_pipeline.py` holds the main configuration: the
disparities before the bilateral filter and the labels exact, the final
disparities within float32 rounding of the bilateral's exp, the port's
synthesis on the JAX disparities exact against the JAX unfused synthesis,
and its own interlaced frame nearly identical to it.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.models import pipeline as jpipe
from stereo_to_multiview_tpu.ops.band import (
    band_stereo_core_chunked, dr_irv_band_chunked)
from stereo_to_multiview_tpu.ops.postkern import (
    cross_arms_kern_lr, dcc_occl_kern)

from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.models import pipeline as tpipe
from stereo_to_multiview_tpu_torch.ops import filters as tfilters
from stereo_to_multiview_tpu_torch.ops.mux import mux_multiview
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
H, W = 36, 52
CFG = JaxConfig(num_rows=H, num_cols=W, num_rows_out=H, num_cols_out=W,
                num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=8,
                irv_iterations=3, irv_thresh_s=5, bilateral_radius=2,
                feather_radius=3, engine="band")


@pytest.fixture(scope="module")
def bud_crop():
    l = read_bmp(os.path.join(DATA, "bud_2.bmp"))[100:172:2, 200:304:2]
    r = read_bmp(os.path.join(DATA, "bud_3.bmp"))[100:172:2, 200:304:2]
    return np.concatenate([l, r], axis=1)


@pytest.mark.parametrize("radius", [9, 10])
def test_filter_bilateral_above_radius_8_matches_xla_filter(radius):
    rng = np.random.default_rng(radius)
    d = (rng.integers(-6, 6, (H, W))
         + rng.random((H, W)) * 0.5).astype(np.float32)
    ref = jops.filter_bilateral(jnp.asarray(d), radius, 5.0, 10.0, 12)
    got = tfilters.filter_bilateral(torch.from_numpy(d), radius, 5.0, 10.0)
    # the XLA filter's tap order and constants; XLA's float32 exp and
    # torch's may still differ in the last ulp at some taps
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-6,
                               atol=1e-6)


def _jax_raw(l, r, cfg):
    """The JAX band engine's compute_disparities up to IRV."""
    arms_l, arms_r = cross_arms_kern_lr(l, r, cfg.ucd, cfg.lcd, cfg.usd,
                                        cfg.lsd, interpret=True)
    dl, dr = band_stereo_core_chunked(l, r, arms_l, arms_r, cfg, True)
    ol, orr = dcc_occl_kern(dl, dr, cfg.dcc_thresh, with_labels=True,
                            num_disp=cfg.num_disp, zero_disp=cfg.zero_disp,
                            interpret=True)
    (dl, ol), (dr, orr) = dr_irv_band_chunked(dl, ol, dr, orr, arms_l,
                                              arms_r, cfg, True)
    return dl, dr, ol, orr


@pytest.mark.parametrize("knob", [
    dict(bilateral_radius=10), dict(num_disp=10, zero_disp=5),
    dict(num_views=40)], ids=["bilateral_radius=10", "num_disp=10",
                              "num_views=40"])
def test_process_frame_at_config_limits_matches_jax_band(bud_crop, knob):
    cfg = CFG.replace(**knob)
    l, r = jops.demux_sbs(jnp.asarray(bud_crop))
    tcfg = config_from_dict(dataclasses.asdict(cfg))

    # before the bilateral filter: exact
    ref_raw = [np.asarray(x) for x in _jax_raw(l, r, cfg)]
    tl, tr = (torch.from_numpy(np.array(x)) for x in (l, r))
    got_raw = [x.numpy() for x in tpipe.raw_disparities(tl, tr, tcfg)]
    for a, b in zip(ref_raw, got_raw):
        np.testing.assert_array_equal(a, b)

    ref_dl, ref_dr, ref_il = (np.asarray(x) for x in
                              jpipe.process_frame(jnp.asarray(bud_crop), cfg))
    dl, dr, il = (x.numpy() for x in
                  tpipe.process_frame(bud_crop, tcfg, device="cpu"))
    assert il.shape == (H, W, 3) and il.dtype == np.uint8
    # float32 rounding of the bilateral filter (exp)
    np.testing.assert_allclose(dl, ref_dl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dr, ref_dr, rtol=0, atol=1e-5)

    # the synthesis on the JAX disparities: exact against the JAX unfused
    # synthesis, every one of the views
    views = jpipe.synthesize_views(l, r, jnp.asarray(ref_dl),
                                   jnp.asarray(ref_dr),
                                   cfg.replace(engine="xla"))
    tviews = tpipe.synthesize_views(tl, tr, torch.from_numpy(ref_dl.copy()),
                                    torch.from_numpy(ref_dr.copy()), tcfg)
    assert tviews.shape[0] == cfg.num_views
    np.testing.assert_array_equal(tviews.numpy(), np.asarray(views))
    unfused = np.asarray(jops.mux_multiview(views, H, W, cfg.angle))
    np.testing.assert_array_equal(
        mux_multiview(tviews, H, W, cfg.angle).numpy(), unfused)
    # the port's own frame, from its own disparities (ulps apart)
    assert np.mean(il == unfused) >= 0.999
    # against the JAX band output: +-1 only where the JAX band path's
    # contracted warp departs from its own unfused synthesis
    diff = il != ref_il
    assert np.all(np.abs(il.astype(int) - ref_il)[diff] == 1)
    assert np.all((unfused != ref_il)[diff])
