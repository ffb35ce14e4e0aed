"""The whole slice: the port's process_frame (device="cpu") against JAX
process_frame(engine="band") with its Pallas kernels in interpret mode.

Held exact: the disparities before the bilateral filter and the outlier
labels.  The final disparities differ by float32 rounding only (the
bilateral's exp: XLA's differs from torch's by an ulp at some taps).
The port's synthesis run on the JAX disparities is held exact against
the JAX package's unfused synthesis (synthesize_views + mux_multiview).
The port's own interlaced frame, made from its own disparities, may
differ from that at a few subpixels: an ulp in a disparity can move a
warp sample across a truncation boundary.  Against the JAX band output
it may differ by exactly 1 where the JAX band path's own fused warp
kernel departs from that unfused synthesis (its lerp w0*g + w1*f is
compiled with a contracted multiply-add; the port and the unfused JAX
path round both products).
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
from stereo_to_multiview_tpu_torch.ops.mux import mux_multiview
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
H, W = 36, 52
CFG = JaxConfig(num_rows=H, num_cols=W, num_rows_out=H, num_cols_out=W,
                num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=8,
                irv_iterations=3, irv_thresh_s=5, bilateral_radius=2,
                feather_radius=3, engine="band")


def _jax_raw(l, r, cfg):
    """The JAX band engine's compute_disparities up to IRV (its own
    kernels: arms, stereo core, dcc labels, chunked IRV with early stop)."""
    arms_l, arms_r = cross_arms_kern_lr(l, r, cfg.ucd, cfg.lcd, cfg.usd,
                                        cfg.lsd, interpret=True)
    dl, dr = band_stereo_core_chunked(l, r, arms_l, arms_r, cfg, True)
    ol, orr = dcc_occl_kern(dl, dr, cfg.dcc_thresh, with_labels=True,
                            num_disp=cfg.num_disp, zero_disp=cfg.zero_disp,
                            interpret=True)
    (dl, ol), (dr, orr) = dr_irv_band_chunked(dl, ol, dr, orr, arms_l,
                                              arms_r, cfg, True)
    return dl, dr, ol, orr


@pytest.fixture(scope="module")
def frames(stereo_pair):
    bud_l = read_bmp(os.path.join(DATA, "bud_2.bmp"))[100:172:2, 200:304:2]
    bud_r = read_bmp(os.path.join(DATA, "bud_3.bmp"))[100:172:2, 200:304:2]
    return {"stereo_pair": np.concatenate(stereo_pair, axis=1),
            "bud_crop": np.concatenate([bud_l, bud_r], axis=1)}


@pytest.mark.parametrize("name", ["stereo_pair", "bud_crop"])
def test_process_frame_matches_jax_band(frames, name):
    sbs = frames[name]
    l, r = jops.demux_sbs(jnp.asarray(sbs))
    tcfg = config_from_dict(dataclasses.asdict(CFG))

    # disparities before the bilateral filter, and the labels: exact
    ref_raw = [np.asarray(x) for x in _jax_raw(l, r, CFG)]
    tl, tr = (torch.from_numpy(np.array(x)) for x in (l, r))
    got_raw = [x.numpy() for x in tpipe.raw_disparities(tl, tr, tcfg)]
    for a, b in zip(ref_raw, got_raw):
        np.testing.assert_array_equal(a, b)

    ref_dl, ref_dr, ref_il = (np.asarray(x) for x in
                              jpipe.process_frame(jnp.asarray(sbs), CFG))
    dl, dr, il = (x.numpy() for x in
                  tpipe.process_frame(sbs, tcfg, device="cpu"))
    assert dl.shape == (H, W) and dl.dtype == np.float32
    assert il.shape == (H, W, 3) and il.dtype == np.uint8
    # float32 rounding of the bilateral filter (exp and sum order)
    np.testing.assert_allclose(dl, ref_dl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dr, ref_dr, rtol=0, atol=1e-5)

    # the synthesis: on the JAX disparities, exact against the JAX
    # unfused synthesis
    views = jpipe.synthesize_views(l, r, jnp.asarray(ref_dl),
                                   jnp.asarray(ref_dr),
                                   CFG.replace(engine="xla"))
    unfused = np.asarray(jops.mux_multiview(views, H, W, CFG.angle))
    tviews = tpipe.synthesize_views(tl, tr, torch.from_numpy(ref_dl.copy()),
                                    torch.from_numpy(ref_dr.copy()), tcfg)
    np.testing.assert_array_equal(
        mux_multiview(tviews, H, W, CFG.angle).numpy(), unfused)
    # the port's own frame: its disparities differ from JAX's by ulps,
    # which can move a warp sample across a truncation boundary
    assert np.mean(il == unfused) >= 0.999
    # against the JAX band output: every difference is +-1 and sits where
    # the JAX band path departs from its own unfused synthesis (the
    # contracted multiply-add in its warp kernel, see module docstring)
    diff = il != ref_il
    assert np.all(np.abs(il.astype(int) - ref_il)[diff] == 1)
    assert np.all((unfused != ref_il)[diff])
    if name == "bud_crop":
        # real texture: such places are rare (the smoothed-noise
        # stereo_pair has many equal neighbours, where they cluster)
        assert np.mean(il == ref_il) >= 0.999
