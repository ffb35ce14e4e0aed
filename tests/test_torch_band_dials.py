"""The band engine's dials, `band_qscale` and `band_lossy_wta`, against
the JAX package with engine="band", its Pallas kernels in interpret mode
on the CPU.  Their cost entry, `ci_adcensus_kern_xm`, is held in
tests/test_torch_cost_xm.py.

band_qscale scales the quantized cost (int16 costs above 127.5) and with
it the rescale shifts; the aggregation stays exact integer arithmetic,
so everything before the bilateral filter is held exact.
band_lossy_wta rounds each pass-4 input to bf16 before the WTA's window
sums; those sums stay exact integers below 2^24, so the lossy WTA is
held exact too.  `process_frame` with each dial is held against the JAX
band engine in tests/test_torch_dials.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.ops import band as jband
from stereo_to_multiview_tpu.ops.cost import ci_adcensus_hwd

from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.ops import band as tband
from stereo_to_multiview_tpu_torch.ops import costkern as tck
from stereo_to_multiview_tpu_torch.ops.cross import (
    UP, DOWN, LEFT, RIGHT, cross_arms)

torch.set_num_threads(1)

H, W = 36, 52
CFG = JaxConfig(num_rows=H, num_cols=W, num_rows_out=H, num_cols_out=W,
                num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=8,
                irv_iterations=3, irv_thresh_s=5, bilateral_radius=2,
                feather_radius=3, engine="band")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- the rescale shifts and the cost's dtype -----------------------------

@pytest.mark.parametrize("digits", [1, 2, 3])
@pytest.mark.parametrize("qscale", [64.0, 127.0, 255.0, 510.0, 1020.0,
                                    4000.0])
def test_agg_rescale_shifts_at_qscale(qscale, digits):
    for usd in (5, 34, 64):
        assert tband.agg_rescale_shifts(usd, digits, qscale) == \
            jband.agg_rescale_shifts(usd, digits, qscale)
        assert tband.agg_cost_scale(usd, digits, qscale) == \
            jband.agg_cost_scale(usd, digits, qscale)


def test_cost_dtype_follows_the_jax_rule():
    """u8 while round(2 * qscale) <= 255, int16 above up to the int16
    ceiling (JAX's cast wraps beyond it; the port raises)."""
    for q, dt in ((64.0, torch.uint8), (127.0, torch.uint8),
                  (127.6, torch.uint8), (128.0, torch.int16),
                  (510.0, torch.int16), (16383.0, torch.int16)):
        assert tck.cost_dtype(q) == dt
    assert tck.cost_dtype(510.0, quant=False) == torch.float32
    assert tband.agg_rescale_shifts(34, 1, 510.0)[0] == 9
    for q in (16384.0, 0.0):
        with pytest.raises(ValueError, match="int16"):
            tck.cost_dtype(q)


# ---- the aggregation -----------------------------------------------------

def _agg_case(usd, qscale, seed, h=40, w=48, nd=8):
    """Random quantized costs up to round(2 * qscale) (a tied plane
    included) and arms that stop at the border."""
    rng = np.random.default_rng(seed)
    qmax = int(round(2 * qscale))
    dtype = np.uint8 if qmax <= 255 else np.int16
    cost = rng.integers(0, qmax + 1, (h, w, nd)).astype(dtype)
    cost[:, :, 5] = cost[:, :, 1]
    a = rng.integers(0, usd + 1, (4, h, w))
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    arms = np.stack([np.minimum(a[UP], y), np.minimum(a[DOWN], h - 1 - y),
                     np.minimum(a[LEFT], x),
                     np.minimum(a[RIGHT], w - 1 - x)]).astype(np.int32)
    return cost, arms


@pytest.mark.parametrize("digits", [2, 3])
@pytest.mark.parametrize("wta", [True, False])
@pytest.mark.parametrize("qscale", [64.0, 510.0, 1020.0])
def test_band_aggregate_q_qscale_matches_jax(qscale, wta, digits):
    """The four passes on u8 (qscale 64) and int16 costs, with and
    without the WTA: exact."""
    usd = 5 if digits == 2 else 34
    cost, arms = _agg_case(usd, qscale, int(qscale) + digits)
    zd = 3 if wta else None
    ref = jband.band_aggregate_q(jnp.asarray(cost), jnp.asarray(arms), usd,
                                 zero_disp=zd, digits=digits, qscale=qscale,
                                 interpret=True)
    got = tband.band_aggregate_q(_t(cost), _t(arms), usd, zd, digits, qscale)
    np.testing.assert_array_equal(_np(ref).astype(np.int64),
                                  _np(got).astype(np.int64))


@pytest.mark.parametrize("digits,qscale", [(1, 127.0), (2, 127.0),
                                           (3, 127.0), (3, 510.0)])
def test_band_aggregate_q_lossy_wta_matches_jax(digits, qscale):
    """band_lossy_wta: pass 4 rounds each input to bf16 before the window
    sums (JAX: one bf16 dot): exact, ties to the first minimum."""
    usd = 5
    cost, arms = _agg_case(usd, qscale, 40 + digits)
    ref = jband.band_aggregate_q(jnp.asarray(cost), jnp.asarray(arms), usd,
                                 zero_disp=3, digits=digits, qscale=qscale,
                                 lossy_wta=True, interpret=True)
    got = tband.band_aggregate_q(_t(cost), _t(arms), usd, 3, digits, qscale,
                                 lossy_wta=True)
    np.testing.assert_array_equal(_np(ref), _np(got))
    if digits == 3:
        # the inputs of pass 4 exceed bf16's 8 bits: the rounding acts
        s1, s2, s3 = tband.agg_rescale_shifts(usd, digits, qscale)
        a = tband.h_pass_sum(_t(cost), _t(arms[LEFT]), _t(arms[RIGHT]), s1,
                             usd)
        a = tband.vv_pass(a, _t(arms[UP]), _t(arms[DOWN]), s2, s3, usd)
        assert not torch.equal(tband.round_bf16(a), a)


# ---- the stereo core: twins of the JAX dial tests ------------------------

def _arms(stereo_pair):
    tl, tr = (_t(x) for x in stereo_pair)
    return tl, tr, (cross_arms(tl, 6.0, 20.0, 5, 2),
                    cross_arms(tr, 6.0, 20.0, 5, 2))


def _jax_core(stereo_pair, cfg):
    l, r = (jnp.asarray(x) for x in stereo_pair)
    return jband.band_stereo_core_chunked(
        l, r, jops.cross_arms(l, 6.0, 20.0, 5, 2),
        jops.cross_arms(r, 6.0, 20.0, 5, 2), cfg, interpret=True)


def test_band_qscale_dial(stereo_pair):
    """Twin of tests/test_band.py::test_band_qscale_dial: at qscale 510
    the core (int16 costs) is exact under row chunking and equal to the
    JAX core, and tracks the float32 golden aggregation at least as well
    as at 127; at digits=3 no worse than the best 2-digit run."""
    tl, tr, arms = _arms(stereo_pair)
    base = config_from_dict(dataclasses.asdict(CFG))
    l, r = (jnp.asarray(x) for x in stereo_pair)
    cl, _ = ci_adcensus_hwd(l, r, 10.0, 30.0, 12, 6)
    gl = _np(jops.dc_wta(jnp.moveaxis(jops.cross_aggregate(
        jnp.moveaxis(cl, 2, 0), jops.cross_arms(l, 6.0, 20.0, 5, 2),
        max_arm=5), 0, 2).transpose(2, 0, 1), 6))
    outs = {}
    for q, digits in ((127.0, 2), (510.0, 2), (510.0, 3)):
        cfg = base.replace(band_qscale=q, band_digits=digits)
        dl, dr = tband.band_stereo_core_chunked(tl, tr, *arms, cfg)
        dl_c, dr_c = tband.band_stereo_core_chunked(
            tl, tr, *arms, cfg.replace(band_row_chunk=8))
        assert torch.equal(dl, dl_c) and torch.equal(dr, dr_c)
        if q == 510.0:
            ref = _jax_core(stereo_pair, CFG.replace(band_qscale=q,
                                                     band_digits=digits))
            for a, b in zip(ref, (dl, dr)):
                np.testing.assert_array_equal(_np(a), _np(b))
        outs[(q, digits)] = np.mean(np.abs(_np(dl) - gl) > 1.0)
    assert outs[(510.0, 2)] <= outs[(127.0, 2)]
    assert outs[(510.0, 3)] <= min(outs[(127.0, 2)], outs[(510.0, 2)])


def test_band_lossy_wta_dial(stereo_pair):
    """Twin of tests/test_band.py::test_band_lossy_wta_dial: the lossy WTA
    flips few disparities against the exact one, stays exact under row
    chunking, and equals the JAX core."""
    tl, tr, arms = _arms(stereo_pair)
    cfg = config_from_dict(dataclasses.asdict(CFG.replace(band_digits=3)))
    exact = tband.band_stereo_core_chunked(tl, tr, *arms, cfg)
    lossy_cfg = cfg.replace(band_lossy_wta=True)
    dl, dr = tband.band_stereo_core_chunked(tl, tr, *arms, lossy_cfg)
    flips = float((dl != exact[0]).float().mean())
    assert flips < 0.02, flips
    dl_c, dr_c = tband.band_stereo_core_chunked(
        tl, tr, *arms, lossy_cfg.replace(band_row_chunk=8))
    assert torch.equal(dl, dl_c) and torch.equal(dr, dr_c)
    ref = _jax_core(stereo_pair, CFG.replace(band_digits=3,
                                             band_lossy_wta=True))
    for a, b in zip(ref, (dl, dr)):
        np.testing.assert_array_equal(_np(a), _np(b))
