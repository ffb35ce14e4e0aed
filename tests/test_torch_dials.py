"""The `band_digits` dial (1 and 2) of the lane-major core, the
row-chunked IRV (`irv_row_chunk`) and the `UHD4K_16V` preset, against the
JAX package with engine="band", its Pallas kernels in interpret mode on
the CPU; and whole frames at the dials `band_qscale` and `band_lossy_wta`
(their kernels in tests/test_torch_band_dials.py).

The dial only changes the rescale shifts of an exact integer aggregation,
and a chunked IRV round reads the same rows as the whole-frame round, so
everything before the bilateral filter is held exact; the final
disparities differ by float32 rounding of the bilateral's exp, as in
tests/test_torch_pipeline.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import config as jconfig
from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.models import pipeline as jpipe
from stereo_to_multiview_tpu.ops import band as jband
from stereo_to_multiview_tpu.ops.postkern import (
    cross_arms_kern_lr, dcc_occl_kern)

from stereo_to_multiview_tpu_torch import config as tconfig
from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.models import pipeline as tpipe
from stereo_to_multiview_tpu_torch.ops import band as tband
from stereo_to_multiview_tpu_torch.ops import irv as tirv
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


# ---- band_digits --------------------------------------------------------

@pytest.mark.parametrize("usd,digits,shifts", [
    (34, 1, (7, 6, 6)), (34, 2, (0, 6, 6)), (34, 3, (0, 3, 6)),
    (5, 1, (4, 3, 4)), (5, 2, (0, 0, 4)), (5, 3, (0, 0, 0))])
def test_agg_rescale_shifts_of_the_dial(usd, digits, shifts):
    assert tband.agg_rescale_shifts(usd, digits) == shifts
    assert jband.agg_rescale_shifts(usd, digits) == shifts
    assert tband.agg_cost_scale(usd, digits) == 127.0 / 2 ** sum(shifts)
    assert tband.agg_cost_scale(usd, digits) == jband.agg_cost_scale(
        usd, digits)


@pytest.mark.parametrize("wta", [True, False])
@pytest.mark.parametrize("digits", [1, 2])
@pytest.mark.parametrize("usd", [5, 34])
def test_band_aggregate_q_digits_matches_jax(usd, digits, wta):
    """The four passes at the dial's shifts, with and without the WTA,
    against the JAX aggregation (int16 volumes between its passes)."""
    rng = np.random.default_rng(10 * usd + digits)
    h, w, nd = 40, 48, 8
    cost = rng.integers(0, 255, (h, w, nd)).astype(np.uint8)
    cost[:, :, 5] = cost[:, :, 1]
    a = rng.integers(0, usd + 1, (4, h, w))
    y, x = np.arange(h)[:, None], np.arange(w)[None, :]
    arms = np.stack([np.minimum(a[UP], y), np.minimum(a[DOWN], h - 1 - y),
                     np.minimum(a[LEFT], x),
                     np.minimum(a[RIGHT], w - 1 - x)]).astype(np.int32)
    zd = 3 if wta else None
    ref = jband.band_aggregate_q(jnp.asarray(cost), jnp.asarray(arms), usd,
                                 zero_disp=zd, digits=digits, interpret=True)
    got = tband.band_aggregate_q(_t(cost), _t(arms), usd, zd, digits=digits)
    np.testing.assert_array_equal(_np(ref).astype(np.int64),
                                  _np(got).astype(np.int64))


def test_band_aggregate_q_refuses_other_dials():
    cost = torch.zeros((4, 8, 4), dtype=torch.uint8)
    arms = torch.zeros((4, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="band_digits"):
        tband.band_aggregate_q(cost, arms, 2, 1, digits=4)
    with pytest.raises(ValueError, match="band_digits"):
        tpipe.check_ported(tconfig.PipelineConfig(band_digits=0))
    # the qscale and lossy-WTA dials are ported, and so is the XLA
    # engine, which never reads the band engine's dials; only a qscale
    # whose costs would not fit int16 is refused
    for knobs in (dict(band_qscale=255.0), dict(band_qscale=4000.0),
                  dict(band_lossy_wta=True), dict(engine="xla"),
                  dict(engine="xla", band_digits=0)):
        tpipe.check_ported(tconfig.PipelineConfig(**knobs))
    with pytest.raises(ValueError, match="int16"):
        tpipe.check_ported(tconfig.PipelineConfig(band_qscale=16384.0))


@pytest.mark.parametrize("row_chunk", [0, 8])
@pytest.mark.parametrize("digits", [1, 2])
def test_band_stereo_core_chunked_digits(stereo_pair, digits, row_chunk):
    left, right = stereo_pair
    cfg = CFG.replace(band_digits=digits, band_row_chunk=row_chunk)
    l, r = jnp.asarray(left), jnp.asarray(right)
    ref = jband.band_stereo_core_chunked(
        l, r, jops.cross_arms(l, 6.0, 20.0, 5, 2),
        jops.cross_arms(r, 6.0, 20.0, 5, 2), cfg, interpret=True)
    tl, tr = _t(left), _t(right)
    got = tband.band_stereo_core_chunked(
        tl, tr, cross_arms(tl, 6.0, 20.0, 5, 2),
        cross_arms(tr, 6.0, 20.0, 5, 2),
        config_from_dict(dataclasses.asdict(cfg)))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))


def _jax_raw(l, r, cfg):
    """The JAX band engine's compute_disparities up to IRV."""
    arms_l, arms_r = cross_arms_kern_lr(l, r, cfg.ucd, cfg.lcd, cfg.usd,
                                        cfg.lsd, interpret=True)
    dl, dr = jband.band_stereo_core_chunked(l, r, arms_l, arms_r, cfg, True)
    ol, orr = dcc_occl_kern(dl, dr, cfg.dcc_thresh, with_labels=True,
                            num_disp=cfg.num_disp, zero_disp=cfg.zero_disp,
                            interpret=True)
    (dl, ol), (dr, orr) = jband.dr_irv_band_chunked(dl, ol, dr, orr, arms_l,
                                                    arms_r, cfg, True)
    return dl, dr, ol, orr


@pytest.mark.parametrize("knobs", [
    dict(band_digits=1), dict(band_digits=2),
    dict(band_digits=2, band_row_chunk=8, irv_row_chunk=8),
    dict(band_qscale=510.0), dict(band_qscale=64.0),
    dict(band_lossy_wta=True), dict(band_lossy_wta=True, band_digits=1)],
    ids=["digits1", "digits2", "digits2_chunked", "qscale510", "qscale64",
         "lossy", "lossy_digits1"])
def test_process_frame_dials_match_jax_band(stereo_pair, knobs):
    cfg = CFG.replace(**knobs)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    sbs = np.concatenate(stereo_pair, axis=1)
    l, r = jops.demux_sbs(jnp.asarray(sbs))
    ref_raw = [np.asarray(x) for x in _jax_raw(l, r, cfg)]
    got_raw = [x.numpy() for x in tpipe.raw_disparities(_t(l), _t(r), tcfg)]
    for a, b in zip(ref_raw, got_raw):
        np.testing.assert_array_equal(a, b)
    ref_dl, ref_dr, _ = (np.asarray(x) for x in
                         jpipe.process_frame(jnp.asarray(sbs), cfg))
    dl, dr, il = (x.numpy() for x in
                  tpipe.process_frame(sbs, tcfg, device="cpu"))
    # float32 rounding of the bilateral filter (exp and sum order)
    np.testing.assert_allclose(dl, ref_dl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dr, ref_dr, rtol=0, atol=1e-5)
    assert il.shape == (H, W, 3) and il.dtype == np.uint8


def test_the_dial_changes_the_aggregate(stereo_pair):
    """digits=1 rounds away bits that digits=3 keeps: on this pair some
    WTA disparities differ, so the tests above do not compare one path
    with itself."""
    tl, tr = (_t(x) for x in stereo_pair)
    arms = (cross_arms(tl, 6.0, 20.0, 5, 2), cross_arms(tr, 6.0, 20.0, 5, 2))
    base = config_from_dict(dataclasses.asdict(CFG))
    d3 = tband.band_stereo_core_chunked(tl, tr, *arms, base)
    d1 = tband.band_stereo_core_chunked(tl, tr, *arms,
                                        base.replace(band_digits=1))
    assert not torch.equal(d3[0], d1[0]) or not torch.equal(d3[1], d1[1])


# ---- irv_row_chunk ------------------------------------------------------

def _irv_case(stereo_pair, sparse):
    h, w = stereo_pair[0].shape[:2]
    rng = np.random.default_rng(5)
    arms = [np.asarray(jops.cross_arms(jnp.asarray(img), 6.0, 20.0, 5, 2))
            for img in stereo_pair]
    disp = [rng.integers(-6, 6, (h, w)).astype(np.float32) for _ in range(2)]
    if not sparse:
        outl = [(rng.random((h, w)) < 0.4).astype(np.uint8)
                for _ in range(2)]
        return arms, disp, outl, dict(irv_iterations=2, irv_thresh_s=5,
                                      irv_thresh_h=0.4)
    # sparse outliers over many rounds: a round-k fill enables a
    # round-k+1 fill next door, across chunk borders
    outl = [np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)]
    outl[0][h // 2, 4:min(w, 60)] = 1
    outl[0][2, 2] = 1
    outl[1][h // 3, 10:min(w, 40)] = 1
    return arms, disp, outl, dict(irv_iterations=4, irv_thresh_s=2,
                                  irv_thresh_h=0.1)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_irv_row_chunk_matches_whole_frame_and_jax(stereo_pair, sparse):
    arms, disp, outl, knobs = _irv_case(stereo_pair, sparse)
    h, w = disp[0].shape
    cfg = JaxConfig(num_rows=h, num_cols=w, num_disp=12, zero_disp=6, usd=5,
                    lsd=2, irv_row_chunk=8, **knobs)
    ref = jband.dr_irv_band_chunked(*(jnp.asarray(a) for a in (
        disp[0], outl[0], disp[1], outl[1], arms[0], arms[1])), cfg, True)
    for eye in range(2):
        args = (_t(disp[eye]), _t(outl[eye]), _t(arms[eye]),
                cfg.irv_thresh_s, cfg.irv_thresh_h, 12, 6, 5,
                cfg.irv_iterations)
        fixed = tirv.dr_irv(*args)
        whole = tirv.dr_irv_early_stop(*args)
        rounds = []
        chunked = tirv.dr_irv_early_stop(*args, rounds, row_chunk=8)
        assert int(fixed[1].sum()) < int(outl[eye].sum())   # votes accepted
        assert 1 <= rounds[0] <= cfg.irv_iterations
        for a, b, c, d in zip(fixed, whole, chunked, ref[eye]):
            assert torch.equal(a, b) and torch.equal(a, c)
            np.testing.assert_array_equal(np.asarray(d), c.numpy())


@pytest.mark.parametrize("row_chunk", [5, 8, 36, 100])
def test_irv_round_chunked_equals_irv_round(stereo_pair, row_chunk):
    """One round under a `need` plane, at chunk sizes that do and do not
    divide the height and at one that covers it."""
    arms, disp, outl, _ = _irv_case(stereo_pair, False)
    rng = np.random.default_rng(6)
    need = _t(rng.random(disp[0].shape) < 0.5)
    args = (_t(disp[0]), _t(outl[0]), _t(arms[0]), 5, 0.4, 12, 6, 5)
    for n in (None, need):
        ref = tirv.irv_round(*args, n)
        got = tirv.irv_round_chunked(*args, n, row_chunk)
        assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])


# ---- the 4K preset ------------------------------------------------------

def test_uhd4k_16v_preset_equals_the_jax_preset():
    assert dataclasses.asdict(tconfig.UHD4K_16V) == dataclasses.asdict(
        jconfig.UHD4K_16V)
    assert config_from_dict(
        dataclasses.asdict(jconfig.UHD4K_16V)) == tconfig.UHD4K_16V
    cfg = tconfig.UHD4K_16V
    assert (cfg.band_row_chunk, cfg.irv_row_chunk, cfg.num_views) == (
        540, 1080, 16)
    tpipe.check_ported(cfg)
    # the 4K preset interlaces at its input's resolution: the synthesis
    # kernel (B12's interlace mode) takes no resampling tables there
    assert cfg.out_shape[:2] == (cfg.num_rows, cfg.num_cols)
    assert cfg.num_views > 2      # intermediate views: the merge runs
    # the extent of a stereo-core chunk and of an IRV chunk at 4K
    assert tband.chunk_bounds(2160, 540, 2 * cfg.usd)[0] == 680
    assert tband.chunk_bounds(2160, 1080, cfg.usd)[0] == 1152


@pytest.mark.parametrize("digits", [1, 2, 3])
def test_config_from_dict_carries_the_dial(digits):
    jcfg = CFG.replace(band_digits=digits, irv_row_chunk=8)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tpipe.check_ported(tcfg)
