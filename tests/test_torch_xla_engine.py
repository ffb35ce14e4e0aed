"""The XLA engine (engine="xla") of the port against the JAX package's
XLA engine, on the CPU, on the same seeded inputs.

Exact unless a tolerance is stated beside the assert.  The JAX package
runs its process_frame as one jitted executable, whose CPU loops
contract a product into the add that consumes it and whose constant
folding merges the bilateral's two scales; its float32 cumsum sums in
blocks of 16 and its exp is XLA's own polynomial.  The port follows
that arithmetic where it computes the XLA engine's float stages
(`fastmath.exp_xla`, `fastmath.contracted_sum`, `cross.prefix_sum_f32`,
the `contract` options of the warp, feather and interlace resample), so
the disparities and labels equal JAX's to the bit, at xla_agg_qscale 0
(float aggregation) as at 8 (integer aggregation), and so do the views
of the jitted `synthesize_views`; the jitted frame's interlace differs
at a few subpixels (`_check_frame`).  The op-by-op
(eager) JAX functions are held equal to the port's functions without
`contract`.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.models import pipeline as jpipe

from stereo_to_multiview_tpu_torch.config import (
    HD1080_D128, config_from_dict)
from stereo_to_multiview_tpu_torch.models import pipeline as tpipe
from stereo_to_multiview_tpu_torch.ops import (
    cost as tcost, cross as tcross, dibr as tdibr, fastmath, filters,
    hslo as thslo, mux as tmux, wta as twta)
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
H, W, ND, ZD = 36, 52, 12, 6
XLA = JaxConfig(num_rows=H, num_cols=W, num_rows_out=H, num_cols_out=W,
                num_disp=ND, zero_disp=ZD, usd=5, lsd=2, num_views=8,
                irv_iterations=3, irv_thresh_s=5, bilateral_radius=2,
                feather_radius=3, engine="xla", hslo_H1=8.0,
                hslo_H2=24.0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def images():
    l = read_bmp(os.path.join(DATA, "bud_2.bmp"))[100:172:2, 200:304:2]
    r = read_bmp(os.path.join(DATA, "bud_3.bmp"))[100:172:2, 200:304:2]
    return np.ascontiguousarray(l), np.ascontiguousarray(r)


@pytest.fixture(scope="module")
def frames(images, stereo_pair):
    """Two crops of the bud pair (real texture) and the smoothed-noise
    pair."""
    crop = [read_bmp(os.path.join(DATA, n))[20:92:2, 40:144:2]
            for n in ("bud_2.bmp", "bud_3.bmp")]
    return {"bud_crop": np.concatenate(images, axis=1),
            "bud_crop_2": np.concatenate(crop, axis=1),
            "stereo_pair": np.concatenate(stereo_pair, axis=1)}


# ---- the stage functions ------------------------------------------------

def test_exp_xla_equals_xla_exp():
    """XLA's CPU exp, which the JAX package's float filters evaluate;
    torch.exp differs from it in the last ulp at some of these inputs."""
    rng = np.random.default_rng(11)
    t = np.arange(0, 300, dtype=np.float32)
    x = np.concatenate([-rng.uniform(0, 87, 200000), rng.uniform(-5, 5, 50000),
                        -(t * t) * np.float32(0.02)]).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(fastmath.exp_xla(_t(x)).numpy(), ref)
    assert np.any(torch.exp(_t(x)).numpy() != ref)


def test_ci_ad_census_combine(images):
    l, r = images
    ref = jops.ci_ad(jnp.asarray(l), jnp.asarray(r), ND, ZD)
    got = tcost.ci_ad(_t(l), _t(r), ND, ZD)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jcen = [jops.census_transform_9x7(jops.mux_average(jnp.asarray(x)))
            for x in (l, r)]
    tcen = [tcost.census_transform_9x7(tmux.mux_average(_t(x)))
            for x in (l, r)]
    ref_c = jops.ci_census(*jcen, ND, ZD)
    got_c = tcost.ci_census(*tcen, ND, ZD)
    for a, b in zip(ref_c, got_c):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for fast in (False, True):
        ref_s = jops.ci_adcensus_combine(ref[0], ref_c[0], 10.0, 30.0, fast)
        got_s = tcost.ci_adcensus_combine(got[0], got_c[0], 10.0, 30.0, fast)
        np.testing.assert_array_equal(np.asarray(ref_s), got_s.numpy())


@pytest.mark.parametrize("coeffs", [(10.0, 30.0), (7.0, 25.0)])
@pytest.mark.parametrize("fast_exp", [False, True])
def test_ci_adcensus(images, coeffs, fast_exp):
    """(D, H, W) and (H, W, D) volumes, op by op and, with the exp the
    frame uses, jitted.  (`fast_exp` is an option of the function only:
    no frame of the XLA engine takes it; its polynomial is evaluated op
    by op.)"""
    l, r = images
    args = (*coeffs, ND, ZD, fast_exp)
    ref = jops.ci_adcensus(jnp.asarray(l), jnp.asarray(r), *args)
    got = tcost.ci_adcensus(_t(l), _t(r), *args)
    for a, c in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), c.numpy())
    if not fast_exp:
        ref_jit = jax.jit(lambda a, b: jops.ci_adcensus(a, b, *args))(l, r)
        for b, c in zip(ref_jit, got):
            np.testing.assert_array_equal(np.asarray(b), c.numpy())
    from stereo_to_multiview_tpu.ops.cost import ci_adcensus_hwd
    ref = ci_adcensus_hwd(jnp.asarray(l), jnp.asarray(r), *args)
    got = tcost.ci_adcensus_hwd(_t(l), _t(r), *args)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_prefix_sum_is_a_float32_running_sum():
    rng = np.random.default_rng(4)
    vol = rng.uniform(0, 2, (5, 30, 40)).astype(np.float32)
    for axis in (1, 2):
        ref = np.asarray(jax.jit(lambda v: jnp.cumsum(
            v, axis=axis, dtype=jnp.float32))(vol))
        got = tcross.prefix_sum_f32(_t(vol), axis).numpy()
        np.testing.assert_array_equal(np.take(got, [0], axis), 0.0)
        np.testing.assert_array_equal(
            np.take(got, range(1, vol.shape[axis] + 1), axis), ref)


@pytest.mark.parametrize("qscale", [0.0, 8.0])
def test_cross_aggregate(images, qscale):
    l, r = images
    cfg = XLA.replace(xla_agg_qscale=qscale)
    cost = jops.ci_adcensus(jnp.asarray(l), jnp.asarray(r), 10.0, 30.0, ND,
                            ZD)
    cost = jpipe.xla_quant_costs(*cost, cfg)[0]
    arms = jops.cross_arms(jnp.asarray(l), cfg.ucd, cfg.lcd, cfg.usd,
                           cfg.lsd)
    ref = jops.cross_aggregate(cost, arms, max_arm=cfg.usd)
    ref_jit = jax.jit(lambda c, a: jops.cross_aggregate(
        c, a, max_arm=cfg.usd))(cost, arms)
    got = tcross.cross_aggregate(_t(cost), _t(arms), max_arm=cfg.usd)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    np.testing.assert_array_equal(np.asarray(ref_jit), got.numpy())
    # without a bound the endpoints reach the whole axis
    ref = jops.cross_aggregate(cost, arms)
    np.testing.assert_array_equal(
        np.asarray(ref), tcross.cross_aggregate(_t(cost), _t(arms)).numpy())


def test_dc_wta_takes_the_first_minimum():
    rng = np.random.default_rng(8)
    vol = rng.integers(0, 3, (ND, H, W)).astype(np.float32)   # many ties
    np.testing.assert_array_equal(np.asarray(jops.dc_wta(jnp.asarray(vol),
                                                         ZD)),
                                  twta.dc_wta(_t(vol), ZD).numpy())


@pytest.mark.parametrize("sign", [+1, -1])
def test_dc_hslo(images, sign):
    """The (D, H, W) scanline optimisation of both signs against JAX
    `dc_hslo` itself (each direction starts from its own cost)."""
    l, r = images
    rng = np.random.default_rng(9 + sign)
    cost = rng.uniform(0, 50, (ND, H, W)).astype(np.float32)
    gl, gr = (jops.mux_average(jnp.asarray(x)) for x in (l, r))
    ref = jops.dc_hslo(jnp.asarray(cost), gl, gr, ND, ZD, 15.0, 8.0, 24.0,
                       sign=sign)
    got = thslo.dc_hslo(_t(cost), _t(gl), _t(gr), ND, ZD, 15.0, 8.0, 24.0,
                        sign=sign)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_xla_quant_costs(images):
    l, r = images
    costs = jops.ci_adcensus(jnp.asarray(l), jnp.asarray(r), 10.0, 30.0, ND,
                             ZD)
    tcosts = tuple(_t(c) for c in costs)
    for q in (8.0, 3.5):
        cfg = XLA.replace(xla_agg_qscale=q)
        ref = jpipe.xla_quant_costs(*costs, cfg)
        got = tpipe.xla_quant_costs(*tcosts, config_from_dict(
            dataclasses.asdict(cfg)))
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    got = tpipe.xla_quant_costs(*tcosts, config_from_dict(
        dataclasses.asdict(XLA)))
    assert got[0] is tcosts[0] and got[1] is tcosts[1]
    # the prefix bound: 1080p with qscale 8 would pass 2^24
    big = HD1080_D128.replace(engine="xla", xla_agg_qscale=8.0)
    jbig = JaxConfig(**dataclasses.asdict(big))
    with pytest.raises(ValueError, match="xla_agg_qscale"):
        jpipe.xla_quant_costs(*costs, jbig)
    with pytest.raises(ValueError, match="xla_agg_qscale"):
        tpipe.xla_quant_costs(*tcosts, big)
    with pytest.raises(ValueError, match="xla_agg_qscale"):
        tpipe.check_ported(big)


@pytest.mark.parametrize("shift", [-0.2857143, 0.71428573, 1.0, -1.0,
                                   0.33333334])
def test_dibr_backward_warp_bounded(shift):
    """The bounded warp on disparities inside and up to 6 past the
    range [-zero_disp, num_disp - zero_disp]: just outside it a sample
    keeps part of its weight.  Op by op against the eager JAX warp, with
    `contract` against the jitted one (images whose columns step by 3, 5
    and 7 put sums on integers, where the rounding shows)."""
    rng = np.random.default_rng(12)
    img = np.stack([(np.arange(W) * k % 256) for k in (3, 5, 7)], -1)
    img = np.broadcast_to(img[None].astype(np.uint8), (H, W, 3)).copy()
    img[::3] = rng.integers(0, 256, img[::3].shape, dtype=np.uint8)
    mask = (rng.uniform(0, 1, (H, W)) < 0.9).astype(np.float32)
    d = (rng.integers(-ZD - 6, ND - ZD + 6, (H, W))
         + rng.integers(0, 9, (H, W)) / 3.0).astype(np.float32)
    args = (jnp.asarray(img), jnp.asarray(mask), jnp.asarray(d), shift, ND,
            ZD)
    ref = np.asarray(jops.dibr_backward_warp(*args))
    ref_jit = np.asarray(jax.jit(lambda a, m, x: jops.dibr_backward_warp(
        a, m, x, shift, ND, ZD))(img, mask, d))
    targs = (_t(img), _t(mask), _t(d), shift, ND, ZD)
    np.testing.assert_array_equal(tdibr.dibr_backward_warp(*targs).numpy(),
                                  ref)
    np.testing.assert_array_equal(
        tdibr.dibr_backward_warp(*targs, contract=True).numpy(), ref_jit)
    # the bound matters here: the unbounded (clamped) warp differs
    free = tdibr.masked(tdibr.warp_interp_u8(_t(img), _t(d), shift),
                        _t(mask)).numpy()
    assert np.any(free != ref)
    # without a range the bound is the whole row, as in JAX
    np.testing.assert_array_equal(
        tdibr.dibr_backward_warp(*targs[:4]).numpy(),
        np.asarray(jops.dibr_backward_warp(*args[:4])))


@pytest.mark.parametrize("radius", [0, 2, 7, 10])
def test_xla_float_filters_in_the_jitted_order(radius):
    """The XLA bilateral (any radius), the feather with `contract` and
    the interlace's resample with `contract` against the jitted JAX
    functions, on fractional disparities and random masks."""
    rng = np.random.default_rng(radius)
    spread = 500 if radius == 2 else 16     # range weights that vanish
    d = (rng.integers(-spread, spread, (48, 70))
         + rng.uniform(0, 1, (48, 70)) * (rng.uniform(0, 1, (48, 70)) < 0.3)
         ).astype(np.float32)
    ref = jax.jit(lambda x: jops.filter_bilateral(x, radius, 5.0, 10.0, 32))(d)
    got = filters.filter_bilateral_wide(_t(d), radius, 5.0, 10.0)
    if spread == 16:
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    else:
        # spreads of hundreds put weights of 1e-11 and below beside one of
        # 1e-4: at a few pixels (3 of 3360 here) the executable's sum then
        # differs in the last ulp, an order of its adds not modelled
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-7,
                                   atol=0)
        assert np.mean(got.numpy() == np.asarray(ref)) >= 0.998
    m = (rng.uniform(0, 1, (48, 70)) < 0.2).astype(np.float32)
    ref = jax.jit(lambda x: jops.filter_gaussian_lift(x, radius, 15.0))(m)
    got = filters.filter_gaussian_lift(_t(m), radius, 15.0, contract=True)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    views = rng.integers(0, 256, (5, 24, 30, 3), dtype=np.uint8)
    ref = jax.jit(lambda v: jops.mux_multiview(v, 37, 45 + radius,
                                               18.43))(views)
    got = tmux.mux_multiview(_t(views), 37, 45 + radius, 18.43,
                             contract=True)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


# ---- the whole frame ----------------------------------------------------

def _frame_pair(sbs, cfg):
    """(JAX outputs, port outputs) of process_frame(_lowres) on the CPU,
    as numpy arrays."""
    jfn = jpipe.process_frame_lowres if cfg.lowres else jpipe.process_frame
    tfn = tpipe.process_frame_lowres if cfg.lowres else tpipe.process_frame
    ref = [np.asarray(x) for x in jfn(jnp.asarray(sbs), cfg)]
    got = [x.numpy() for x in tfn(sbs, config_from_dict(
        dataclasses.asdict(cfg)), device="cpu")]
    return ref, got


def _check_frame(ref, got):
    """Disparities exact; the interlaced frame exact but for at most
    0.1% of subpixels, each +-1: where LLVM, compiling the JAX frame as
    one executable, leaves a warp's sample coordinate x + d * s
    uncontracted in one fusion and contracts it in another (the port
    contracts it everywhere, as the jitted view synthesis alone does).
    Returns the share of subpixels that differ."""
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    diff = got[2] != ref[2]
    assert np.all(np.abs(got[2].astype(int) - ref[2])[diff] == 1)
    assert np.mean(diff) <= 1e-3
    return float(np.mean(diff))


@pytest.mark.parametrize("name", ["bud_crop", "bud_crop_2", "stereo_pair"])
@pytest.mark.parametrize("qscale,hslo", [(8.0, False), (8.0, True),
                                         (0.0, False), (0.0, True)])
def test_process_frame_xla_matches_jax(frames, name, qscale, hslo):
    """Against JAX process_frame(engine="xla"), with xla_agg_qscale 8
    (exact integer aggregation) and 0 (float32 aggregation, summed in
    XLA's order: no tolerance), with and without the scanline
    optimisation: disparities exact, the interlaced frame as
    `_check_frame` states (on the bud crops: exact)."""
    cfg = XLA.replace(xla_agg_qscale=qscale, use_hslo=hslo)
    ref, got = _frame_pair(frames[name], cfg)
    assert got[0].dtype == np.float32 and got[2].shape == (H, W, 3)
    share = _check_frame(ref, got)
    if name.startswith("bud_crop"):
        assert share == 0.0
    # the views alone, jitted, on the same disparities: exact
    l, r = jops.demux_sbs(jnp.asarray(frames[name]))
    jviews = jax.jit(lambda a, b, c, d: jpipe.synthesize_views(
        a, b, c, d, cfg))(l, r, ref[0], ref[1])
    tviews = tpipe.synthesize_views(
        _t(l), _t(r), _t(ref[0]), _t(ref[1]),
        config_from_dict(dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(tviews.numpy(), np.asarray(jviews))
    if (name, qscale, hslo) == ("bud_crop", 8.0, False):
        # the labels too, from the jitted compute_disparities
        jout = jax.jit(lambda a, b: jpipe.compute_disparities(a, b, cfg))(
            l, r)
        tout = tpipe.compute_disparities(
            _t(l), _t(r), config_from_dict(dataclasses.asdict(cfg)))
        for a, b in zip(jout, tout):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("knobs", [
    dict(num_rows_out=45, num_cols_out=64, num_views=6),
    dict(bleed_radius=2, bilateral_radius=10),
    dict(num_views=2),
    dict(num_rows_disp=18, num_cols_disp=26, disp_scale=0.5, num_disp=8,
         zero_disp=4),
    dict(use_median=True, irv_row_chunk=8, usd=70, lsd=10,
         xla_agg_qscale=0.0)],
    ids=["resampled", "bleed2_bilateral10", "two_views", "lowres",
         "median_chunked_usd70"])
def test_process_frame_xla_options(frames, knobs):
    """The XLA engine with the optional stages (xla_agg_qscale 8 unless
    given), as `_check_frame` states.  usd 70 is above the band engine's
    limit; the XLA engine takes it (at qscale 8 its prefixes would pass
    2^24, so the float aggregation)."""
    ref, got = _frame_pair(frames["bud_crop"],
                           XLA.replace(**{"xla_agg_qscale": 8.0, **knobs}))
    _check_frame(ref, got)


def test_xla_engine_launches_no_band_core(frames):
    """On the CPU nothing launches; the route is read from the stages:
    the XLA engine never calls the band engine's stereo core."""
    import stereo_to_multiview_tpu_torch.models.pipeline as p
    called = []
    orig = p.band_stereo_core_chunked
    p.band_stereo_core_chunked = lambda *a, **k: called.append(1) or orig(
        *a, **k)
    try:
        cfg = config_from_dict(dataclasses.asdict(XLA))
        tpipe.process_frame(frames["bud_crop"], cfg, device="cpu")
        assert not called
        tpipe.process_frame(frames["bud_crop"], cfg.replace(engine="auto"),
                            device="cpu")
        assert called
    finally:
        p.band_stereo_core_chunked = orig
