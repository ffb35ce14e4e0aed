"""Kernel B15's plain version (`band_span_sum_h/_v`), the IRV on it
(`dr_irv_band`, `dr_irv_band_lr`) and the float-cost aggregation entries
(`quantize_cost`, `cross_aggregate_band`) against the JAX package, its
Pallas kernels in interpret mode on the CPU; and the `digits` defaults of
the aggregation, the same in both packages.

On the CPU every wrapper takes its plain version, which chip_smoke.py
holds bit-equal to the CUDA kernel on the card.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.ops import band as jband

from stereo_to_multiview_tpu_torch.ops import band as tband, irv as tirv
from stereo_to_multiview_tpu_torch.ops.cross import cross_arms

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def vol_arms():
    """The shapes of the JAX package's own span tests: (24, 200, 16),
    arms <= usd = 9 that stop at the border (RIGHT may reach it)."""
    rng = np.random.default_rng(40)
    h, w, d, usd = 24, 200, 16, 9
    vol = rng.random((h, w, d)).astype(np.float32)
    x = np.arange(w)[None, :].repeat(h, 0)
    y = np.arange(h)[:, None].repeat(w, 1)
    arms = np.stack([
        np.minimum(rng.integers(0, usd + 1, (h, w)), y),
        np.minimum(rng.integers(0, usd + 1, (h, w)), h - 1 - y),
        np.minimum(rng.integers(0, usd + 1, (h, w)), x),
        np.minimum(rng.integers(0, usd + 1, (h, w)), w - x),
    ]).astype(np.int32)
    return rng, vol, arms, usd


def _both(vol, arms, axis, inclusive, nsplit, usd):
    """(JAX kernel, port) span sums of `vol` along `axis`."""
    neg, pos = (arms[0], arms[1]) if axis == 0 else (arms[2], arms[3])
    jfn = jband.band_span_sum_v if axis == 0 else jband.band_span_sum_h
    tfn = tband.band_span_sum_v if axis == 0 else tband.band_span_sum_h
    ref = jfn(jnp.asarray(vol), jnp.asarray(neg), jnp.asarray(pos),
              inclusive=inclusive, nsplit=nsplit, max_arm=usd,
              interpret=True)
    got = tfn(_t(vol), _t(neg), _t(pos), inclusive, nsplit, usd)
    assert got.dtype == torch.float32 and got.shape == vol.shape
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("kind", ["binary", "small integers"])
def test_span_sum_exact_on_integer_volumes(vol_arms, axis, inclusive, kind):
    """nsplit=1 on values bf16 holds exactly: every sum is exact, so the
    two packages agree bit for bit whatever their order of adds."""
    rng, vol, arms, usd = vol_arms
    if kind == "binary":
        v = (rng.random(vol.shape) < 0.3).astype(np.float32)
    else:
        v = rng.integers(0, 200, vol.shape).astype(np.float32)
    ref, got = _both(v, arms, axis, inclusive, 1, usd)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("nsplit", [2, 3])
def test_span_sum_float_within_bf16_split_tolerance(vol_arms, axis, nsplit):
    """Floats in [0, 1): the terms are the same, the order of the adds is
    not (the MXU dot against an ascending sum), so within 5e-5, the JAX
    package's own tolerance for its kernel."""
    _, vol, arms, usd = vol_arms
    for inclusive in (False, True):
        ref, got = _both(vol, arms, axis, inclusive, nsplit, usd)
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)


@pytest.mark.parametrize("axis", [0, 1])
def test_span_sum_nsplit1_rounds_to_bf16_as_jax(vol_arms, axis):
    """nsplit=1 on a float volume sums its bf16 roundings, as the JAX
    kernel does: the result sits closer to JAX's than to the float32 sum
    of the unrounded volume."""
    _, vol, arms, usd = vol_arms
    ref, got = _both(vol, arms, axis, False, 1, usd)
    unrounded = tband.span_sum_float_plain(
        _t(vol), *(_t(a) for a in ((arms[0], arms[1]) if axis == 0
                                    else (arms[2], arms[3]))),
        axis, False, 3, usd).numpy()
    to_jax = np.abs(got - ref).max()
    assert to_jax < 1e-5
    assert np.abs(got - unrounded).max() > 100 * to_jax


def test_span_sum_plain_is_the_ascending_window_sum():
    """The kernel's contract: each window summed in float32 from 0.0 in
    ascending position order, ends clamped into the axis, the arms
    clamped to [0, max_arm]; bit-equal, at every nsplit."""
    rng = np.random.default_rng(41)
    h, w, d, max_arm = 7, 11, 3, 4
    vol = (rng.standard_normal((h, w, d)) * 100).astype(np.float32)
    neg = rng.integers(-2, 7, (h, w)).astype(np.int32)
    pos = rng.integers(-2, 7, (h, w)).astype(np.int32)
    for nsplit in (1, 2, 3):
        t = tband.split_bf16_terms(_t(vol), nsplit).numpy()
        for axis in (0, 1):
            for inclusive in (False, True):
                got = tband.span_sum_float_plain(
                    _t(vol), _t(neg), _t(pos), axis, inclusive, nsplit,
                    max_arm).numpy()
                want = np.zeros_like(vol)
                n = vol.shape[axis]
                for y in range(h):
                    for x in range(w):
                        p = (y, x)[axis]
                        an = min(max(neg[y, x], 0), max_arm)
                        ap = min(max(pos[y, x], 0), max_arm)
                        acc = np.zeros(d, np.float32)
                        for j in range(max(p - an, 0),
                                       min(p + ap + inclusive, n)):
                            acc = acc + (t[j, x] if axis == 0 else t[y, j])
                        want[y, x] = acc
                np.testing.assert_array_equal(got, want)


def _edge_arms(rng, h, w, max_arm):
    """Arms in [0, max_arm] that stop at the border, as the JAX kernel
    needs (RIGHT and DOWN may reach it)."""
    x = np.arange(w)[None, :].repeat(h, 0)
    y = np.arange(h)[:, None].repeat(w, 1)
    return np.stack([
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), y),
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), h - 1 - y),
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), x),
        np.minimum(rng.integers(0, max_arm + 1, (h, w)), w - x),
    ]).astype(np.int32)


# (h, w, d, max_arm): the shapes where kernel B15's tiles, windows and
# lanes meet their edges (chip_smoke.py's SPAN_EDGES): max_arm 0 and 64,
# lines shorter than one window (W, H < 2 * max_arm), and D = 1, 30 and
# 130, no multiple of a block's 32 d
SPAN_EDGE_SHAPES = [(14, 50, 3, 0), (20, 90, 2, 64), (12, 40, 3, 64),
                    (18, 70, 1, 9), (16, 60, 30, 9), (10, 36, 130, 5)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("h,w,d,max_arm", SPAN_EDGE_SHAPES)
def test_span_sum_exact_at_the_kernel_edges(h, w, d, max_arm, axis):
    """nsplit=1 on small integers, where the JAX kernel is exact: bit-equal
    to it at the edge shapes, inclusive and half-open."""
    rng = np.random.default_rng(47 + h + d + max_arm)
    v = rng.integers(0, 200, (h, w, d)).astype(np.float32)
    arms = _edge_arms(rng, h, w, max_arm)
    for inclusive in (False, True):
        ref, got = _both(v, arms, axis, inclusive, 1, max_arm)
        np.testing.assert_array_equal(ref, got)


def _nonfinite_volume(rng, h, w, d):
    """Mixed signs with +-inf, NaN, a block of -0.0 and runs of 1e8, 1,
    -1e8 along both axes, whose float32 sum depends on the order."""
    v = rng.standard_normal((h, w, d)).astype(np.float32)
    pick = rng.random((h, w, d))
    v[pick < 0.01] = np.inf
    v[(pick >= 0.01) & (pick < 0.02)] = -np.inf
    v[(pick >= 0.02) & (pick < 0.03)] = np.nan
    for k, val in enumerate((1e8, 1.0, -1e8)):
        v[0::5, k:w - 2 + k:7] = val
        v[k:h - 2 + k:6, 3::7] = val
    v[4:10, 8:16] = -0.0
    return v


def test_span_sum_is_the_ascending_sum_on_non_finite_volumes():
    """The contract kernel B15 holds on the card, against a NumPy sum from
    +0.0 in ascending position order of the JAX package's own bf16 terms:
    bit for bit (NaN where it has NaN, the sign of a zero included), on
    infinities, NaN, -0.0 (+0.0 + -0.0 = +0.0) and cancelling magnitudes
    (1e8 + 1 - 1e8 = 0 in float32, not 1), every nsplit, both axes."""
    rng = np.random.default_rng(48)
    h, w, d, max_arm = 14, 30, 4, 6
    vol = _nonfinite_volume(rng, h, w, d)
    neg = rng.integers(-2, max_arm + 3, (h, w)).astype(np.int32)
    pos = rng.integers(-2, max_arm + 3, (h, w)).astype(np.int32)
    neg[4:10, 8:16] = rng.integers(0, 3, (6, 8))
    pos[4:10, 8:16] = rng.integers(0, 3, (6, 8))
    with np.errstate(invalid="ignore", over="ignore"):
        parts = [np.asarray(p).astype(np.float32)
                 for p, _ in jband._terms(jnp.asarray(vol), "float", 3)]
    seen = set()
    for nsplit in (1, 2, 3):
        t = parts[0]
        with np.errstate(invalid="ignore"):
            for p in parts[1:nsplit]:
                t = t + p
        for axis in (0, 1):
            for inclusive in (False, True):
                want = np.zeros_like(vol)
                n = vol.shape[axis]
                with np.errstate(invalid="ignore"):
                    for y in range(h):
                        for x in range(w):
                            p = (y, x)[axis]
                            an = min(max(neg[y, x], 0), max_arm)
                            ap = min(max(pos[y, x], 0), max_arm)
                            acc = np.zeros(d, np.float32)
                            for j in range(max(p - an, 0),
                                           min(p + ap + inclusive, n)):
                                acc = acc + (t[j, x] if axis == 0
                                             else t[y, j])
                            want[y, x] = acc
                fn = (tband.band_span_sum_v if axis == 0
                      else tband.band_span_sum_h)
                got = fn(_t(vol), _t(neg), _t(pos), inclusive, nsplit,
                         max_arm).numpy()
                nan = np.isnan(want)
                np.testing.assert_array_equal(np.isnan(got), nan)
                np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                              want.view(np.int32)[~nan])
                block = want[5:9, 10:14]
                seen |= {k for k, hit in (
                    ("nan", nan.any()), ("inf", np.isinf(want).any()),
                    ("+0.0", ((block == 0) & ~np.signbit(block)).any()))
                    if hit}
    # the volume holds what the test is about
    assert seen == {"nan", "inf", "+0.0"}


def test_split_bf16_terms_matches_jax_terms():
    """hi, mid, lo: successive bf16 remainders, the JAX package's `_terms`
    in mode float, recombined (hi + mid) + lo."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    parts = [np.asarray(p).astype(np.float32)
             for p, _ in jband._terms(jnp.asarray(x), "float", 3)]
    for nsplit in (1, 2, 3):
        want = parts[0]
        for p in parts[1:nsplit]:
            want = want + p
        np.testing.assert_array_equal(
            tband.split_bf16_terms(_t(x), nsplit).numpy(), want)


def test_span_sum_refuses_arms_above_64():
    vol = torch.zeros((4, 8, 2))
    arm = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="usd"):
        tband.band_span_sum_h(vol, arm, arm, max_arm=65)
    with pytest.raises(ValueError, match="nsplit"):
        tband.band_span_sum_v(vol, arm, arm, nsplit=4)


def _irv_inputs(stereo_pair, usd, nd, zd, seed):
    left, _ = stereo_pair
    h, w = left.shape[:2]
    rng = np.random.default_rng(seed)
    arms = np.asarray(jops.cross_arms(jnp.asarray(left), 6.0, 20.0, usd, 4))
    disp = rng.integers(-zd, nd - zd, (h, w)).astype(np.float32)
    outl = (rng.random((h, w)) < 0.4).astype(np.uint8)
    return disp, outl, arms


def test_dr_irv_band_matches_jax_and_dr_irv(stereo_pair):
    """As the JAX package's own test: bit-exact against its `dr_irv_band`
    and the port's fixed-round `dr_irv` (B8/B9)."""
    usd, nd, zd = 9, 12, 6
    disp, outl, arms = _irv_inputs(stereo_pair, usd, nd, zd, 43)
    args = (5, 0.4, nd, zd, usd, 3)
    rd, ro = jband.dr_irv_band(jnp.asarray(disp), jnp.asarray(outl),
                               jnp.asarray(arms), *args, interpret=True)
    gd, go = tband.dr_irv_band(_t(disp), _t(outl), _t(arms), *args)
    fd, fo = tirv.dr_irv(_t(disp), _t(outl), _t(arms), *args)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(go.numpy(), np.asarray(ro))
    assert torch.equal(gd, fd) and torch.equal(go, fo)
    assert (go.numpy() != outl).any()


def test_dr_irv_band_lr_matches_jax_and_dr_irv(stereo_pair):
    """Both eyes stacked along H: each eye equal to JAX's stacked call and
    to the port's `dr_irv` of that eye alone."""
    usd, nd, zd = 9, 12, 6
    left, right = stereo_pair
    dl, ol, al = _irv_inputs(stereo_pair, usd, nd, zd, 44)
    dr, orr, _ = _irv_inputs(stereo_pair, usd, nd, zd, 45)
    ar = np.asarray(jops.cross_arms(jnp.asarray(right), 6.0, 20.0, usd, 4))
    args = (5, 0.4, nd, zd, usd, 3)
    ref = jband.dr_irv_band_lr(*(jnp.asarray(a) for a in (dl, ol, dr, orr,
                                                           al, ar)),
                               *args, interpret=True)
    got = tband.dr_irv_band_lr(*(_t(a) for a in (dl, ol, dr, orr, al, ar)),
                               *args)
    for (rd, ro), (gd, go), (d, o, a) in zip(ref, got, ((dl, ol, al),
                                                        (dr, orr, ar))):
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(go.numpy(), np.asarray(ro))
        fd, fo = tirv.dr_irv(_t(d), _t(o), _t(a), *args)
        assert torch.equal(gd, fd) and torch.equal(go, fo)


def test_dr_irv_band_refuses_usd_above_64():
    z = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="usd <= 64"):
        tband.dr_irv_band(z, z.to(torch.uint8),
                          torch.zeros((4, 4, 8), dtype=torch.int32), 5, 0.4,
                          8, 4, 65, 1)


@pytest.fixture(scope="module")
def float_costs(stereo_pair):
    """Float32 AD-census volumes of both eyes (values in [0, 2]) and cross
    arms at usd 5."""
    left, right = stereo_pair
    l, r = jnp.asarray(left), jnp.asarray(right)
    cl, cr = (np.moveaxis(np.asarray(v), 0, 2)
              for v in jops.ci_adcensus(l, r, 10.0, 30.0, 12, 6))
    al = np.asarray(jops.cross_arms(l, 6.0, 20.0, 5, 2))
    ar = np.asarray(jops.cross_arms(r, 6.0, 20.0, 5, 2))
    return cl, cr, al, ar


def test_quantize_cost_matches_jax(float_costs):
    cl = float_costs[0]
    got = tband.quantize_cost(_t(cl))
    assert got.dtype == torch.uint8
    ref = np.asarray(jband.quantize_cost(jnp.asarray(cl))).astype(np.float32)
    np.testing.assert_array_equal(got.numpy().astype(np.float32), ref)
    # the band_qscale dial: int16 above 127.5, as the JAX package's
    for q in (255.0, 510.0):
        got = tband.quantize_cost(_t(cl), qscale=q)
        ref = np.asarray(jband.quantize_cost(jnp.asarray(cl), qscale=q))
        assert got.dtype == torch.int16 and ref.dtype == np.int16
        np.testing.assert_array_equal(got.numpy(), ref)


def test_cross_aggregate_band_matches_jax(float_costs):
    """`quantize_cost` + `band_aggregate_q` at the JAX defaults (digits=2,
    max_arm=64): exact integers, equal."""
    cl, _, al, _ = float_costs
    ref = jband.cross_aggregate_band(jnp.asarray(cl), jnp.asarray(al),
                                     interpret=True)
    got = tband.cross_aggregate_band(_t(cl), _t(al))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.warns(DeprecationWarning, match="nsplit"):
        again = tband.cross_aggregate_band(_t(cl), _t(al), nsplit=3)
    assert torch.equal(again, got)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tband.cross_aggregate_band(_t(cl), _t(al), nsplit=2)


def test_cross_aggregate_band_lr_matches_jax(float_costs):
    cl, cr, al, ar = float_costs
    ref = jband.cross_aggregate_band_lr(*(jnp.asarray(a) for a in
                                          (cl, cr, al, ar)), interpret=True)
    got = tband.cross_aggregate_band_lr(*(_t(a) for a in (cl, cr, al, ar)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("usd", [5, 9, 17, 34])
def test_digits_defaults_match_jax(usd):
    """`agg_rescale_shifts`, `agg_cost_scale` and `band_aggregate_q`
    called with default arguments give the JAX package's values."""
    assert tband.agg_rescale_shifts(usd) == jband.agg_rescale_shifts(usd)
    assert tband.agg_cost_scale(usd) == jband.agg_cost_scale(usd)
    rng = np.random.default_rng(46 + usd)
    h, w, d = 2 * usd + 6, 40, 4
    cost = rng.integers(0, 255, (h, w, d)).astype(np.uint8)
    arms = rng.integers(0, usd + 1, (4, h, w)).astype(np.int32)
    ref = jband.band_aggregate_q(jnp.asarray(cost), jnp.asarray(arms), usd,
                                 interpret=True)
    got = tband.band_aggregate_q(_t(cost), _t(arms), usd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("wrapper", ["band_span_sum_h", "band_span_sum_v"])
def test_span_wrappers_reject_other_devices(wrapper):
    """A wrapper takes the plain version only for a CPU tensor; any other
    device launches the kernel or raises, never a silent fallback."""
    m = torch.empty((4, 8, 4), device="meta")
    a = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(tband, wrapper)(m, a, a, True, 1, 4)
