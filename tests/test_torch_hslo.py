"""The scanline optimisation (kernel B13's plain version), the pass-4
volume it reads, and the unfused warps (kernel B14's plain version)
against the JAX package, Pallas kernels in interpret mode on the CPU.

On the CPU every wrapper takes its plain version, which chip_smoke.py
holds bit-equal to the CUDA kernel on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.golden import stages as golden
from stereo_to_multiview_tpu.ops.band import agg_cost_scale, band_aggregate_q
from stereo_to_multiview_tpu.ops.hslo import dc_hslo_hwd
from stereo_to_multiview_tpu.ops.hslokern import dc_hslo_wta_kern
from stereo_to_multiview_tpu.ops.warpkern import dibr_warp_views_kern_xm

from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
from stereo_to_multiview_tpu_torch.ops import (
    band as tband, dibr as tdibr, hslo as thslo, hslokern as thslokern)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _hslo_inputs(seed, h, w, d, integral):
    rng = np.random.default_rng(seed)
    vol = rng.random((h, w, d)).astype(np.float32)
    vol = np.round(vol * 500) if integral else vol
    gl = rng.integers(0, 256, (h, w)).astype(np.uint8)
    gr = rng.integers(0, 256, (h, w)).astype(np.uint8)
    # smooth stretches, so that all three penalty tiers occur
    gl[:, w // 3:w // 2] = gl[:, w // 3:w // 3 + 1]
    gr[:, w // 4:2 * w // 3] //= 32
    return vol, gl, gr


@pytest.mark.parametrize("sign", [+1, -1])
def test_dc_hslo_hwd_matches_jax(sign):
    """The scanned volume: the same float32 adds, subtracts and minima in
    the same order, so exact; the numpy golden ((D, H, W) layout) too."""
    h, w, d, zd = 20, 96, 16, 8
    vol, gl, gr = _hslo_inputs(61, h, w, d, integral=False)
    ref = dc_hslo_hwd(jnp.asarray(vol), jnp.asarray(gl), jnp.asarray(gr), d,
                      zd, 15.0, 2.0, 6.0, sign=sign)
    got = thslo.dc_hslo_hwd(_t(vol), _t(gl), _t(gr), d, zd, 15.0, 2.0, 6.0,
                            sign=sign).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))
    gold = golden.dc_hslo(np.moveaxis(vol, 2, 0), gl, gr, d, zd, 15.0, 2.0,
                          6.0, sign=sign)
    np.testing.assert_array_equal(got, np.moveaxis(gold, 0, 2))
    tiers = thslo.tiers_hwd(_t(gl), _t(gr), d, zd, 15.0, 1)
    assert set(tiers.unique().tolist()) == {0, 1, 2}


@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("d,zd", [(16, 8), (12, 5)])
def test_dc_hslo_wta_matches_hslo_kern(sign, d, zd):
    """B13's plain version against the TPU kernel in interpret mode on
    integer-valued volumes; W = 203 is not a multiple of the TPU kernel's
    8-column groups.

    The port equals argmin(dc_hslo_hwd) of the JAX package exactly.  The
    TPU kernel starts both carries at 1e30, and in float32 (c + 1e30) -
    1e30 is 0, not c: its forward direction's first column comes out as
    zeros instead of its own cost (the backward direction's first real
    column is its own cost, through the zero pad columns).  The port
    follows the scan and the golden, so the two may differ at a few
    pixels, within the JAX package's own bound for this pair (1e-3,
    tests/test_band.py test_hslo_wta_kern_matches_scan) -- and the JAX
    scan differs from the TPU kernel at exactly those pixels."""
    h, w = 24, 203
    vol, gl, gr = _hslo_inputs(62, h, w, d, integral=True)
    ga, gb = (gl, gr) if sign > 0 else (gr, gl)
    scan = dc_hslo_hwd(jnp.asarray(vol), jnp.asarray(gl), jnp.asarray(gr), d,
                       zd, 15.0, 2.0, 6.0, sign=sign)
    scan_d = np.asarray(jnp.argmin(scan, axis=2) - zd).astype(np.float32)
    kern_d = np.asarray(dc_hslo_wta_kern(
        jnp.swapaxes(jnp.asarray(vol), 0, 1), jnp.asarray(ga),
        jnp.asarray(gb), d, zd, 15.0, 2.0, 6.0, sign=sign, interpret=True))
    got = thslokern.dc_hslo_wta(_t(vol.astype(np.int32)), _t(ga), _t(gb), d,
                                zd, 15.0, 2.0, 6.0, sign).numpy()
    assert got.shape == (h, w) and got.dtype == np.float32
    np.testing.assert_array_equal(got, scan_d)
    diff = got != kern_d
    assert np.mean(diff) < 1e-3
    np.testing.assert_array_equal(diff, scan_d != kern_d)


def test_dc_hslo_wta_changes_the_wta():
    """With penalties of the costs' size the optimisation moves some
    disparities off the plain first-min argmin, and smooths them."""
    h, w, d, zd = 12, 80, 16, 8
    vol, gl, gr = _hslo_inputs(63, h, w, d, integral=True)
    got = thslokern.dc_hslo_wta(_t(vol.astype(np.int32)), _t(gl), _t(gr), d,
                                zd, 15.0, 100.0, 300.0, +1).numpy()
    wta = (np.argmin(vol, axis=2) - zd).astype(np.float32)
    assert np.mean(got != wta) > 0.2
    assert np.abs(np.diff(got, axis=1)).mean() < np.abs(
        np.diff(wta, axis=1)).mean()


def _arms(h, w, usd, rng=None):
    x = np.arange(w)[None, :].repeat(h, 0)
    y = np.arange(h)[:, None].repeat(w, 1)
    arms = np.stack([np.minimum(usd, y), np.minimum(usd, h - 1 - y),
                     np.minimum(usd, x), np.minimum(usd, w - x)])
    if rng is not None:
        arms = np.minimum(arms, rng.integers(0, usd + 1, arms.shape))
    return arms.astype(np.int32)


@pytest.mark.parametrize("fixture", ["random", "large"])
def test_band_aggregate_q_volume_matches_jax(fixture):
    """Pass 4 without WTA: the int32 aggregated volume against JAX
    `band_aggregate_q(final_out_t=True)` at digits=3.  "large" is the
    JAX package's worst case (maximal costs, full arms at usd=34), whose
    sums exceed int16."""
    if fixture == "large":
        h, w, d, usd = 80, 208, 16, 34
        cost = np.full((h, w, d), 254, np.uint8)
        arms = _arms(h, w, usd)
    else:
        rng = np.random.default_rng(64)
        h, w, d, usd = 40, 72, 12, 9
        cost = rng.integers(0, 255, (h, w, d)).astype(np.uint8)
        arms = _arms(h, w, usd, rng)
    ref = band_aggregate_q(jnp.asarray(cost).astype(jnp.bfloat16),
                           jnp.asarray(arms), usd, digits=3, interpret=True,
                           final_out_t=True)
    ref = np.swapaxes(np.asarray(ref), 0, 1)
    got = tband.band_aggregate_q(_t(cost), _t(arms), usd, None,
                                 digits=3).numpy()
    assert got.dtype == np.int32 and got.shape == (h, w, d)
    np.testing.assert_array_equal(got, ref)
    if fixture == "large":
        assert got.max() > 32767
    # the fused WTA is the first-min argmin of this volume
    wta = tband.band_aggregate_q(_t(cost), _t(arms), usd, 5,
                                 digits=3).numpy()
    np.testing.assert_array_equal(wta, np.argmin(got, axis=2) - 5.0)
    assert tband.agg_cost_scale(usd, 3) == agg_cost_scale(usd, 3)


def _warp_inputs(stereo_pair, integral):
    l, r = stereo_pair
    h, w = l.shape[:2]
    rng = np.random.default_rng(65)
    dl = rng.integers(-6, 6, (h, w)).astype(np.float32)
    dr = rng.integers(-6, 6, (h, w)).astype(np.float32)
    if not integral:
        dl += (rng.random((h, w)) * 0.9).astype(np.float32)
        dr += (rng.random((h, w)) * 0.9).astype(np.float32)
    return l, r, dl, dr


@pytest.mark.parametrize("integral", [True, False])
@pytest.mark.parametrize("num_views", [4, 8])
def test_warp_views_matches_jax(stereo_pair, num_views, integral):
    """B14's plain version: exact against the JAX package's unfused XLA
    warp (`dibr_backward_warp` with a mask of ones) and the numpy golden,
    view by view.  Against the TPU kernel in interpret mode it may differ
    by exactly 1, and only where that kernel departs from
    `dibr_backward_warp` itself: its lerp w0*g + w1*f is compiled with a
    contracted multiply-add, the unfused one (and the port) rounds both
    products.  Such places take under 3% of the subpixels of this
    smoothed-noise pair (the shifts are thirds and sevenths, so the
    sample coordinates are fractional for integral disparities too)."""
    l, r, dl, dr = _warp_inputs(stereo_pair, integral)
    h, w = l.shape[:2]
    shifts = _synth_shifts(num_views)
    va, vb = tdibr.warp_views(_t(l), _t(r), _t(dl), _t(dr), shifts)
    assert va.shape == (len(shifts), h, w, 3) and va.dtype == torch.float32
    ones = np.ones((h, w), np.float32)
    jl, jr, jdl, jdr, jones = (jnp.asarray(a) for a in (l, r, dl, dr, ones))
    xla_a = np.stack([np.asarray(jops.dibr_backward_warp(
        jl, jones, jdr, -s, 12, 6)) for s in shifts])
    xla_b = np.stack([np.asarray(jops.dibr_backward_warp(
        jr, jones, jdl, 1.0 - s, 12, 6)) for s in shifts])
    np.testing.assert_array_equal(va.numpy(), xla_a.astype(np.float32))
    np.testing.assert_array_equal(vb.numpy(), xla_b.astype(np.float32))
    for j, s in enumerate(shifts):
        np.testing.assert_array_equal(
            va[j].numpy(), golden.dibr_backward_warp(l, ones, dr, -s))
        np.testing.assert_array_equal(
            vb[j].numpy(), golden.dibr_backward_warp(r, ones, dl, 1.0 - s))

    ka, kb = dibr_warp_views_kern_xm(jl, jr, jdl, jdr, shifts, 12, 6,
                                     interpret=True)
    for got, kern, xla in ((va, ka, xla_a), (vb, kb, xla_b)):
        kern = np.swapaxes(np.asarray(kern), 1, 2)
        diff = got.numpy() != kern
        assert np.all(np.abs(got.numpy() - kern)[diff] == 1)
        assert np.all((xla != kern)[diff])
        assert np.mean(diff) < 3e-2


def test_warp_views_without_intermediate_views(stereo_pair):
    l, r, dl, dr = _warp_inputs(stereo_pair, True)
    va, vb = tdibr.warp_views(_t(l), _t(r), _t(dl), _t(dr), ())
    assert va.shape == vb.shape == (0, *l.shape) and va.dtype == torch.float32


@pytest.mark.parametrize("wrapper", ["dc_hslo_wta", "warp_views",
                                     "h_pass_sum_i32", "irv_vote_need"])
def test_new_kernel_wrappers_reject_other_devices(wrapper):
    """A wrapper takes the plain version only for a CPU tensor; any other
    device launches the kernel or raises -- never a silent fallback."""
    from stereo_to_multiview_tpu_torch.ops import irv as tirv

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    u8, i32 = torch.uint8, torch.int32
    calls = {
        "dc_hslo_wta": lambda: thslokern.dc_hslo_wta(
            m(4, 8, 4, dtype=i32), m(4, 8, dtype=u8), m(4, 8, dtype=u8), 4,
            2, 15.0, 1.0, 3.0, 1),
        "warp_views": lambda: tdibr.warp_views(
            m(4, 8, 3, dtype=u8), m(4, 8, 3, dtype=u8), m(4, 8), m(4, 8),
            (0.5,)),
        "h_pass_sum_i32": lambda: tband.h_pass_sum(
            m(4, 8, 4, dtype=i32), m(4, 8, dtype=i32), m(4, 8, dtype=i32),
            0, 2),
        "irv_vote_need": lambda: tirv.irv_vote(
            m(4, 8, 5, dtype=u8), m(4, 8), m(4, 8, dtype=u8),
            m(4, 8, dtype=i32), m(4, 8, dtype=i32), 5, 0.4, 2, 2,
            m(4, 8, dtype=torch.bool)),
    }
    with pytest.raises(ValueError, match="CPU or CUDA"):
        calls[wrapper]()
