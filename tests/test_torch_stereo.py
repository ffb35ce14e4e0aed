"""The port's stereo core (kernels B2-B6, plain versions) against the JAX
band engine's Pallas kernels run in interpret mode on the CPU.

Every comparison is exact: the cost is a table lookup of the same float32
expression and the aggregation is integer arithmetic on both sides.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.ops import band as jband
from stereo_to_multiview_tpu.ops.costkern import ci_adcensus_kern_xm

from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.ops import band as tband
from stereo_to_multiview_tpu_torch.ops import costkern as tck
from stereo_to_multiview_tpu_torch.ops.cross import (
    UP, DOWN, LEFT, RIGHT, cross_arms, cross_arms_lr)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_costs(left, right, nd, zd, ad=10.0, cen=30.0):
    """(cost_l, cost_r) u8 through the port's B2 + B3 wrappers."""
    l, r = _t(left), _t(right)
    m = tck.pair_margin(nd, zd)
    pair = tck.cost_pair(l, r, ad, cen, nd, zd)
    w = left.shape[1]
    return pair[:, m:m + w], tck.shear_right(pair, zd)


@pytest.mark.parametrize("coeffs", [(10.0, 30.0), (20.0, 30.0),
                                    (10.0, 60.0)])
def test_cost_table_matches_jnp_exp(coeffs):
    """The 766 x 49 table equals the TPU kernel's float32 expression
    evaluated with jnp.exp (costkern.py:309-313)."""
    ad_coeff, census_coeff = coeffs
    f32 = jnp.float32
    ad = jnp.arange(766, dtype=f32)[:, None]
    ham = jnp.arange(49, dtype=f32)[None, :]
    cost = ((f32(1.0) - jnp.exp(-(ad * f32(0.33333333333))
                                * float(1.0 / ad_coeff)))
            + (f32(1.0) - jnp.exp(-ham * float(1.0 / census_coeff))))
    ref = jnp.rint(cost * f32(127.0)).astype(jnp.int32).astype(jnp.uint8)
    got = tck.cost_table(ad_coeff, census_coeff)
    assert got.numel() == 766 * 49
    np.testing.assert_array_equal(_np(ref).reshape(-1), _np(got))


def test_cost_volumes_match_kern_xm(stereo_pair):
    """Plain B2 (left eye) and B3 (right eye) vs ci_adcensus_kern_xm
    (quant=True) at D=12/zd=6 and an asymmetric zero_disp."""
    left, right = stereo_pair
    for nd, zd in ((12, 6), (16, 12)):
        ref_l, ref_r = ci_adcensus_kern_xm(
            jnp.asarray(left), jnp.asarray(right), 10.0, 30.0, nd, zd,
            quant=True, interpret=True)
        got_l, got_r = _port_costs(left, right, nd, zd)
        np.testing.assert_array_equal(_np(ref_l), _np(got_l))
        np.testing.assert_array_equal(_np(ref_r), _np(got_r))


def test_cost_volumes_match_kern_xm_at_the_shear_bound():
    """D=128/zd=64 on a narrow frame: max(zd, D - zd) = 64 is exactly the
    TPU shear's bound, and every disparity reaches past both borders."""
    rng = np.random.default_rng(21)
    left = rng.integers(0, 256, (6, 40, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (6, 40, 3), dtype=np.uint8)
    ref_l, ref_r = ci_adcensus_kern_xm(
        jnp.asarray(left), jnp.asarray(right), 10.0, 30.0, 128, 64,
        quant=True, interpret=True)
    got_l, got_r = _port_costs(left, right, 128, 64)
    np.testing.assert_array_equal(_np(ref_l), _np(got_l))
    np.testing.assert_array_equal(_np(ref_r), _np(got_r))


@pytest.mark.parametrize("usd", [2, 5, 9, 34, 64])
def test_agg_rescale_shifts(usd):
    for digits in (1, 2, 3):
        assert (tband.agg_rescale_shifts(usd, digits)
                == jband.agg_rescale_shifts(usd, digits))
    assert tband._halo_for(usd) == jband._halo_for(usd)
    assert tband.agg_rescale_shifts(34, 3) == (0, 3, 6)


def _arms(rng, h, w, usd, border_limited):
    """Random arms <= usd; border_limited arms stop at the image border as
    cross arms do, the others reach past it (a row chunk's edge rows),
    where both sides clip the window to the array."""
    a = rng.integers(0, usd + 1, (4, h, w))
    if border_limited:
        y = np.arange(h)[:, None]
        x = np.arange(w)[None, :]
        a[UP] = np.minimum(a[UP], y)
        a[DOWN] = np.minimum(a[DOWN], h - 1 - y)
        a[LEFT] = np.minimum(a[LEFT], x)
        a[RIGHT] = np.minimum(a[RIGHT], w - 1 - x)
    return a.astype(np.int32)


@pytest.fixture(scope="module")
def agg_case():
    rng = np.random.default_rng(22)
    h, w, nd, usd = 72, 80, 16, 34
    cost = rng.integers(0, 255, (h, w, nd)).astype(np.uint8)
    return rng, cost, usd


@pytest.mark.parametrize("border_limited", [True, False])
def test_h_pass_sum_matches_band_pass_h(agg_case, border_limited):
    rng, cost, usd = agg_case
    arms = _arms(rng, *cost.shape[:2], usd, border_limited)
    s1 = 2    # a non-zero rescale to exercise the rounding shift
    ref = jband._band_pass_h(
        jnp.asarray(cost), jnp.asarray(arms[LEFT]), jnp.asarray(arms[RIGHT]),
        mode="int", terms=1, rescale=s1, out_dtype=jnp.int32,
        halo=jband._halo_for(usd), interpret=True)
    got = tband.h_pass_sum(_t(cost), _t(arms[LEFT]), _t(arms[RIGHT]), s1,
                           usd)
    np.testing.assert_array_equal(_np(ref), _np(got))


@pytest.mark.parametrize("border_limited", [True, False])
def test_vv_pass_matches_band_pass_vv(agg_case, border_limited):
    rng, cost, usd = agg_case
    h, w, nd = cost.shape
    arms = _arms(rng, h, w, usd, border_limited)
    # pass 1's output range (s1 = 0): the rescales then keep every later
    # sum below 2^24, where the JAX kernel's float32 digit dots are exact
    vol = rng.integers(0, 254 * (2 * usd + 1) + 1, (h, w, nd)).astype(
        np.int32)
    _, s2, s3 = tband.agg_rescale_shifts(usd, 3)
    ref = jband._band_pass_vv(
        jnp.swapaxes(jnp.asarray(vol), 0, 1), jnp.asarray(arms[UP].T),
        jnp.asarray(arms[DOWN].T), s2=s2, s3=s3, digits=3,
        out_dtype=jnp.int32, halo=jband._halo_for(usd), interpret=True)
    got = tband.vv_pass(_t(vol), _t(arms[UP]), _t(arms[DOWN]), s2, s3, usd)
    np.testing.assert_array_equal(_np(jnp.swapaxes(ref, 0, 1)), _np(got))


def test_h_pass_wta_matches_band_pass_h(agg_case):
    """Pass 4 + first-min WTA on an int32 volume with planted exact ties
    (the lower d must win)."""
    rng, cost, usd = agg_case
    h, w, nd = cost.shape
    arms = _arms(rng, h, w, usd, True)
    vol = rng.integers(0, 40, (h, w, nd)).astype(np.int32)
    vol[:, :, 9] = vol[:, :, 3]
    zd = 5
    ref = jband._band_pass_h(
        jnp.asarray(vol), jnp.asarray(arms[LEFT]), jnp.asarray(arms[RIGHT]),
        mode="int", terms=3, wta=True, zero_disp=zd,
        halo=jband._halo_for(usd), interpret=True)
    got = tband.h_pass_wta(_t(vol), _t(arms[LEFT]), _t(arms[RIGHT]), zd, usd)
    np.testing.assert_array_equal(_np(ref), _np(got))


def test_band_aggregate_q_matches(agg_case):
    rng, cost, usd = agg_case
    arms = _arms(rng, *cost.shape[:2], usd, True)
    ref = jband.band_aggregate_q(jnp.asarray(cost), jnp.asarray(arms), usd,
                                 zero_disp=8, digits=3, interpret=True)
    got = tband.band_aggregate_q(_t(cost), _t(arms), usd, 8, digits=3)
    np.testing.assert_array_equal(_np(ref), _np(got))


@pytest.mark.parametrize("row_chunk", [0, 8])
def test_band_stereo_core_chunked(stereo_pair, row_chunk):
    """Whole frame and 8-row chunks: bit-exact against the JAX band core
    (itself chunk-invariant), both eyes."""
    left, right = stereo_pair
    h, w = left.shape[:2]
    cfg = JaxConfig(num_rows=h, num_cols=w, num_rows_out=h, num_cols_out=w,
                    num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=4,
                    engine="band", band_row_chunk=row_chunk)
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


def test_band_stereo_core_chunks_start_mid_frame(stereo_pair):
    """A 72-row frame in 16-row chunks (usd 5: 40 rows each, from rows 0,
    6, 22 and 32, the last ending at the frame's last row): B2 computes
    each chunk's census from the whole frame's images, so the core equals
    the JAX band core, whose cost entry sees a slice widened by the
    census' reach."""
    left, right = (np.concatenate([x, x[::-1, ::-1]]) for x in stereo_pair)
    h, w = left.shape[:2]
    cfg = JaxConfig(num_rows=h, num_cols=w, num_rows_out=h, num_cols_out=w,
                    num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=4,
                    engine="band", band_row_chunk=16)
    assert [b[0] for b in tband.chunk_bounds(h, 16, 10)[1]] == [0, 6, 22,
                                                                32, 32]
    l, r = jnp.asarray(left), jnp.asarray(right)
    ref = jband.band_stereo_core_chunked(
        l, r, jops.cross_arms(l, 6.0, 20.0, 5, 2),
        jops.cross_arms(r, 6.0, 20.0, 5, 2), cfg, interpret=True)
    tl, tr = _t(left), _t(right)
    got = tband.band_stereo_core_chunked(
        tl, tr, *cross_arms_lr(tl, tr, 6.0, 20.0, 5, 2),
        config_from_dict(dataclasses.asdict(cfg)))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))
