"""The port's disparity-major stereo core (kernels B16 and B18a-c, plain
versions) against the JAX package's disparity-major functions, their
Pallas kernels in interpret mode on the CPU, and against the port's own
lane-major core at band_digits=2.

Everything here is exact but the float32 cost: the quantized cost is the
same float32 expression rounded to u8 and the aggregation is integer
arithmetic on both sides.  The disparity-major aggregation always uses
the digits=2 rescale shifts, whatever the config says
(stereo_to_multiview_tpu/ops/band.py `band_aggregate_q_dm`), so it is
held against the lane-major core at band_digits=2, not at the default 3.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.ops import band as jband
from stereo_to_multiview_tpu.ops import costkern as jck

from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.ops import band as tband
from stereo_to_multiview_tpu_torch.ops import costkern as tck
from stereo_to_multiview_tpu_torch.ops.cross import (
    UP, DOWN, LEFT, RIGHT, cross_arms)

from conftest import _textured

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stereo_pair():
    """conftest's pair (its recipe and seed, drawn first) from a generator
    of this module's own.  The session fixture draws from the session's
    shared `rng`, so under xdist's --dist loadfile its values follow the
    tests a worker ran before; after tests/test_band.py's it is a pair
    whose right eye is one exact shift of the left, whose disparities are
    constant, and `test_band_stereo_core_dm`'s check that they are not
    fails for the data, not the code (both cores still agree)."""
    return _textured(np.random.default_rng(1234), 36, 52)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# (nd, zd) = (16, 0) reads only to the right, (16, 12) is asymmetric; the
# D=128/zd=64 case is in tests/test_torch_dm_d128.py (the JAX side takes a
# minute to trace its 256 unrolled planes)
COST_CASES = [(16, 0), (16, 12), (12, 6)]


@pytest.mark.parametrize("nd,zd", COST_CASES)
def test_ci_adcensus_kern_stacked_u8_matches_jax(stereo_pair, nd, zd):
    left, right = stereo_pair
    ref = jck.ci_adcensus_kern_stacked(
        jnp.asarray(left), jnp.asarray(right), 10.0, 30.0, nd, zd,
        quant=True, interpret=True)
    got = tck.ci_adcensus_kern_stacked(_t(left), _t(right), 10.0, 30.0, nd,
                                       zd)
    assert got.dtype == torch.uint8 and got.shape == (2 * nd, *left.shape[:2])
    np.testing.assert_array_equal(_np(ref), _np(got))


@pytest.mark.parametrize("nd,zd", COST_CASES)
def test_ci_adcensus_kern_matches_jax(stereo_pair, nd, zd):
    """The row-major pair: u8 exact; float32 within 2e-6 absolute (XLA's
    and torch's float32 exp differ in the last ulp; the cost is a sum of
    two terms below 1, so an ulp of each is at most 1.2e-7)."""
    left, right = stereo_pair
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    for quant in (True, False):
        ref = jck.ci_adcensus_kern(jl, jr, 10.0, 30.0, nd, zd, quant=quant,
                                   interpret=True)
        got = tck.ci_adcensus_kern(_t(left), _t(right), 10.0, 30.0, nd, zd,
                                   quant=quant)
        for a, b in zip(ref, got):
            assert b.shape == (*left.shape[:2], nd) and b.is_contiguous()
            if quant:
                assert b.dtype == torch.uint8
                np.testing.assert_array_equal(_np(a), _np(b))
            else:
                assert b.dtype == torch.float32
                np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-6)


def test_stacked_cost_equals_the_lane_major_volumes(stereo_pair):
    """Kernel B16's values are those of B2 + B3: plane d of each eye is
    the (H, W, D) volume's slice d."""
    left, right = (_t(x) for x in stereo_pair)
    nd, zd = 12, 6
    pair = tck.cost_pair(left, right, 10.0, 30.0, nd, zd)
    m = tck.pair_margin(nd, zd)
    vol = tck.cost_dm(left, right, 10.0, 30.0, nd, zd)
    assert torch.equal(vol[:nd].permute(1, 2, 0),
                       pair[:, m:m + left.shape[1]])
    assert torch.equal(vol[nd:].permute(1, 2, 0), tck.shear_right(pair, zd))


# the first, a middle and the last 16-row chunk of a 40-row frame with a
# halo of 4 rows (usd 2), as `band_stereo_core_dm` cuts it: rows [0, 16),
# [12, 28) and [24, 40)
ROW_CHUNKS = [0, 2, 4]


@pytest.mark.parametrize("quant", [True, False], ids=["u8", "float32"])
@pytest.mark.parametrize("chunk", ROW_CHUNKS)
def test_cost_dm_row_range_matches_jax_chunk(quant, chunk):
    """`cost_dm` over a row range of the whole frame equals the JAX
    chunk's cost exactly as `band_stereo_core_dm` slices it: the stacked
    kernel on img[i0:i1], i0 = max(0, start - 3), then rows [c_lo, c_lo +
    ext).  The census reads rows outside the range but inside the frame
    (stereo_to_multiview_tpu/ops/band.py:1055-1060).  u8 exact; float32
    within 2e-6 (the two packages' float32 exp differ in the last ulp)."""
    left, right = _textured(np.random.default_rng(77), 40, 44)
    nd, zd = 12, 5
    ext, bounds = tband.chunk_bounds(40, 8, 4)
    start = bounds[chunk][0]
    i0, i1 = max(0, start - 3), min(40, start + ext + 3)
    ref = jck.ci_adcensus_kern_stacked(
        jnp.asarray(left[i0:i1]), jnp.asarray(right[i0:i1]), 10.0, 30.0, nd,
        zd, quant=quant, interpret=True)[:, start - i0:start - i0 + ext]
    got = tck.cost_dm(_t(left), _t(right), 10.0, 30.0, nd, zd, quant,
                      rows=(start, ext))
    assert got.shape == (2 * nd, ext, 44)
    assert got.dtype == (torch.uint8 if quant else torch.float32)
    if quant:
        np.testing.assert_array_equal(_np(ref), _np(got))
    else:
        np.testing.assert_allclose(_np(ref), _np(got), rtol=0, atol=2e-6)


def test_ci_adcensus_kern_shift_extract_raises():
    """shift_extract=True is ported (kernel B17): it raises only where the
    direct path does, for a disparity reach beyond 128 columns, and runs
    where its condition holds (tests/test_torch_shift_extract.py holds its
    values)."""
    img = torch.zeros((8, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="128"):
        tck.ci_adcensus_kern(img, img, 10.0, 30.0, 160, 80,
                             shift_extract=True)
    wide = torch.zeros((8, 400, 3), dtype=torch.uint8)
    assert tck.shift_extract_applies(400, 4, 2)
    a, b = tck.ci_adcensus_kern(wide, wide, 10.0, 30.0, 4, 2, quant=True,
                                shift_extract=True)
    assert a.shape == b.shape == (8, 400, 4) and a.dtype == torch.uint8


def test_cost_dm_rejects_wide_disparity_ranges():
    img = torch.zeros((8, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="128"):
        tck.ci_adcensus_kern_stacked(img, img, 10.0, 30.0, 160, 80)


def _arms(rng, h, w, usd, border_limited=True):
    a = rng.integers(0, usd + 1, (4, h, w))
    if border_limited:
        y = np.arange(h)[:, None]
        x = np.arange(w)[None, :]
        a[UP] = np.minimum(a[UP], y)
        a[DOWN] = np.minimum(a[DOWN], h - 1 - y)
        a[LEFT] = np.minimum(a[LEFT], x)
        a[RIGHT] = np.minimum(a[RIGHT], w - 1 - x)
    return a.astype(np.int32)


def _dm_case(h, w, usd, seed, border_limited=True):
    """(2D, H, W) u8 costs with planted ties and both eyes' arms."""
    rng = np.random.default_rng(seed)
    nd = 8
    cost2 = rng.integers(0, 255, (2 * nd, h, w)).astype(np.uint8)
    cost2[5] = cost2[2]                  # equal planes: the lower d must win
    cost2[nd + 6, :, : w // 2] = cost2[nd + 1, :, : w // 2]
    return (cost2, _arms(rng, h, w, usd, border_limited),
            _arms(rng, h, w, usd, border_limited), nd)


def _lane_major(cost2, nd):
    return (_t(cost2[:nd]).permute(1, 2, 0).contiguous(),
            _t(cost2[nd:]).permute(1, 2, 0).contiguous())


# a width and a height that are no multiples of 8 beside the JAX test's
SHAPES = [(16, 160), (13, 150)]


@pytest.mark.parametrize("usd", [5, 34])
@pytest.mark.parametrize("h,w", SHAPES)
def test_band_aggregate_q_dm_matches_jax_and_lane_major(h, w, usd):
    cost2, arms_l, arms_r, nd = _dm_case(h, w, usd, 100 * usd + h)
    zd = 3
    ref = jband.band_aggregate_q_dm(
        jnp.asarray(cost2), jnp.asarray(arms_l), jnp.asarray(arms_r),
        num_disp=nd, zero_disp=zd, max_arm=usd, interpret=True)
    got = tband.band_aggregate_q_dm(_t(cost2), _t(arms_l), _t(arms_r),
                                    num_disp=nd, zero_disp=zd, max_arm=usd)
    lane = [tband.band_aggregate_q(c, _t(a), usd, zd, digits=2)
            for c, a in zip(_lane_major(cost2, nd), (arms_l, arms_r))]
    for a, b, c in zip(ref, got, lane):
        assert b.dtype == torch.float32 and b.shape == (h, w)
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(c), _np(b))


@pytest.mark.parametrize("border_limited", [True, False])
@pytest.mark.parametrize("usd", [5, 34])
@pytest.mark.parametrize("h,w", SHAPES)
def test_dm_passes_match_the_lane_major_passes(h, w, usd, border_limited):
    """Each disparity-major pass against the lane-major pass of the same
    eye (other code: another layout, another window helper), at the
    digits=2 shifts; arms that reach past the border (a row chunk's edge
    rows) clip to the array on both sides."""
    cost2, arms_l, arms_r, nd = _dm_case(h, w, usd, 7 * usd + w,
                                         border_limited)
    _, s2, s3 = tband.agg_rescale_shifts(usd, 2)
    p1 = tband.pass1_dm(_t(cost2), _t(arms_l), _t(arms_r), usd)
    vv = tband.vv_dm(p1, _t(arms_l), _t(arms_r), s2, s3, usd)
    disp = tband.pass4_wta_dm(vv, _t(arms_l), _t(arms_r), 3, usd)
    assert p1.dtype == vv.dtype == torch.int16
    assert p1.shape == vv.shape == cost2.shape
    assert int(vv.max()) < 2 ** 15 and int(vv.min()) >= 0
    for e, (cost, arms) in enumerate(zip(_lane_major(cost2, nd),
                                         (_t(arms_l), _t(arms_r)))):
        sl = slice(e * nd, (e + 1) * nd)
        a1 = tband.h_pass_sum(cost, arms[LEFT], arms[RIGHT], 0, usd)
        assert torch.equal(p1[sl].permute(1, 2, 0).to(torch.int32), a1)
        a2 = tband.vv_pass(a1, arms[UP], arms[DOWN], s2, s3, usd)
        assert torch.equal(vv[sl].permute(1, 2, 0).to(torch.int32), a2)
        assert torch.equal(
            disp[e], tband.h_pass_wta(a2, arms[LEFT], arms[RIGHT], 3, usd))


@pytest.mark.parametrize("usd", [0, 34, 64])
def test_vv_dm_at_its_edges_matches_jax_and_vv_pass(usd):
    """Kernel B18b's edges on the CPU: 37 rows (fewer than its rings hold
    at usd 34), W = 1001 (odd: the kernel loads element by element, not
    by cp.async), reach 0 (rings of S + 1 slots) and 64.  The aggregation
    through `vv_dm` bit-equal to the JAX
    package's `band_aggregate_q_dm`, and `vv_dm` itself to the lane-major
    `vv_pass` of each eye."""
    h, w = 37, 1001
    cost2, arms_l, arms_r, nd = _dm_case(h, w, usd, 1000 + usd)
    zd = 3
    ref = jband.band_aggregate_q_dm(
        jnp.asarray(cost2), jnp.asarray(arms_l), jnp.asarray(arms_r),
        num_disp=nd, zero_disp=zd, max_arm=usd, interpret=True)
    got = tband.band_aggregate_q_dm(_t(cost2), _t(arms_l), _t(arms_r),
                                    num_disp=nd, zero_disp=zd, max_arm=usd)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))
    _, s2, s3 = tband.agg_rescale_shifts(usd, 2)
    p1 = tband.pass1_dm(_t(cost2), _t(arms_l), _t(arms_r), usd)
    vv = tband.vv_dm(p1, _t(arms_l), _t(arms_r), s2, s3, usd)
    for e, arms in enumerate((_t(arms_l), _t(arms_r))):
        sl = slice(e * nd, (e + 1) * nd)
        lane = p1[sl].permute(1, 2, 0).to(torch.int32).contiguous()
        a2 = tband.vv_pass(lane, arms[UP], arms[DOWN], s2, s3, usd)
        assert torch.equal(vv[sl].permute(1, 2, 0).to(torch.int32), a2)
    if usd:
        assert int(vv.max()) > 0


@pytest.mark.parametrize("usd", [0, 64])
def test_h_dm_at_its_edges_matches_jax_and_h_pass(usd):
    """Kernels B18a and B18c's edges on the CPU: W = 1001 (two segments,
    rows not aligned for 16-byte loads), reach 0 (no halo) and 64 (a left
    halo of 64 columns), arms drawn past [0, reach].  The aggregation
    through `pass1_dm` and `pass4_wta_dm` bit-equal to the JAX package's
    `band_aggregate_q_dm`, and each pass to the lane-major `h_pass_sum`
    and `h_pass_wta` of each eye."""
    h, w = 13, 1001
    cost2, arms_l, arms_r, nd = _dm_case(h, w, usd, 2000 + usd)
    zd = 3
    ref = jband.band_aggregate_q_dm(
        jnp.asarray(cost2), jnp.asarray(arms_l), jnp.asarray(arms_r),
        num_disp=nd, zero_disp=zd, max_arm=usd, interpret=True)
    got = tband.band_aggregate_q_dm(_t(cost2), _t(arms_l), _t(arms_r),
                                    num_disp=nd, zero_disp=zd, max_arm=usd)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))
    _, s2, s3 = tband.agg_rescale_shifts(usd, 2)
    p1 = tband.pass1_dm(_t(cost2), _t(arms_l), _t(arms_r), usd)
    vv = tband.vv_dm(p1, _t(arms_l), _t(arms_r), s2, s3, usd)
    disp = tband.pass4_wta_dm(vv, _t(arms_l), _t(arms_r), zd, usd)
    for e, (cost, arms) in enumerate(zip(_lane_major(cost2, nd),
                                         (_t(arms_l), _t(arms_r)))):
        sl = slice(e * nd, (e + 1) * nd)
        a1 = tband.h_pass_sum(cost, arms[LEFT], arms[RIGHT], 0, usd)
        assert torch.equal(p1[sl].permute(1, 2, 0).to(torch.int32), a1)
        lane = vv[sl].permute(1, 2, 0).to(torch.int32).contiguous()
        assert torch.equal(
            disp[e], tband.h_pass_wta(lane, arms[LEFT], arms[RIGHT], zd,
                                      usd))
    if usd:
        assert int(p1.max()) > 0 and float(disp[0].std()) > 0


def test_pass4_wta_dm_takes_the_first_minimum():
    """A flat volume: every d ties at every pixel, so the argmin is 0."""
    nd, h, w, usd = 6, 9, 21, 5
    rng = np.random.default_rng(5)
    vol = torch.full((2 * nd, h, w), 77, dtype=torch.int16)
    arms = _t(_arms(rng, h, w, usd))
    dl, dr = tband.pass4_wta_dm(vol, arms, arms, 2, usd)
    assert float(dl.min()) == float(dl.max()) == -2.0
    assert torch.equal(dl, dr)


def test_dm_wrappers_reject_what_the_kernels_do_not_take():
    vol = torch.zeros((5, 4, 8), dtype=torch.uint8)
    arms = torch.zeros((4, 4, 8), dtype=torch.int32)
    meta = torch.empty((4, 4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tband.pass1_dm(meta, arms, arms, 2)
    with pytest.raises(ValueError, match="num_disp"):
        tband.band_aggregate_q_dm(vol, arms, arms, num_disp=2, zero_disp=1,
                                  max_arm=2)


@pytest.mark.parametrize("row_chunk", [0, 8])
def test_band_stereo_core_dm(stereo_pair, row_chunk):
    """Whole frame and 8-row chunks: bit-exact against the JAX
    disparity-major core, and against the lane-major cores of both
    packages at band_digits=2."""
    left, right = stereo_pair
    h, w = left.shape[:2]
    cfg = JaxConfig(num_rows=h, num_cols=w, num_rows_out=h, num_cols_out=w,
                    num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=4,
                    engine="band", band_row_chunk=row_chunk, band_digits=2)
    l, r = jnp.asarray(left), jnp.asarray(right)
    jarms = (jops.cross_arms(l, 6.0, 20.0, 5, 2),
             jops.cross_arms(r, 6.0, 20.0, 5, 2))
    ref = jband.band_stereo_core_dm(l, r, *jarms, cfg, interpret=True)
    ref_lane = jband.band_stereo_core_chunked(l, r, *jarms, cfg,
                                              interpret=True)
    tl, tr = _t(left), _t(right)
    tarms = (cross_arms(tl, 6.0, 20.0, 5, 2), cross_arms(tr, 6.0, 20.0, 5, 2))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    got = tband.band_stereo_core_dm(tl, tr, *tarms, tcfg)
    lane = tband.band_stereo_core_chunked(tl, tr, *tarms, tcfg)
    # the config's band_digits is not read by the disparity-major core
    same = tband.band_stereo_core_dm(tl, tr, *tarms,
                                     tcfg.replace(band_digits=3))
    for a, a_lane, b, c, d in zip(ref, ref_lane, got, lane, same):
        assert float(b.std()) > 0
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(a_lane), _np(b))
        assert torch.equal(b, c) and torch.equal(b, d)
