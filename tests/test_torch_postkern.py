"""The plain versions of the port's kernels B1 and B7-B12 against the JAX
band engine's Pallas kernels run in interpret mode on the CPU.

Exact unless a tolerance is stated beside the assert.  On the CPU every
wrapper takes its plain version, which chip_smoke.py holds bit-equal to
the CUDA kernel on the card.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.ops.irvkern import irv_round_kern
from stereo_to_multiview_tpu.golden import stages as golden
from stereo_to_multiview_tpu.ops.postkern import (
    cross_arms_kern, cross_arms_kern_lr, dcc_occl_kern,
    filter_bilateral_kern, filter_bleed_mask_kern)
from stereo_to_multiview_tpu.ops.warpkern import (
    dibr_warp_merge_views_kern_xm)

from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
from stereo_to_multiview_tpu_torch.ops import (
    cross as tcross, dcc as tdcc, dibr as tdibr, filters as tfilters,
    irv as tirv)
from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(1)

ND, ZD = 12, 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def disps(stereo_pair):
    h, w = stereo_pair[0].shape[:2]
    rng = np.random.default_rng(31)
    dl = rng.integers(-ZD, ND - ZD, (h, w)).astype(np.float32)
    dr = rng.integers(-ZD, ND - ZD, (h, w)).astype(np.float32)
    return dl, dr


@pytest.mark.parametrize("eye", [0, 1])
@pytest.mark.parametrize("arm_params", [(6.0, 20.0, 9, 4),
                                        (6.0, 20.0, 34, 17)])
def test_cross_arms_matches_arms_kern(stereo_pair, eye, arm_params):
    """B1: borders, both color tiers and the arm-before-test quirk."""
    img = stereo_pair[eye]
    ref = cross_arms_kern(jnp.asarray(img), *arm_params, interpret=True)
    got = tcross.cross_arms(_t(img), *arm_params)
    np.testing.assert_array_equal(_np(ref), _np(got))


@pytest.mark.parametrize("arm_params", [(6.0, 20.0, 9, 4),
                                        (6.0, 20.0, 34, 17)])
def test_cross_arms_lr_matches_arms_kern_lr(stereo_pair, arm_params):
    """B1 on both eyes in one launch: the contract of cross_arms_kern_lr,
    each eye equal to its own cross_arms."""
    jl, jr = (jnp.asarray(x) for x in stereo_pair)
    ref = cross_arms_kern_lr(jl, jr, *arm_params, interpret=True)
    got = tcross.cross_arms_lr(*(_t(x) for x in stereo_pair), *arm_params)
    assert len(got) == 2
    for a, b, img in zip(ref, got, stereo_pair):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert torch.equal(b, tcross.cross_arms(_t(img), *arm_params))


@pytest.fixture(scope="module")
def bud_crop():
    """A 40x96 crop of the bundled bud pair (bud_2 left, bud_3 right):
    real edges, whose channel differences hit the thresholds' integers."""
    data = os.path.join(os.path.dirname(__file__), "data")
    return tuple(read_bmp(os.path.join(data, f"bud_{i}.bmp"))
                 [150:190, 300:396].copy() for i in (2, 3))


@pytest.mark.parametrize("ucd, lcd, moved", [(5.99, 19.97, True),
                                             (6.0, 20.0, False),
                                             (6.3, 19.6, False),
                                             (6.02, 20.03, False)])
def test_arm_thresholds_follow_the_golden_not_the_bf16_kernel(
        bud_crop, ucd, lcd, moved):
    """The reference compares each step's channel difference a (an
    integer) with the float thresholds: a > 5.99 fails at a = 6.  The
    golden (stages.py:171-200), the JAX XLA cross_arms and the port do so
    in float32.  The JAX Pallas kernel compares with bf16(t)
    (postkern.py:138, 144), and bf16 rounds 5.99 up to 6.0 and 19.97 up
    to 20.0 (spacing 1/32 and 1/8 there): at (5.99, 19.97) its steps with
    a = 6 beyond lsd or a = 20 within lsd do not fail, so those arms run
    on, never shorter than the golden's.  Where bf16 moves no threshold
    across an integer, at integer thresholds and at (6.3, 19.6) and
    (6.02, 20.03), all agree.  The port follows the golden."""
    img = bud_crop[0]
    args = (ucd, lcd, 34, 17)
    gold = golden.cross_arms(img, *args)
    np.testing.assert_array_equal(
        gold, _np(jops.cross_arms(jnp.asarray(img), *args)))
    port = tcross.cross_arms(_t(img), *args)
    np.testing.assert_array_equal(gold, _np(port))
    pallas = _np(cross_arms_kern(jnp.asarray(img), *args, interpret=True))
    diff = pallas != gold
    if not moved:
        assert not diff.any()
        return
    # every direction has arms that differ, each one longer in the kernel
    assert all(diff[k].sum() > 100 for k in range(4)), diff.sum((1, 2))
    assert np.all(pallas[diff] > gold[diff])
    # at integer thresholds one above the float ones the golden is the
    # kernel's: the bf16 rounding is the whole difference
    np.testing.assert_array_equal(
        pallas, golden.cross_arms(img, 6.0, 20.0, 34, 17))


def test_cross_arms_lr_follows_the_golden_at_fractional_thresholds(
        bud_crop):
    """Both eyes in one launch at (5.99, 19.97), equal to the golden's
    float compare (not the bf16 kernel's)."""
    got = tcross.cross_arms_lr(*(_t(x) for x in bud_crop), 5.99, 19.97, 34,
                               17)
    for img, arms in zip(bud_crop, got):
        np.testing.assert_array_equal(
            golden.cross_arms(img, 5.99, 19.97, 34, 17), _np(arms))


def test_cross_arms_on_a_crop_shorter_than_usd(bud_crop):
    """usd = 34 on 12 rows: the vertical arms stop at the crop's border,
    every walk of a column reaches both ends."""
    crop = tuple(x[:12] for x in bud_crop)
    got = tcross.cross_arms_lr(*(_t(x) for x in crop), 6.0, 20.0, 34, 17)
    for img, arms in zip(crop, got):
        np.testing.assert_array_equal(
            _np(jops.cross_arms(jnp.asarray(img), 6.0, 20.0, 34, 17)),
            _np(arms))
        assert int(arms[UP].max()) <= 11 and int(arms[DOWN].max()) <= 11


@pytest.mark.parametrize("t, c", [(5.99, 6), (6.0, 7), (19.97, 20),
                                  (20.0, 21), (0.0, 1), (-0.0, 1),
                                  (-0.5, 0), (-3.0, 0), (254.9, 255),
                                  (255.0, 256), (1e9, 256),
                                  (float("nan"), 256), (float("inf"), 256),
                                  (float("-inf"), 0)])
def test_arm_threshold_is_the_float32_compare(t, c):
    """B1's integer threshold: a > float32(t) == a >= c for every byte a,
    with no rounding of t."""
    assert tcross.arm_threshold(t) == c
    a = torch.arange(256, dtype=torch.float32)
    tf = torch.tensor(t, dtype=torch.float32)
    assert torch.equal(a > tf, a >= c)


def test_dcc_labels_match_dcc_occl_kern(disps):
    """B7 labels mode, with border-clamped lookups and scatters."""
    dl, dr = disps
    ref = dcc_occl_kern(jnp.asarray(dl), jnp.asarray(dr), 1.0,
                        with_labels=True, num_disp=ND, zero_disp=ZD,
                        interpret=True)
    got = tdcc.dr_dcc(_t(dl), _t(dr), 1.0)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_occl_hits_match_dcc_occl_kern(disps):
    """B7 hits mode on float disparities (negative ones truncate toward
    zero)."""
    rng = np.random.default_rng(32)
    fl = disps[0] + rng.random(disps[0].shape).astype(np.float32) * 0.9
    fr = disps[1] - rng.random(disps[1].shape).astype(np.float32) * 0.9
    ref = dcc_occl_kern(jnp.asarray(fl), jnp.asarray(fr), with_labels=False,
                        num_disp=ND, zero_disp=ZD, interpret=True)
    got = tdibr.dibr_occl(_t(fl), _t(fr))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("outlier_share", [0.05, 0.4])
def test_irv_round_matches_irv_round_kern(stereo_pair, disps, outlier_share):
    """B8 + B9: one voting round (row spans, then the vote)."""
    usd = 9
    arms = np.asarray(jops.cross_arms(jnp.asarray(stereo_pair[0]), 6.0,
                                      20.0, usd, 4))
    rng = np.random.default_rng(33)
    outl = (rng.random(disps[0].shape) < outlier_share).astype(np.uint8)
    ref = irv_round_kern(jnp.asarray(disps[0]), jnp.asarray(outl),
                         jnp.asarray(arms), 5, 0.4, ND, ZD, usd,
                         interpret=True)
    ta = _t(arms)
    cnt = tirv.irv_rowspan(_t(disps[0]), _t(outl), ta[LEFT], ta[RIGHT], ND,
                           ZD, usd)
    assert cnt.shape == (*outl.shape, ND + 1) and cnt.dtype == torch.uint8
    got = tirv.irv_vote(cnt, _t(disps[0]), _t(outl), ta[UP], ta[DOWN], 5,
                        0.4, ZD, usd)
    np.testing.assert_array_equal(_np(ref[0]), _np(got[0]))
    np.testing.assert_array_equal(_np(ref[1]), _np(got[1]))


def test_irv_rowspan_total_counts_reliable_outside_the_bins():
    """The last channel counts every reliable pixel, also one whose
    disparity lies outside the bins (it then falls in no bin)."""
    disp = torch.tensor([[0.0, 7.5, -9.0, 2.0]])
    outl = torch.tensor([[0, 0, 0, 1]], dtype=torch.uint8)
    arm = torch.full((1, 4), 3, dtype=torch.int32)
    cnt = tirv.irv_rowspan(disp, outl, arm, arm, 4, 2, 3)
    assert cnt[0, 0].tolist() == [0, 0, 1, 0, 3]


def test_bilateral_matches_bilat_kern(stereo_pair):
    """B10 in the TPU kernel's tap order (dx outer, dy inner)."""
    h, w = stereo_pair[0].shape[:2]
    rng = np.random.default_rng(34)
    d = (rng.random((h, w)) * 12 - 6).astype(np.float32)
    ref = filter_bilateral_kern(jnp.asarray(d), 3, 5.0, 10.0, ND,
                                interpret=True)
    got = tfilters.filter_bilateral(_t(d), 3, 5.0, 10.0)
    # the same expression in the same order; XLA's float32 exp and
    # torch's may still differ in the last ulp at some taps
    np.testing.assert_allclose(_np(ref), _np(got), rtol=1e-6, atol=1e-6)


def test_bleed_mask_matches_bleed_mask_kern():
    """B11 at radius 1 (the main path's), with the mirror edge rule."""
    rng = np.random.default_rng(35)
    occ_l = (rng.random((40, 150)) < 0.12).astype(np.uint8)
    occ_r = (rng.random((40, 150)) < 0.5).astype(np.uint8)
    ref = filter_bleed_mask_kern(jnp.asarray(occ_l), jnp.asarray(occ_r), 1,
                                 interpret=True)
    for r, occ in zip(ref, (occ_l, occ_r)):
        np.testing.assert_array_equal(_np(r),
                                      _np(tdibr.dibr_bleed_mask(_t(occ), 1)))


@pytest.mark.parametrize("num_views", [4, 8])
def test_warp_merge_views_matches_kern_xm(stereo_pair, num_views):
    """B12 on fractional disparities and feathered weights: exact against
    the JAX package's unfused synthesis (two warps, then mux_merge_ab),
    which the port follows.  Against the TPU kernel it may differ by
    exactly 1, and only where that kernel departs from the unfused
    synthesis itself: its lerp w0*g + w1*f is compiled with a contracted
    multiply-add, the unfused one (and the port) rounds both products."""
    l, r = stereo_pair
    h, w = l.shape[:2]
    rng = np.random.default_rng(36)
    dl = (rng.integers(-6, 6, (h, w)) + rng.random((h, w)) * 0.9).astype(
        np.float32)
    dr = (rng.integers(-6, 6, (h, w)) + rng.random((h, w)) * 0.9).astype(
        np.float32)
    ml = (rng.random((h, w)) < 0.8).astype(np.float32)
    mr = (rng.random((h, w)) < 0.8).astype(np.float32)
    fe = np.clip(rng.random((h, w)) * 1.2, 0, 1).astype(np.float32)
    shifts = _synth_shifts(num_views)
    ref = dibr_warp_merge_views_kern_xm(
        jnp.asarray(l), jnp.asarray(r), jnp.asarray(dl), jnp.asarray(dr),
        jnp.asarray(ml.T), jnp.asarray(mr.T), jnp.asarray(fe.T), shifts,
        ND, ZD, interpret=True)
    ref = np.swapaxes(_np(ref), 1, 2)
    jl, jr, jdl, jdr, jml, jmr, jfe = (jnp.asarray(a) for a in
                                       (l, r, dl, dr, ml, mr, fe))
    unfused = np.stack([_np(jops.mux_merge_ab(
        jops.dibr_backward_warp(jl, jmr, jdr, -s, ND, ZD),
        jops.dibr_backward_warp(jr, jml, jdl, 1.0 - s, ND, ZD), jfe))
        for s in shifts])
    got = _np(tdibr.warp_merge_views(_t(l), _t(r), _t(dl), _t(dr), _t(ml),
                                     _t(mr), _t(fe), shifts))
    np.testing.assert_array_equal(unfused, got)
    diff = got != ref
    assert np.all(np.abs(got.astype(int) - ref)[diff] == 1)
    assert np.all((unfused != ref)[diff])
    assert np.mean(diff) < 1e-3


def _meta_calls():
    """Each wrapper of B1, B7-B12 with meta tensors of valid shapes."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    u8, i32 = torch.uint8, torch.int32
    arm = m(4, 8, dtype=i32)
    return {
        "cross_arms": lambda: tcross.cross_arms(m(4, 8, 3, dtype=u8), 6.0,
                                                20.0, 2, 1),
        "cross_arms_lr": lambda: tcross.cross_arms_lr(
            m(4, 8, 3, dtype=u8), m(4, 8, 3, dtype=u8), 6.0, 20.0, 2, 1),
        "dr_dcc": lambda: tdcc.dr_dcc(m(4, 8), m(4, 8)),
        "dibr_occl": lambda: tdibr.dibr_occl(m(4, 8), m(4, 8)),
        "irv_rowspan": lambda: tirv.irv_rowspan(
            m(4, 8), m(4, 8, dtype=u8), arm, arm, 4, 2, 2),
        "irv_vote": lambda: tirv.irv_vote(
            m(4, 8, 5, dtype=u8), m(4, 8), m(4, 8, dtype=u8), arm, arm, 5,
            0.4, 2, 2),
        "filter_bilateral": lambda: tfilters.filter_bilateral(m(4, 8), 1,
                                                              5.0, 10.0),
        "dibr_bleed_mask": lambda: tdibr.dibr_bleed_mask(
            m(4, 8, dtype=u8), 1),
        "warp_merge_views": lambda: tdibr.warp_merge_views(
            m(4, 8, 3, dtype=u8), m(4, 8, 3, dtype=u8), *[m(4, 8)] * 5,
            (0.5,)),
    }


@pytest.mark.parametrize("wrapper", sorted(_meta_calls()))
def test_post_kernel_wrappers_reject_other_devices(wrapper):
    """A wrapper takes the plain version only for a CPU tensor; any other
    device launches the kernel or raises -- never a silent fallback."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        _meta_calls()[wrapper]()
