"""Numpy emulations of kernels B15 (window sums of a float volume,
`csrc/span.cu`) and B18b (the disparity-major vertical passes,
`csrc/vvdm.cu`), held exactly against their plain versions
`span_sum_float_plain` and `vv_dm_plain`.

The CUDA kernels run only on the card; these emulations replay their
index logic on the CPU.  B15: the balanced tiles, the staged rows with
their halo (rows outside the line are left NaN, so reading one shows),
the blocks of small integers that take prefix differences (a chunk of
rows a warp, then the chunks' offsets), the groups of K positions, the
empty windows past the line, and the three-part walk over the union of
the K windows (or the one loop with both compares), each accumulator
from +0.0 in float32.  B18b: each batch's three phases, the prefix rings
of 2 * reach + S + 1 slots with P[j] in slot j % N, the window ring
of the slots of P[lo] and P[hi] written a batch ahead and read by pass 2
at its row and by pass 3 reach rows later, and the int16 wrap of pass
2's rescaled sums.  Each emulation follows its kernel line for line,
vectorised over d (B15) or over the columns and planes
(B18b): change a kernel and its emulation together.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import band as tband
from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN

torch.set_num_threads(1)

SPAN_TN_MAX = 256             # span.cu
SPAN_K = 4                    # span.cu: positions a thread sums
VDM_S = 8                     # vvdm.cu: rows a batch


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- B15 --------------------------------------------------------------

def emulate_span_sum(t, arm_neg, arm_pos, axis, incl, max_arm,
                     tn_max=SPAN_TN_MAX):
    """span_sum_kernel on the staged terms t (H, W, D) float32, a block
    for each tile, line and group of 32 d; returns the output (NaN where
    nothing was written) and the number of blocks that took the prefix
    differences."""
    h, w, nd = t.shape
    n, lines = (w, h) if axis == 1 else (h, w)
    r_arm = max_arm + 1
    k = SPAN_K
    tiles = -(-n // tn_max)
    tn = -(-(-(-n // tiles)) // k) * k
    out = np.full(t.shape, np.nan, np.float32)
    prefix_blocks = 0
    for o, dz in np.ndindex(lines, -(-nd // 32)):
        ds = slice(32 * dz, 32 * dz + 32)
        line = t[o, :, ds] if axis == 1 else t[:, o, ds]     # (n, <= 32)
        an = arm_neg[o] if axis == 1 else arm_neg[:, o]
        ap = arm_pos[o] if axis == 1 else arm_pos[:, o]
        dst = out[o, :, ds] if axis == 1 else out[:, o, ds]
        for bx in range(tiles):
            p0 = bx * tn
            base = p0 - r_arm
            r_lo, r_hi = max(-base, 0), min(tn + 2 * r_arm, n - base)
            stage = np.full((tn + 2 * r_arm, line.shape[1]), np.nan,
                            np.float32)
            if r_hi > r_lo:
                stage[r_lo:r_hi] = line[base + r_lo:base + r_hi]
            npos = min(tn, n - p0)

            def window(p):
                neg = min(max(int(an[p]), 0), max_arm)
                pos = min(max(int(ap[p]), 0), max_arm)
                return max(p - neg, 0) - base, min(p + pos + incl, n) - base

            staged = stage[r_lo:r_hi]
            with np.errstate(invalid="ignore"):
                small_int = bool(((staged == np.rint(staged))
                                  & (np.abs(staged) <= 32768)).all())
            if small_int:
                prefix_blocks += 1
                # the in-place scan in chunks of rows, one chunk a warp
                chunk = -(-(r_hi - r_lo) // 8)
                sums = []
                for wp in range(8):
                    c0, c1 = r_lo + wp * chunk, min(r_lo + (wp + 1) * chunk,
                                                    r_hi)
                    run = np.zeros(stage.shape[1], np.float32)
                    for r in range(c0, c1):
                        run = run + stage[r]
                        stage[r] = run
                    sums.append(run)
                for wp in range(8):
                    off = np.zeros(stage.shape[1], np.float32)
                    for prev in sums[:wp]:
                        off = off + prev
                    c0, c1 = r_lo + wp * chunk, min(r_lo + (wp + 1) * chunk,
                                                    r_hi)
                    if (off != 0).any():
                        stage[c0:c1] = stage[c0:c1] + off
                zero = np.zeros(stage.shape[1], np.float32)
                for i in range(max(npos, 0)):
                    lo, hi = window(p0 + i)
                    s_hi = stage[hi - 1] if hi > r_lo else zero
                    s_lo = stage[lo - 1] if lo > r_lo else zero
                    dst[p0 + i] = s_hi - s_lo
                continue
            for g in range(0, max(npos, 0), k):
                lo, hi = [], []
                for kk in range(k):
                    if g + kk < npos:
                        a, b = window(p0 + g + kk)
                        lo.append(a)
                        hi.append(b)
                    else:
                        lo.append(lo[0])
                        hi.append(lo[0])
                acc = np.zeros((k, stage.shape[1]), np.float32)
                lo_min, lo_max, hi_min, hi_max = (min(lo), max(lo), min(hi),
                                                  max(hi))

                def add(j, keep):
                    for kk in range(k):
                        if keep(kk):
                            acc[kk] = acc[kk] + stage[j]

                with np.errstate(invalid="ignore"):
                    if lo_max <= hi_min:
                        for j in range(lo_min, lo_max):
                            add(j, lambda kk: j >= lo[kk])
                        for j in range(lo_max, hi_min):
                            add(j, lambda kk: True)
                        for j in range(hi_min, hi_max):
                            add(j, lambda kk: j < hi[kk])
                    else:
                        for j in range(lo_min, hi_max):
                            add(j, lambda kk: lo[kk] <= j < hi[kk])
                for kk in range(k):
                    if g + kk < npos:
                        dst[p0 + g + kk] = acc[kk]
    return out, prefix_blocks


def _span_case(h, w, nd, max_arm, seed, arm_hi=None):
    rng = np.random.default_rng(seed)
    vol = (rng.standard_normal((h, w, nd)) * 50).astype(np.float32)
    hi = max_arm + 4 if arm_hi is None else arm_hi
    neg = rng.integers(-2, hi, (h, w)).astype(np.int32)
    pos = rng.integers(-2, hi, (h, w)).astype(np.int32)
    return vol, neg, pos


# (h, w, nd, max_arm, tn_max): the kernel's tiles, lines shorter than a
# window, max_arm 0 and 64, several tiles with a short last one (tn_max
# cut so that small lines still cross tile borders)
SPAN_CASES = [(9, 37, 3, 4, 256), (5, 300, 2, 34, 256), (40, 7, 2, 64, 256),
              (21, 13, 1, 0, 256), (6, 70, 2, 9, 16), (70, 5, 3, 5, 24)]


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("h,w,nd,max_arm,tn_max", SPAN_CASES)
def test_span_stream_matches_plain(h, w, nd, max_arm, tn_max, nsplit):
    """Both axes, inclusive and half-open: bit-equal to
    `span_sum_float_plain`, and every output written once from staged
    rows only."""
    vol, neg, pos = _span_case(h, w, nd, max_arm, 100 * h + w + nsplit)
    t = tband.split_bf16_terms(_t(vol), nsplit).numpy()
    for axis in (0, 1):
        for incl in (0, 1):
            got, _ = emulate_span_sum(t, neg, pos, axis, incl, max_arm,
                                      tn_max)
            want = tband.span_sum_float_plain(
                _t(vol), _t(neg), _t(pos), axis, bool(incl), nsplit,
                max_arm).numpy()
            assert not np.isnan(got).any()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def test_span_stream_disjoint_windows_take_both_compares():
    """Arms that jump between neighbours, so that some groups' windows do
    not all overlap (lo_max > hi_min): the one loop with both compares."""
    rng = np.random.default_rng(7)
    h, w, nd, max_arm = 3, 90, 2, 20
    vol = rng.standard_normal((h, w, nd)).astype(np.float32)
    neg = np.where(np.arange(w) % 4 < 2, 0, max_arm)[None, :].repeat(h, 0)
    pos = np.where(np.arange(w) % 4 < 2, 1, 0)[None, :].repeat(h, 0)
    neg, pos = neg.astype(np.int32), pos.astype(np.int32)
    t = tband.split_bf16_terms(_t(vol), 2).numpy()
    got, _ = emulate_span_sum(t, neg, pos, 1, 0, max_arm)
    want = tband.span_sum_float_plain(_t(vol), _t(neg), _t(pos), 1, False,
                                      2, max_arm).numpy()
    np.testing.assert_array_equal(got, want)


def test_span_stream_integer_blocks_take_exact_prefixes():
    """Small-integer terms (|t| <= 2^15, -0.0 among them) make a block take
    prefix differences, bit-equal to the ascending sum (a zero is +0.0
    both ways); one term of 32769 or 0.5 sends its block back to the walk
    and leaves the other blocks on prefixes."""
    rng = np.random.default_rng(9)
    h, w, nd, max_arm = 6, 300, 40, 12
    vol = rng.integers(-32768, 32769, (h, w, nd)).astype(np.float32)
    vol[rng.random(vol.shape) < 0.2] = -0.0
    vol[:, 100:140] = rng.choice([-0.0, 0.0], (h, 40, nd))
    vol[2, 30, 5] = 32769.0          # x pass: line 2's first tile, d 0-31
    vol[4, 200, 35] = 0.5            # line 4's second tile, d 32-39
    neg = rng.integers(-2, max_arm + 3, (h, w)).astype(np.int32)
    pos = rng.integers(-2, max_arm + 3, (h, w)).astype(np.int32)
    neg[:, 100:140] = pos[:, 100:140] = 3
    t = tband.split_bf16_terms(_t(vol), 3).numpy()     # exact integers
    assert t[2, 30, 5] == 32769.0
    for axis in (0, 1):
        for incl in (0, 1):
            got, prefix = emulate_span_sum(t, neg, pos, axis, incl, max_arm,
                                           tn_max=128)
            want = tband.span_sum_float_plain(
                _t(vol), _t(neg), _t(pos), axis, bool(incl), 3,
                max_arm).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            blocks = (h if axis == 1 else w) * 2 * (3 if axis == 1 else 1)
            assert 0 < prefix < blocks
    block = want[:, 104:136]
    assert ((block == 0) & ~np.signbit(block)).any()


# ---- B18b -------------------------------------------------------------

def emulate_vv_dm(vol, arms_l, arms_r, reach, s2, s3):
    """vvdm_kernel for every (plane, column) at once (each column of a
    lane is an independent stream): the window ring zeroed, then written
    a batch ahead (before the batch's reads: the order a fast producer
    warp may take); each batch's three phases (P1 of its rows, pass 2,
    pass 3) in turn; the rings of 2 * reach + S + 1 slots with P[j] in
    slot j % N.  Returns the output and the number of times each element
    was written."""
    d2, h, w = vol.shape
    nd = d2 // 2
    rows = VDM_S
    n = 2 * reach + rows + 1
    wn = 32                         # a power of two >= reach + 2 * rows
    while wn < reach + 2 * rows:
        wn *= 2
    half2 = 1 << (s2 - 1) if s2 else 0
    half3 = 1 << (s3 - 1) if s3 else 0
    up = np.stack([arms_l[UP]] * nd + [arms_r[UP]] * nd)        # (2D, H, W)
    down = np.stack([arms_l[DOWN]] * nd + [arms_r[DOWN]] * nd)
    ring1 = np.full((n, d2, w), 0xDEAD, np.uint32)
    ring2 = np.full((n, d2, w), 0xBEEF, np.uint32)
    ring1[0] = ring2[0] = 0                         # P1[0] = P2[0] = 0
    # window ring: (slot of P[lo], slot of P[hi]) per row
    wring = np.zeros((wn, 2, d2, w), np.int64)
    written = np.zeros(wn, bool)
    p1 = np.zeros((d2, w), np.uint32)
    p2 = np.zeros((d2, w), np.uint32)
    out = np.zeros((d2, h, w), np.int16)
    writes = np.zeros((d2, h, w), np.int64)
    w1 = w2 = 0
    steps = h + 2 * reach
    batches = -(-steps // rows)

    def put_windows(b):
        for r in range(rows):
            y = b * rows + r - reach
            if 0 <= y < h:
                a = np.minimum(np.clip(up[:, y], 0, reach), y)
                bb = np.minimum(np.clip(down[:, y], 0, reach), h - y)
                wring[(b * rows + r) % wn] = [(y - a) % n, (y + bb) % n]
                written[(b * rows + r) % wn] = True

    def window_sums(ring, r):
        lo, hi = wring[r % wn]
        return (np.take_along_axis(ring, hi[None], 0)[0]
                - np.take_along_axis(ring, lo[None], 0)[0]).view(np.int32)

    put_windows(0)
    for b in range(batches):
        i0 = b * rows
        if b + 1 < batches:
            put_windows(b + 1)
        for k in range(rows):                     # P1 of the batch's rows
            if i0 + k < h:
                w1 = 0 if w1 + 1 == n else w1 + 1
                p1 = p1 + vol[:, i0 + k].astype(np.int32).astype(np.uint32)
                ring1[w1] = p1
        sums = [window_sums(ring1, i0 + k) for k in range(rows)]
        for k in range(rows):                     # pass 2
            y2 = i0 + k - reach
            if 0 <= y2 < h:
                assert written[(i0 + k) % wn]
                r2 = ((sums[k] + half2) >> s2).astype(np.int16)
                w2 = 0 if w2 + 1 == n else w2 + 1
                p2 = p2 + r2.astype(np.int32).astype(np.uint32)
                ring2[w2] = p2
        sums = [window_sums(ring2, i0 + k - reach) for k in range(rows)]
        for k in range(rows):                     # pass 3
            y3 = i0 + k - 2 * reach
            if 0 <= y3 < h:
                assert written[(i0 + k - reach) % wn]
                out[:, y3] = ((sums[k] + half3) >> s3).astype(np.int16)
                writes[:, y3] += 1
    return out, writes


def _vv_dm_case(h, w, nd, reach, seed, lo=0, hi=17_300):
    rng = np.random.default_rng(seed)
    vol = rng.integers(lo, hi, (2 * nd, h, w)).astype(np.int16)
    arms = [rng.integers(-2, reach + 5, (4, h, w)).astype(np.int32)
            for _ in range(2)]
    return vol, arms


# (h, w, nd, reach): 37 rows (fewer than a ring holds at reach 34), reach
# 0 (rings of S + 1 slots) and 64, an odd width, H below reach, one row
VV_DM_CASES = [(37, 9, 2, 34), (20, 7, 3, 0), (40, 5, 1, 64), (13, 11, 2, 5),
               (9, 6, 2, 34), (1, 4, 1, 3), (50, 3, 2, 5), (70, 3, 1, 2)]


@pytest.mark.parametrize("h,w,nd,reach", VV_DM_CASES)
def test_vv_dm_stream_matches_plain(h, w, nd, reach):
    vol, (al, ar) = _vv_dm_case(h, w, nd, reach, 10 * h + reach)
    _, s2, s3 = tband.agg_rescale_shifts(reach, 2)
    got, writes = emulate_vv_dm(vol, al, ar, reach, s2, s3)
    want = tband.vv_dm_plain(_t(vol), _t(al), _t(ar), s2, s3, reach)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want.numpy())


def test_vv_dm_stream_wraps_at_the_int16_ceiling():
    """Inputs near 2^15 whose rescaled pass-2 sums pass 32767: both
    versions wrap them to int16 alike, and pass 3 sums the wrapped
    values."""
    reach = 34
    vol, (al, ar) = _vv_dm_case(100, 6, 2, reach, 3, lo=30_000, hi=32_768)
    al[:], ar[:] = reach, reach
    _, s2, s3 = tband.agg_rescale_shifts(reach, 2)
    got, _ = emulate_vv_dm(vol, al, ar, reach, s2, s3)
    want = tband.vv_dm_plain(_t(vol), _t(al), _t(ar), s2, s3, reach)
    np.testing.assert_array_equal(got, want.numpy())
    # the pass-2 sums past 32767 wrapped negative
    p2 = tband._span_dm(_t(vol[:2]), _t(al[UP]), _t(al[DOWN]), 1, reach)
    assert int(((p2 + (1 << (s2 - 1))) >> s2).max()) > 32767
