"""Numpy emulations of kernels B15 (window sums of a float volume,
`csrc/span.cu`), B18b (the disparity-major vertical passes,
`csrc/vvdm.cu`) and B18a/B18c (the disparity-major horizontal passes,
`csrc/band_dm.cu`), held exactly against their plain versions
`span_sum_float_plain`, `vv_dm_plain`, `pass1_dm_plain` and
`pass4_wta_dm_plain`.

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
2's rescaled sums.  B18a/B18c: the segments and their halo, the lanes'
16-column units (vector loads on 16-byte aligned rows, else the 4-byte
words that overlap the row shifted into place by __byte_perm, from an
allocation whose bytes outside the volume are garbage), the ring of
steps, pass 1's two planes packed a | b << 16 in wrapping u32 prefixes,
the warp's shuffle scan into padded double-buffered slots, and the WTA's
keys (sum * 256 + d, a min that keeps the first minimum) reduced over the
block's plane groups.  Each emulation follows its kernel line for line,
vectorised over d (B15), over the columns and planes (B18b) or over the
lanes (B18a/c): change a kernel and its emulation together.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import band as tband
from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

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


# ---- B18a / B18c ------------------------------------------------------

HDM_TX = 512                  # band_dm.cu: most output columns a segment
HDM_SLOTS = 684               # slots of P[0..640], one pad slot in 16
HDM_NS = 2                    # steps in the ring of loads
HDM_PMAX = 8                  # warps (plane groups) a block
HDM_WARPS = 16384             # warps a launch aims for
LANES = np.arange(32)


def hdm_slot(i):
    return i + (i >> 4)


def _bperm(x, y, s):
    """__byte_perm(x, y, s): byte n of the result is byte (nibble n of s)
    of the 8 bytes y:x (no sign-replicate selectors)."""
    b = np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << np.uint64(32))
    s = np.asarray(s, np.uint64)
    out = np.zeros(np.broadcast(b, s).shape, np.uint64)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(15)
        assert (sel < 8).all()
        out |= ((b >> (np.uint64(8) * sel)) & np.uint64(255)) << np.uint64(
            8 * n)
    return out.astype(np.uint32)


class _Mem:
    """The allocation that holds a volume: `base` bytes of garbage, the
    volume's bytes, garbage to a 512-byte boundary; every load is checked
    against its guard (a vector unit inside its row, a word overlapping
    its row) and counted."""

    def __init__(self, vol, base, rng):
        raw = np.ascontiguousarray(vol).view(np.uint8).reshape(-1)
        self.lo, self.hi = base, base + raw.size
        size = -(-self.hi // 512) * 512
        self.bytes = rng.integers(0, 256, size).astype(np.uint8)
        self.bytes[self.lo:self.hi] = raw
        self.loads = 0

    def words(self, addr, n, row_lo, row_hi, whole):
        """n little-endian u32 words from each address of `addr` (an array
        of lanes); `whole`: the load lies inside [row_lo, row_hi)."""
        addr = np.asarray(addr, np.int64)
        if whole:
            assert ((addr >= row_lo) & (addr + 4 * n <= row_hi)).all()
        else:
            assert ((addr + 4 * n > row_lo) & (addr < row_hi)).all()
        assert ((addr >= self.lo - 3) & (addr < self.hi)).all()
        self.loads += addr.size
        idx = addr[:, None] + np.arange(4 * n)
        b = self.bytes[idx].astype(np.uint32).reshape(-1, n, 4)
        return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16
                | b[..., 3] << 24).astype(np.uint32)


def hdm_launch(es, nd, h, w, reach, base_bytes):
    """launch_hdm's choices: segments, their width, the left halo, plane
    groups a block and their size, and the vector path."""
    ps = 2 if es == 1 else 1
    nseg = -(-w // HDM_TX)
    tx = (-(-w // nseg) + 15) & ~15
    rl = (reach + 15) & ~15
    items = 2 * h * nseg
    p = 1
    while p < HDM_PMAX and items * p < HDM_WARPS and p * ps < nd:
        p *= 2
    dg = -(-(-(-nd // p)) // ps) * ps
    vec = base_bytes % 16 == 0 and w % (16 // es) == 0
    return nseg, tx, rl, p, dg, vec


def emulate_hdm(vol, arms_l, arms_r, reach, wta, zd=0, base=0, seed=0,
                short_halo=False):
    """hdm_kernel on a (2D, H, W) u8 (pass 1, `wta` False) or int16 (pass
    4 + WTA) volume placed `base` elements into its allocation: a block
    for each (eye, row, segment), its warps' plane groups, each lane's 16
    columns (vector units where rows are 16-byte aligned, else the 4-byte
    words that overlap the row shifted into place) and 4 halo columns,
    the ring of HDM_NS steps (a step's slot loaded again once its words
    are out), the column words (u8: planes d and d + 1 as a | b << 16,
    u32 arithmetic), the lanes' prefixes and the warp's shuffle scan, the
    padded double-buffered slots, lane l's outputs x0 + l + 32 j and their
    windows' slot offsets, and pass 1's stores (both planes from one
    word) or the WTA's keys and the block's reduction.  `short_halo`: the
    loaded columns end one short of the windows' reach (a deliberately
    broken variant).  Returns the output (int16 volume, or the two
    float32 planes) and the times each output element was written."""
    rng = np.random.default_rng(seed)
    d2, h, w = vol.shape
    nd = d2 // 2
    es = vol.dtype.itemsize
    ps = 2 if es == 1 else 1
    ng, nt = 4 * es, es
    mem = _Mem(vol, base * es, rng)
    nseg, tx, rl, nwarps, dg, vec = hdm_launch(es, nd, h, w, reach,
                                               base * es)
    if not vec:
        ng, nt = ng + 1, nt + 1
    wide = wta and nd > 256
    arms = (arms_l, arms_r)
    if wta:
        out = [np.full((h, w), np.nan, np.float32) for _ in range(2)]
        writes = np.zeros((2, h, w), np.int64)
    else:
        out = np.zeros((d2, h, w), np.int16)
        writes = np.zeros((d2, h, w), np.int64)

    for e, y, seg in np.ndindex(2, h, nseg):
        x0 = seg * tx
        s0 = x0 - rl
        xend = min(x0 + tx, w)
        nlo = max(x0 - reach, 0)
        nhi = min(xend + reach - 1, w) - (1 if short_halo else 0)
        c0 = s0 + 16 * LANES
        c1 = s0 + HDM_TX + 4 * LANES

        def hits(c, n):
            return (c < nhi) & (c + n > nlo)

        need = np.where(hits(c1, 4), 4, 0)
        if es == 1:
            need |= np.where(hits(c0, 16), 1, 0)
        else:
            need |= np.where(hits(c0, 8), 1, 0) | np.where(hits(c0 + 8, 8),
                                                           2, 0)
        # the windows: byte offsets of the slots of P[lo] and P[hi]
        x = x0 + LANES[:, None] + 32 * np.arange(16)          # (32, 16)
        live = x < xend
        xc = np.minimum(x, w - 1)
        a = np.clip(arms[e][LEFT][y, xc], 0, reach)
        p = np.clip(arms[e][RIGHT][y, xc], 0, reach)
        lo = np.maximum(x - a, 0) - s0
        hi = np.minimum(x + p, w) - s0
        bnd = np.where(live, (4 * hdm_slot(lo)) | (4 * hdm_slot(hi)) << 16,
                       0).astype(np.uint32)
        slots = np.full((nwarps, 2, HDM_SLOTS), 0xDEADBEEF, np.uint32)
        slots[:, :, 0] = 0                                    # P[0] = 0
        keys = np.full((nwarps, HDM_SLOTS), np.iinfo(np.int64).max, np.int64)

        for warp in range(nwarps):
            dbeg, dend = warp * dg, min(nd, warp * dg + dg)
            nsteps = -(-(dend - dbeg) // ps) if dbeg < dend else 0

            def row_addr(d):
                return mem.lo + (((e * nd + d) * h + y) * w) * es

            def misalign(d):
                return (row_addr(d) + s0 * es) & 3

            def load_plane(d):
                """One plane's g (32, ng) and t (32, nt) words."""
                g = np.zeros((32, ng), np.uint32)
                t = np.zeros((32, nt), np.uint32)
                if d >= dend:
                    return g, t
                ra = row_addr(d)
                rlo, rhi = ra, ra + w * es
                if vec:
                    for hh in range(es):
                        m = (need >> hh) & 1 == 1
                        addr = ra + (c0 + 8 * hh) * es
                        assert (addr[m] % 16 == 0).all()
                        if m.any():
                            g[m, 4 * hh:4 * hh + 4] = mem.words(
                                addr[m], 4, rlo, rhi, True)
                    m = need & 4 == 4
                    if m.any():
                        t[m] = mem.words(ra + c1[m] * es, nt, rlo, rhi, True)
                else:
                    mb = (ra + c0 * es) & 3
                    assert (mb == misalign(d)).all()
                    for arr, cc, n, bit in ((g, c0, ng, 3), (t, c1, nt, 4)):
                        a0 = cc * es - mb
                        for k in range(n):
                            o = a0 + 4 * k
                            m = (need & bit != 0) & (o + 4 > 0) & (o < w * es)
                            if m.any():
                                arr[m, k] = mem.words(ra + o[m], 1, rlo, rhi,
                                                      False)[:, 0]
                return g, t

            def load_step(s):
                return s, [load_plane(dbeg + s * ps + k) for k in range(ps)]

            def align(words, mbyte, n):
                if vec:
                    return [words[:, q] for q in range(n)]
                sel = 0x3210 + 0x1111 * mbyte
                return [_bperm(words[:, q], words[:, q + 1], sel)
                        for q in range(n)]

            key = np.full((32, 16), np.iinfo(np.int64).max, np.int64)
            ring = [load_step(k) if k < nsteps else None
                    for k in range(HDM_NS)]
            for sb in range(0, nsteps, HDM_NS):
                for k in range(HDM_NS):
                    s = sb + k
                    if s >= nsteps:
                        continue
                    cur = ring[k]
                    assert cur[0] == s                # the slot holds step s
                    d = dbeg + s * ps
                    planes = cur[1]
                    if es == 1:
                        (ga, ta), (gb, tb) = planes
                        ma = 0 if vec else misalign(d)
                        mbb = 0 if vec else misalign(d + 1)
                        av = align(ga, ma, 4) + align(ta, ma, 1)
                        bv = align(gb, mbb, 4) + align(tb, mbb, 1)
                        wds = []
                        for q in range(5):
                            lo_ = _bperm(av[q], bv[q], 0x5140)
                            hi_ = _bperm(av[q], bv[q], 0x7362)
                            wds += [_bperm(lo_, 0, 0x4140),
                                    _bperm(lo_, 0, 0x4342),
                                    _bperm(hi_, 0, 0x4140),
                                    _bperm(hi_, 0, 0x4342)]
                    else:
                        (gg, tt), = planes
                        mm = 0 if vec else misalign(d)
                        wds = []
                        for v in align(gg, mm, 8) + align(tt, mm, 2):
                            wds += [(v & 0xFFFF).astype(np.uint16).view(
                                        np.int16).astype(np.int32).view(
                                        np.uint32),
                                    (v.view(np.int32) >> 16).view(np.uint32)]
                    if s + HDM_NS < nsteps:           # once the words are out
                        ring[k] = load_step(s + HDM_NS)
                    c = np.cumsum(np.stack(wds[:16], 1), 1, dtype=np.uint32)
                    hh_ = np.cumsum(np.stack(wds[16:], 1), 1, dtype=np.uint32)
                    i0, i1 = c[:, 15].copy(), hh_[:, 3].copy()
                    o = 1
                    while o < 32:                     # __shfl_up_sync scan
                        n0 = np.where(LANES >= o, np.roll(i0, o), i0)
                        n1 = np.where(LANES >= o, np.roll(i1, o), i1)
                        i0 = np.where(LANES >= o, i0 + n0, i0)
                        i1 = np.where(LANES >= o, i1 + n1, i1)
                        o *= 2
                    b0 = i0 - c[:, 15]
                    b1 = i0[31] + i1 - hh_[:, 3]
                    buf = slots[warp, s & 1]
                    for i in range(15):
                        sl = 17 * LANES + 1 + i
                        assert len(set(sl % 32)) == 32        # no conflict
                        buf[sl] = b0 + c[:, i]
                    buf[17 * LANES + 17] = b0 + c[:, 15]
                    for i in range(4):
                        buf[hdm_slot(HDM_TX + 1 + 4 * LANES + i)] = (
                            b1 + hh_[:, i])
                    # __syncwarp; each output a difference of two slots
                    r = (buf[(bnd >> 16) // 4] - buf[(bnd & 0xFFFF) // 4])
                    if wta:
                        ri = r.view(np.int32).astype(np.int64)
                        if wide:
                            kk = ri * 2 ** 32 + d
                        else:
                            kk = ri * 256 + d
                            assert (np.abs(kk) < 2 ** 31).all()
                        key = np.minimum(key, kk)
                        continue
                    two = d + 1 < dend
                    o16 = out.reshape(-1)
                    for j in range(16):               # 64 bytes a warp
                        m = x[:, j] < xend
                        at = ((e * nd + d) * h + y) * w + x[m, j]
                        o16[at] = (r[m, j] & 0xFFFF).astype(
                            np.uint16).view(np.int16)
                        writes.reshape(-1)[at] += 1
                        if two:
                            o16[at + h * w] = (r[m, j] >> 16).astype(
                                np.uint16).view(np.int16)
                            writes.reshape(-1)[at + h * w] += 1
            if wta:
                keys[warp, hdm_slot(x - x0)] = key
        if wta:
            # __syncthreads; the block's threads reduce the warps' keys
            k = np.arange(xend - x0)
            best = keys[:, hdm_slot(k)].min(0)
            arg = best & (2 ** 32 - 1 if wide else 255)
            out[e][y, x0 + k] = (arg - zd).astype(np.float32)
            writes[e, y, x0 + k] += 1
    return (tuple(out) if wta else out), writes


def _hdm_case(h, w, nd, reach, seed, wta, lo=None, hi=None, arm_lo=-2):
    rng = np.random.default_rng(seed)
    if wta:
        lo = 0 if lo is None else lo
        hi = 17_300 if hi is None else hi
        vol = rng.integers(lo, hi, (2 * nd, h, w)).astype(np.int16)
    else:
        vol = rng.integers(0, 256, (2 * nd, h, w)).astype(np.uint8)
    arms = [rng.integers(arm_lo, reach + 6, (4, h, w)).astype(np.int32)
            for _ in range(2)]
    return vol, arms


def _hdm_check(vol, al, ar, reach, wta, base=0, zd=3):
    got, writes = emulate_hdm(vol, al, ar, reach, wta, zd=zd, base=base)
    assert (writes == 1).all()
    if wta:
        want = tband.pass4_wta_dm_plain(_t(vol), _t(al), _t(ar), zd, reach)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g, wv.numpy())
    else:
        want = tband.pass1_dm_plain(_t(vol), _t(al), _t(ar), reach)
        np.testing.assert_array_equal(got, want.numpy())


# (h, w, nd, reach, base): W = 1001 (rows not 16-byte aligned: words
# shifted into place) at reach 0, 34 and 64, W = 1, 15, 17 on 37 rows
# (fewer columns than a segment), D = 30 on unaligned and aligned rows,
# an aligned width whose base is one element off 16 bytes, an odd D (u8:
# a last step of one plane; int16: warps without planes), three segments,
# and W = 1000 (int16 rows aligned, the last 16-column group half in the
# row; u8 rows not)
HDM_CASES = [(3, 1001, 4, 34, 0), (3, 1001, 4, 0, 0), (3, 1001, 4, 64, 0),
             (37, 1, 3, 34, 0), (37, 15, 3, 34, 0), (37, 17, 3, 34, 0),
             (2, 1001, 30, 34, 0), (2, 1920, 30, 34, 0),
             (2, 1920, 4, 34, 1), (3, 1024, 5, 34, 0), (2, 1300, 3, 5, 0),
             (2, 1000, 3, 5, 0)]


@pytest.mark.parametrize("wta", [False, True], ids=["B18a", "B18c"])
@pytest.mark.parametrize("h,w,nd,reach,base", HDM_CASES)
def test_hdm_matches_plain(h, w, nd, reach, base, wta):
    vol, (al, ar) = _hdm_case(h, w, nd, reach, 10 * w + nd + reach, wta)
    _hdm_check(vol, al, ar, reach, wta, base)


@pytest.mark.parametrize("w", [1001, 1920])
def test_hdm_wta_sums_past_2_21(w):
    """B18c on inputs of 30000..32767 under arms of 64: window sums pass
    2^21, and the keys sum * 256 + d stay inside int32."""
    vol, (al, ar) = _hdm_case(2, w, 6, 64, w, True, 30_000, 32_768, 64)
    top = int(tband._span_dm(_t(vol[:6]), _t(al[LEFT]), _t(al[RIGHT]), 2,
                             64).max())
    assert top > 2 ** 21
    _hdm_check(vol, al, ar, 64, True)


def test_hdm_wta_takes_the_first_minimum():
    """Few levels and a block of equal planes: ties go to the least d,
    within a warp's planes and across the block's plane groups."""
    vol, (al, ar) = _hdm_case(3, 1001, 12, 34, 5, True, 0, 3)
    vol[:, :, 300:700] = 2
    _hdm_check(vol, al, ar, 34, True)
    got, _ = emulate_hdm(vol, al, ar, 34, True, zd=3)
    assert (got[0][:, 334:666] == -3).all()


def test_hdm_wta_wide_keys_past_256_planes():
    """D > 256: the WTA's keys take 64 bits (sum * 2^32 + d)."""
    vol, (al, ar) = _hdm_case(2, 40, 260, 5, 11, True, 0, 40)
    _hdm_check(vol, al, ar, 5, True)


def test_hdm_pass1_packed_halves_wrap():
    """Pass 1's packed words: plane d's sums carry into plane d + 1's half
    of the running prefix (a row of 255s passes 2^16 within a segment),
    and the word differences still give both planes exactly."""
    vol, (al, ar) = _hdm_case(2, 1920, 4, 64, 3, False, arm_lo=64)
    vol[:] = 255
    vol[1::2, :, ::3] = 7
    _hdm_check(vol, al, ar, 64, False)
    assert 640 * 255 > 2 ** 16


def test_hdm_with_a_halo_one_column_short_fails():
    """The broken variant: the loaded columns end one before the last one
    a window reaches (here the first segment's last output at its full
    right arm), so some sums miss a column."""
    vol, (al, ar) = _hdm_case(2, 1001, 4, 34, 13, False, arm_lo=34)
    got, _ = emulate_hdm(vol, al, ar, 34, False, short_halo=True)
    want = tband.pass1_dm_plain(_t(vol), _t(al), _t(ar), 34).numpy()
    assert (got != want).any()
    got, _ = emulate_hdm(vol, al, ar, 34, False)
    np.testing.assert_array_equal(got, want)
