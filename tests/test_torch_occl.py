"""The occlusion stage on the CPU: the fused masks' plain version
(`dibr_occl_masks`: B7's hits and B11's bleed of both eyes) against the
JAX package's Pallas kernels in interpret mode (r = 1) and its XLA ops
(r = 2, 3), and numpy replays of csrc/occl.cu's decomposition (hits
scattered as bytes, packed into 32-bit bit rows four bytes a multiply,
bands of rows with their halo, popc counts on 32-bit fields, B7's row
segments, flat 16-byte stores with a head and a tail) against the plain
versions; a replay with one deliberate break must differ.  Change the
kernel and its replay together.

Exact throughout: these stages are integer and flag work.  The inputs are
numpy arrays from seeds: a crop of the bud pair's size with seeded
integer and fractional disparities.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.ops.postkern import (
    dcc_occl_kern, filter_bleed_mask_kern)

from stereo_to_multiview_tpu_torch import config as tconfig
from stereo_to_multiview_tpu_torch.models.pipeline import synth_disp_bounds
from stereo_to_multiview_tpu_torch.ops import dcc as tdcc, dibr as tdibr

torch.set_num_threads(1)

H, W = 40, 150                  # a crop of the bud pair's size
ND, ZD = 12, 6

# csrc/occl.cu: B11's u8 entry's band, a block's shared memory, the SMs
# the fused stage's band rule counts on an H100
OCCL_U8_ROWS, OCCL_SMEM_MAX, NSM = 2, 232448, 132


def occl_band(h):
    """The fused stage's band: about three blocks an SM, 4 to 16 rows."""
    return min(16, max(4, -(-2 * h // (3 * NSM))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _disps(seed, h, w, nd, zd, scale=1.0):
    """Disparities in [-zd, nd - zd - 1], fractional (of both signs), half
    of them rounded to integers, then scaled: their truncations stay in
    the bounds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        d = (rng.random((h, w)) * (nd - 1) - zd).astype(np.float32)
        d = np.where(rng.random((h, w)) < 0.5, np.round(d), d)
        out.append((d * np.float32(scale)).astype(np.float32))
    return out


def _sparse_disps(seed, h, w, density=0.35):
    """Disparities whose hits cover about `density` of each row (every
    writer lands on a column drawn from a random subset), moved half a
    column away from zero (their truncations stay put): bleed counts
    around the threshold."""
    rng = np.random.default_rng(seed)
    x = np.arange(w)
    out = []
    for sign in (+1, -1):           # dl writes x + d, dr writes x - d
        d = np.empty((h, w), np.float32)
        for y in range(h):
            cols = np.flatnonzero(rng.random(w) < density)
            cols = cols if cols.size else np.array([w // 2])
            d[y] = sign * (rng.choice(cols, w) - x)
        out.append((d + np.sign(d) * 0.5).astype(np.float32))
    return out


def _bounds(name):
    """(num_disp, zero_disp) the disparities are drawn in, the bounds
    the JAX kernels are given, and the disparities' scale: the small
    configuration's own, or the LOWRES preset's disparities scaled by
    1 / disp_scale under the synthesis' bounds (`synth_disp_bounds`)."""
    if name == "small":
        return ND, ZD, ND, ZD, 1.0
    cfg = tconfig.HD1080_LOWRES
    nd, zd = synth_disp_bounds(cfg)
    return cfg.num_disp, cfg.zero_disp, nd, zd, 1.0 / cfg.disp_scale


@pytest.mark.parametrize("bounds", ["small", "LOWRES synthesis"])
def test_fused_masks_match_pallas_kernels_at_r1(bounds):
    """r = 1: JAX `dcc_occl_kern` (hits) then `filter_bleed_mask_kern`,
    both in interpret mode."""
    nd0, zd0, nd, zd, scale = _bounds(bounds)
    dl, dr = _disps(41, H, W, nd0, zd0, scale)
    occl = dcc_occl_kern(jnp.asarray(dl), jnp.asarray(dr),
                         with_labels=False, num_disp=nd, zero_disp=zd,
                         interpret=True)
    ref = filter_bleed_mask_kern(*occl, radius=1, interpret=True)
    got = tdibr.dibr_occl_masks(_t(dl), _t(dr), 1)
    for a, b in zip(ref, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("radius", [2, 3])
@pytest.mark.parametrize("bounds", ["small", "LOWRES synthesis"])
def test_fused_masks_match_xla_ops(bounds, radius):
    """r = 2, 3 (where the edge rule is no mirror padding): JAX
    `dibr_occl`, `filter_bleed`, `dibr_occl_to_mask`."""
    nd0, zd0, nd, zd, scale = _bounds(bounds)
    dl, dr = _disps(42 + radius, H, W, nd0, zd0, scale)
    occl = jops.dibr_occl(jnp.asarray(dl), jnp.asarray(dr), num_disp=nd,
                          zero_disp=zd)
    ref = [jops.dibr_occl_to_mask(jops.filter_bleed(o, radius))
           for o in occl]
    got = tdibr.dibr_occl_masks(_t(dl), _t(dr), radius)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_fused_masks_wrapper_rejects_other_devices():
    """On a tensor neither on the CPU nor on CUDA the wrapper raises (no
    silent fallback)."""
    m = torch.empty((4, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tdibr.dibr_occl_masks(m, m, 1)


# ---------------------------------------------------------------------
# The replay of csrc/occl.cu
# ---------------------------------------------------------------------

def bit_stride(w):
    return (w + 31) // 32 + 1


def hit_target(d, x, sign, w):
    """clamp(x + sign * trunc(d), 0, W - 1), the offset clamped first."""
    q = int(np.clip(np.trunc(np.float64(d)), -w, w))
    return min(max(x + sign * q, 0), w - 1)


def scatter_row(drow, sign, w, hit, lo=0, hi=None):
    """A row's warp steps (chunks of 128 columns, 4 a lane): each column's
    target with a byte of 1 in `hit`, which holds the targets [lo, hi)."""
    hi = w if hi is None else hi
    for c0 in range(0, w, 128):
        for lane in range(32):
            for j in range(4):
                x = c0 + 4 * lane + j
                if x < w:
                    t = hit_target(drow[x], x, sign, w)
                    if lo <= t < hi:
                        hit[t - lo] = 1


def pack4(u):
    """Four bytes of 0/1 -> four bits: the multiply, wrapped to 32 bits."""
    return ((u * 0x01020408) & 0xffffffff) >> 24


def pack_row(scratch, off, nw, bits, base):
    """Bit row from a byte row: each word from its 32 bytes, four at a
    time, the scratch zeroed as it is read."""
    for wd in range(nw):
        q = scratch[off + 32 * wd:off + 32 * wd + 32].view("<u4")
        bits[base + wd] = np.uint32(sum(pack4(int(u)) << (4 * i)
                                        for i, u in enumerate(q)))
        scratch[off + 32 * wd:off + 32 * wd + 32] = 0


def field32(bits, base, a):
    """__funnelshift_r of the word holding column a and the next."""
    lo, hi = int(bits[base + (a >> 5)]), int(bits[base + (a >> 5) + 1])
    return ((hi << 32 | lo) >> (a & 31)) & 0xffffffff


def low_bits(n):
    return 0xffffffff if n >= 32 else (1 << n) - 1


def bleed_index(i, off, n, mirror=False):
    s = i + off
    if s < 0:
        s = -s
    if s > n - 1:
        return 2 * (n - 1) - s if mirror else n - 1 - off
    return s


class BitRows:
    """Bit rows lo .. lo + rows - 1 in a shared-memory array; a row
    outside reads as zeros (a window one row short then shows)."""

    def __init__(self, bits, lo, rows, stride):
        self.bits, self.lo, self.rows, self.stride = bits, lo, rows, stride

    def _base(self, k):
        return (k - self.lo) * self.stride if 0 <= k - self.lo < self.rows \
            else None

    def field(self, k, a, n):
        base = self._base(k)
        return 0 if base is None else (field32(self.bits, base, a)
                                       & low_bits(n))

    def one(self, y, x):
        base = self._base(y)
        return base is not None and bool(
            (int(self.bits[base + (x >> 5)]) >> (x & 31)) & 1)


class ByteRows:
    def __init__(self, plane):
        self.p = plane

    def field(self, k, a, n):
        return sum(int(self.p[k, a + j] != 0) << j for j in range(n))

    def one(self, y, x):
        return self.p[y, x] == 1


def span_count(src, k, a, b):
    c = 0
    while a < b:
        c += bin(src.field(k, a, min(32, b - a))).count("1")
        a += 32
    return c


def row_count(src, k, x, r, w):
    c = span_count(src, k, max(0, x - r), min(w, x + r + 1))
    if x < r:
        c += span_count(src, k, 1, r - x + 1)
    if x + r > w - 1:
        c += span_count(src, k, w - 1 - r, x)
    return c


def mask_at(src, y, x, h, w, r, thresh, mirror):
    cnt = sum(row_count(src, bleed_index(y, dy, h, mirror), x, r, w)
              for dy in range(-r, r + 1))
    return 1.0 if (np.float32(cnt) > thresh or src.one(y, x)) else 0.0


def field_r1(src, k, x0, w):
    """The 6 bits of columns x0 - 1 .. x0 + 4 of row k at r = 1, column -1
    read as column 1 and column w as column w - 2."""
    if x0 >= 1 and x0 + 4 <= w - 1:
        return src.field(k, x0 - 1, 6)
    f = 0
    for j in range(6):
        c = x0 - 1 + j
        c = -c if c < 0 else 2 * (w - 1) - c if c > w - 1 else c
        f |= src.field(k, c, 1) << j
    return f


def count_store(src, mask, y0, y1, h, w, r, thresh, mirror=False):
    """Flat chunks of four floats from the band's first 16-byte boundary
    (the plane's base aligned), the head and tail one float; at r = 1
    every chunk inside one row counts from fields (its edge columns read
    as their mirrors), the three rows added bit-sliced (sum and carry
    planes)."""
    out = mask.reshape(-1)
    base, n = y0 * w, (y1 - y0) * w
    head = min(n, (4 - (base & 3)) & 3)
    nvec = (n - head) >> 2
    narrow, win = 2 * r + 4 <= 32, low_bits(2 * r + 1)
    for v in range(nvec):
        f = head + 4 * v
        y = y0 + f // w
        x0 = f - (y - y0) * w
        fast = (x0 + 4 <= w if r == 1
                else narrow and x0 >= r and x0 + 3 + r <= w - 1)
        if fast and r == 1:
            # the three rows added bit-sliced: sum and carry planes
            fa, fb, fc = (field_r1(src, bleed_index(y, dy, h, mirror), x0, w)
                          for dy in (-1, 0, 1))
            s0, s1 = fa ^ fb ^ fc, (fa & fb) | (fa & fc) | (fb & fc)
            c = [bin(s0 & (7 << i)).count("1")
                 + 2 * bin(s1 & (7 << i)).count("1") for i in range(4)]
        elif fast:
            c = [0, 0, 0, 0]
            for dy in range(-r, r + 1):
                fl = src.field(bleed_index(y, dy, h, mirror), x0 - r,
                               2 * r + 4)
                for i in range(4):
                    c[i] += bin((fl >> i) & win).count("1")
        if fast:
            m = [1.0 if (np.float32(c[i]) > thresh or src.one(y, x0 + i))
                 else 0.0 for i in range(4)]
        else:
            m = [mask_at(src, y + (x0 + i) // w, (x0 + i) % w, h, w, r,
                         thresh, mirror) for i in range(4)]
        out[base + f:base + f + 4] = m
    for f in list(range(min(head, n))) + list(range(head + 4 * nvec, n)):
        out[base + f] = mask_at(src, y0 + f // w, f % w, h, w, r, thresh,
                                mirror)


def byte_pitch(w):
    return (w + 31) // 32 * 32


def replay_fused(dl, dr, r, band=None, group=None, short_halo=False,
                 mirror=False):
    """`stm_occl_masks` in one launch: a block a band of rows and eye; the
    window's rows scattered into `group` byte rows at a time and packed
    into bit rows, then count_store.  `short_halo` and `mirror` break it
    on purpose (a window one row short at the bottom; mirror padding in
    place of the past-the-end rule)."""
    h, w = dl.shape
    band = occl_band(h) if band is None else band
    stride, pitch = bit_stride(w), byte_pitch(w)
    assert 2 * r + 1 <= (OCCL_SMEM_MAX - pitch) // (stride * 4)
    thresh = np.float32(tdibr.bleed_thresh(r))
    masks = [np.full((h, w), np.nan, np.float32) for _ in range(2)]
    for e, (d, sign) in enumerate(((dr, -1), (dl, +1))):
        for y0 in range(0, h, band):
            y1 = min(h, y0 + band)
            lo, hi = max(0, y0 - r), min(h, y1 + r - short_halo)
            rows = hi - lo
            gs = rows if group is None else group
            bits = np.zeros(rows * stride, np.uint32)
            scratch = np.zeros(min(gs, rows) * pitch, np.uint8)
            for g0 in range(0, rows, gs):
                gn = min(gs, rows - g0)
                for k in range(gn):
                    scatter_row(d[lo + g0 + k], sign, w,
                                scratch[k * pitch:(k + 1) * pitch])
                for k in range(gn):
                    pack_row(scratch, k * pitch, stride - 1, bits,
                             (g0 + k) * stride)
                assert not scratch.any()
            count_store(BitRows(bits, lo, rows, stride), masks[e], y0, y1,
                        h, w, r, thresh, mirror)
    return masks


def replay_bleed_u8(occl, r):
    """`stm_bleed_mask`: the same count_store, hits read from the plane."""
    h, w = occl.shape
    mask = np.full((h, w), np.nan, np.float32)
    for y0 in range(0, h, OCCL_U8_ROWS):
        count_store(ByteRows(occl), mask, y0, min(h, y0 + OCCL_U8_ROWS), h, w,
                    r, np.float32(tdibr.bleed_thresh(r)))
    return mask


def replay_dcc(dl, dr, labels, thresh=1.0, seg=None):
    """`stm_dcc`: a block a row and segment of `seg` output columns, both
    eyes' hits of the segment as bytes laid out `pad` bytes into their
    slot, then the segment's bytes in chunks (16 bytes of hits copied
    from the byte rows, 4 of labels) from its first chunk boundary, head
    and tail a byte."""
    h, w = dl.shape
    seg = w if seg is None else seg
    out_l, out_r = (np.full((h, w), 255, np.uint8) for _ in range(2))
    th = np.float32(thresh)

    def label(own, other, hit, x, sign):
        a = own[x]
        b = other[hit_target(a, x, sign, w)]
        if not np.abs(np.float32(a - b)) > th:
            return 0
        return 1 if hit else 2

    for y in range(h):
        row = y * w
        for c0 in range(0, w, seg):
            c1 = min(w, c0 + seg)
            pad = (row + c0) & 15
            slot = (seg + 16 + 15) // 16 * 16
            sm_l, sm_r = np.zeros(slot, np.uint8), np.zeros(slot, np.uint8)
            scatter_row(dl[y], +1, w, sm_r[pad:], c0, c1)
            scatter_row(dr[y], -1, w, sm_l[pad:], c0, c1)

            def one(x):
                hl, hr = sm_l[pad + x - c0], sm_r[pad + x - c0]
                if labels:
                    return (label(dl[y], dr[y], hl, x, +1),
                            label(dr[y], dl[y], hr, x, -1))
                return hl, hr

            lc = 4 if labels else 16
            n = c1 - c0
            head = min(n, (lc - (pad & (lc - 1))) & (lc - 1))
            nvec = (n - head) // lc
            for v in range(nvec):
                x0 = c0 + head + lc * v
                assert (row + x0) % lc == 0 and (pad + x0 - c0) % lc == 0
                for x in range(x0, x0 + lc):
                    out_l[y, x], out_r[y, x] = one(x)
            for x in (list(range(c0, c0 + head))
                      + list(range(c0 + head + lc * nvec, c1))):
                out_l[y, x], out_r[y, x] = one(x)
    return out_l, out_r


def _edge_disps(seed, h, w):
    """Disparities that reach every edge case of the scatter: fractional
    ones of both signs, writers past both borders, values far outside the
    row (past int32), all-zero rows, and rows whose every writer lands on
    one edge."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        d = (rng.integers(-w - 3, w + 3, (h, w))
             + rng.random((h, w)) * 1.8 - 0.9).astype(np.float32)
        d = np.where(rng.random((h, w)) < 0.5, np.trunc(d / 4), d)
        d[rng.random((h, w)) < 0.02] = 3e9
        d[rng.random((h, w)) < 0.02] = -3e9
        d[0] = 0.0
        if h > 2:
            d[2] = 2.0 * w
        out.append(d.astype(np.float32))
    return out


# (h, w): widths of one column, below 16 and 32, just past 32 and odd;
# heights below one band
REPLAY_SHAPES = [(5, 1), (9, 15), (7, 33), (3, 1001), (12, 40)]


def _radii(h, w):
    return [r for r in (0, 1, 2, 3) if r < min(h, w)]


@pytest.mark.parametrize("h,w", REPLAY_SHAPES)
def test_fused_replay_equals_plain(h, w):
    """The kernel's bands (its rule's, 8 rows, and 3 rows: more seams),
    halo rows, byte rows scattered a group at a time (all, or two: more
    groups),
    bit rows and counts equal the plain version at every radius the
    plane admits up to 3, on the edge cases' disparities and on sparse
    hits."""
    for dl, dr in (_edge_disps(h * 1000 + w, h, w),
                   _sparse_disps(h * 1000 + w, h, w)):
        for r in _radii(h, w):
            ref = [_np(m) for m in tdibr.dibr_occl_masks_plain(
                _t(dl), _t(dr), r)]
            for band, group in ((None, None), (8, None), (3, 2)):
                got = replay_fused(dl, dr, r, band, group)
                for a, b in zip(ref, got):
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"r={r} band={band} group={group}")


@pytest.mark.parametrize("h,w", REPLAY_SHAPES)
def test_bleed_u8_replay_equals_plain(h, w):
    """B11's u8 entry: the same count and store on a plane of 0, 1 and 2
    (a 2 counts but does not pass as itself)."""
    occl = np.random.default_rng(w).integers(0, 3, (h, w)).astype(np.uint8)
    for r in _radii(h, w):
        np.testing.assert_array_equal(
            _np(tdibr.dibr_bleed_mask_plain(_t(occl), r)),
            replay_bleed_u8(occl, r))


@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("h,w", REPLAY_SHAPES)
def test_dcc_replay_equals_plain(h, w, labels):
    """B7's blocks of a row (one segment, or segments narrower than the
    row, down to 7 columns: writers land outside their block's segment),
    byte rows and 16-byte stores: hits and labels."""
    dl, dr = _edge_disps(h * 1000 + w + 1, h, w)
    if labels:
        ref = tdcc.dr_dcc_plain(_t(dl), _t(dr), 1.0)
    else:
        ref = tdibr.dibr_occl_plain(_t(dl), _t(dr))
    for seg in ((None, 7, 40) if w < 100 else (None, 40, 333)):
        for a, b in zip(ref, replay_dcc(dl, dr, labels, seg=seg)):
            np.testing.assert_array_equal(_np(a), b, err_msg=f"seg={seg}")


@pytest.mark.parametrize("break_", ["halo one row short", "mirror padding"])
def test_broken_replay_differs(break_):
    """A replay with one deliberate break must fail against the plain
    version: the window one row short, or mirror padding in place of the
    past-the-end rule at r = 2 (at r = 1 the two agree)."""
    h, w, r = 20, 33, 2
    dl, dr = _sparse_disps(47, h, w)
    ref = [_np(m) for m in tdibr.dibr_occl_masks_plain(_t(dl), _t(dr), r)]
    kw = ({"short_halo": True} if break_ == "halo one row short"
          else {"mirror": True})
    got = replay_fused(dl, dr, r, **kw)
    assert any(not np.array_equal(a, b) for a, b in zip(ref, got))
    if break_ == "mirror padding":
        ref1 = [_np(m) for m in tdibr.dibr_occl_masks_plain(_t(dl), _t(dr),
                                                            1)]
        for a, b in zip(ref1, replay_fused(dl, dr, 1, mirror=True)):
            np.testing.assert_array_equal(a, b)
