"""Replays of the streamed kernels B13 (csrc/hslo.cu) and B3
(csrc/shear.cu) in Python, index for index, each held against its
kernel's plain version (`dc_hslo_wta_plain`, `shear_right_plain`).

B13: the launch's rows of both eyes (row -> eye, sign, own and other
gray), the flag bits (the own image's at x, the other's padded by the
reach and reversed for sign -1, read K at a time by a funnel shift), the
ring of units of HSLO_SEG columns that each lane fills by cp.async and
reads back itself, the forward pass's checkpoints every HSLO_SEG
columns, and the backward pass that recomputes a segment's forward
values from the checkpoint before it and walks the segment back.  B3:
the ring of pair columns that a warp slides along a row for one 128-byte
chunk of d, the words each lane copies and reads, and the E words it
keeps to assemble each output word; and the staged tiles of the scalar
path (D % 4 != 0).

The asynchronous copies are replayed as groups that land only when a
wait lets them: a read of a ring slot whose copy has not landed reads
stale data, and the replay then disagrees with the plain version.  The
JAX package's TPU kernel (interpret mode) is held against the two-eye
wrapper too.  No card is needed: this runs on the CPU in seconds; change
a kernel and its replay together.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu.ops.hslo import dc_hslo_hwd
from stereo_to_multiview_tpu.ops.hslokern import dc_hslo_wta_kern

from stereo_to_multiview_tpu_torch.ops import costkern as tck
from stereo_to_multiview_tpu_torch.ops import hslokern as thk
from stereo_to_multiview_tpu_torch.ops.hslo import tier_penalties

torch.set_num_threads(1)

SEG, UNITS = 8, 2          # csrc/hslo.cu HSLO_SEG, HSLO_UNITS
BIG = np.float32(1e30)
F32 = np.float32
M32 = 0xFFFFFFFF


class _Copies:
    """cp.async of one thread: copies issued into the current group land
    when `wait(n)` leaves at most n groups in flight (as late as they
    may), or at once with `early` (as early as they may: a copy into a
    slot still being read then overwrites it)."""

    early = False

    def __init__(self):
        self.groups, self.cur = [], []

    def copy(self, dst, idx, value):
        if self.early:
            dst[idx] = value
        else:
            self.cur.append((dst, idx, value))

    def commit(self):
        self.groups.append(self.cur)
        self.cur = []

    def wait(self, n):
        while len(self.groups) > n:
            for dst, idx, value in self.groups.pop(0):
                dst[idx] = value


# ---- B13 -----------------------------------------------------------------

def _hslo_k(nd):
    k = -(-nd // 32)
    return 1 if k <= 1 else 2 if k <= 2 else 4 if k <= 4 else 8


def _small(row, x, T):
    return F32(abs(int(row[x]) - int(row[max(x - 1, 0)]))) < F32(T)


def _flags(ra, rb, w, p, sign, T):
    """hslo_flags: the own bits sa[x] and the other image's ob[i], as
    32-bit words."""
    nwa, nwb = (w + 31) >> 5, (w + 2 * p) // 32 + 2
    sa = [0] * nwa
    ob = [0] * nwb
    for wi in range(nwa):
        for lane in range(32):
            if _small(ra, min((wi << 5) + lane, w - 1), T):
                sa[wi] |= 1 << lane
    for wi in range(nwb):
        for lane in range(32):
            xp = (wi << 5) + lane - p
            if sign < 0:
                xp = w - 1 - xp
            if _small(rb, min(max(xp, 0), w - 1), T):
                ob[wi] |= 1 << lane
    return sa, ob


def _prep(row, x0):
    """HsloRow::prep's flag words of a unit's columns x0 .. x0 + SEG - 1:
    per lane and column, the other image's bits of the lane's K d (bits
    0..K-1, from one funnel-shifted window) and the own flag (bit 16)."""
    sa, ob, p1, p2, w, nd, k, sign, ibase = row
    own = sa[x0 >> 5] >> (x0 & 31)
    tb = np.zeros((SEG, 32), np.int64)
    for lane in range(32):
        lo = (x0 if sign > 0 else w - x0 - SEG) + ibase[lane]
        win = ((ob[lo >> 5] | ob[(lo >> 5) + 1] << 32) >> (lo & 31)) & M32
        for i in range(SEG):
            o = i if sign > 0 else SEG - 1 - i
            tb[i, lane] = ((win >> o) & ((1 << k) - 1)) | ((own >> i) & 1) << 16
    return tb


def _step(prev, c, tb, row):
    """HsloRow::step over the padded d (32 * K values, lane l owning
    l * K .. l * K + K - 1) with the column's flag words tb (one a lane);
    float32 throughout."""
    sa, ob, p1, p2, w, nd, k, sign, ibase = row
    mn = F32(prev.min())
    up = np.append(prev[1:], BIG).astype(F32)
    dn = np.insert(prev[:-1], 0, BIG).astype(F32)
    s1 = (tb >> 16) & 1
    s2 = np.array([(tb[d // k] >> (d % k)) & 1 for d in range(32 * k)])
    t = s1.repeat(k) + s2
    q1 = np.array(p1, F32)[t]
    q2 = np.array(p2, F32)[t]
    best = np.minimum(np.minimum(prev, (mn + q2).astype(F32)),
                      (np.minimum(up, dn) + q1).astype(F32))
    out = ((c + best).astype(F32) - mn).astype(F32)
    out[nd:] = BIG
    return out


def _wta(f, b, nd, k, zd):
    """hslo_wta: the lanes' own first minima, then the least key and the
    least lane holding it."""
    a = (((f + b).astype(F32)) * F32(0.5)).astype(F32)
    a[nd:] = BIG
    lanes = a.reshape(32, k)
    best = [lanes[l, 0] for l in range(32)]
    arg = [l * k for l in range(32)]
    for l in range(32):
        for j in range(1, k):
            if lanes[l, j] < best[l]:
                best[l], arg[l] = lanes[l, j], l * k + j
    keys = [F32(best[l]) if l * k < nd else np.inf for l in range(32)]
    m = min(keys)
    return F32(arg[keys.index(m)] - zd)


def _replay_row(vrow, ra, rb, sign, nd, zd, T, p1, p2):
    """One warp of hslo_kernel: the forward pass through the ring and its
    checkpoints, then the backward segments; returns the row's
    disparities."""
    w = vrow.shape[0]
    k = _hslo_k(nd)
    dp = 32 * k
    p = max(zd, dp - 1 - zd, 0) + SEG
    sa, ob = _flags(ra, rb, w, p, sign, T)
    ibase = [lane * k - zd + p for lane in range(32)]
    row = (sa, ob, p1, p2, w, nd, k, sign, ibase)
    nseg = -(-w // SEG)
    ring = np.zeros((UNITS, SEG + 1, dp), np.uint32)
    ckpt = np.zeros((max(nseg - 1, 1), dp), F32)
    cp = _Copies()
    bits = vrow.astype(np.int32).view(np.uint32)

    def fill_cols(slot, x0):
        for i in range(SEG):
            if x0 + i < w:
                for d in range(nd):
                    cp.copy(ring, (slot, 1 + i, d), bits[x0 + i, d])

    def cost(slot, i):
        c = ring[slot, 1 + i].view(np.int32).astype(F32)
        c[nd:] = BIG
        return c

    # forward
    for q in range(UNITS - 1):
        if q < nseg:
            fill_cols(q % UNITS, q * SEG)
        cp.commit()
    prev = None
    for u in range(nseg):
        un = u + UNITS - 1
        if un < nseg:
            fill_cols(un % UNITS, un * SEG)
        cp.commit()
        cp.wait(UNITS - 1)
        tb = _prep(row, u * SEG)
        for i in range(SEG):
            x = u * SEG + i
            if x < w:
                c = cost(u % UNITS, i)
                prev = c if x == 0 else _step(prev, c, tb[i], row)
        if u < nseg - 1:
            ckpt[u] = prev
    cp.wait(0)

    # backward
    def fill_seg(t):
        kk = nseg - 1 - t
        if kk >= 0:
            if kk > 0:
                for d in range(dp):
                    cp.copy(ring, (t % UNITS, 0, d),
                            ckpt[kk - 1:kk].view(np.uint32)[0, d])
            fill_cols(t % UNITS, kk * SEG)
        cp.commit()

    disp = np.full(w, np.nan, F32)
    fl, b = prev.copy(), None
    for q in range(UNITS - 1):
        fill_seg(q)
    for t in range(nseg):
        fill_seg(t + UNITS - 1)
        cp.wait(UNITS - 1)
        kk = nseg - 1 - t
        x0 = kk * SEG
        n = min(SEG, w - x0)
        slot = t % UNITS
        f = fnext = None
        if kk > 0:
            f = ring[slot, 0].view(F32).copy()
            fnext = f.copy()
        tb = _prep(row, x0)
        fs = [None] * SEG
        for i in range(SEG):
            if i < n:
                if i == SEG - 1:
                    fs[i] = fl.copy()
                else:
                    c = cost(slot, i)
                    f = c if x0 + i == 0 else _step(f, c, tb[i], row)
                    fs[i] = f
        if kk > 0:
            fl = fnext
        for i in range(SEG - 1, -1, -1):
            if i < n:
                x = x0 + i
                c = cost(slot, i)
                b = c if x == w - 1 else _step(b, c, tb[i], row)
                disp[x] = _wta(fs[i], b, nd, k, zd)
    return disp


def _replay_hslo(vols, gray_a, gray_b, nd, zd, T, H1, H2, sign):
    """hslo_kernel over a launch of len(vols) eyes: block r takes eye
    r // H, row r % H; eye 1 swaps the grays and takes -sign."""
    h, w, _ = vols[0].shape
    p1, p2 = tier_penalties(H1, H2)
    out = [np.full((h, w), np.nan, F32) for _ in vols]
    for r in range(len(vols) * h):
        eye, y = int(r >= h), r - h * int(r >= h)
        own, other = (gray_b, gray_a) if eye else (gray_a, gray_b)
        out[eye][y] = _replay_row(vols[eye][y], own[y], other[y],
                                  -sign if eye else sign, nd, zd, T, p1, p2)
    return out


def _hslo_inputs(seed, h, w, nd, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        vol = rng.integers(0, 2, (h, w, nd)) * 7
    else:
        vol = rng.integers(0, 400, (h, w, nd))
    gl = rng.integers(0, 256, (h, w)).astype(np.uint8)
    gr = rng.integers(0, 256, (h, w)).astype(np.uint8)
    gl[:, w // 3:w // 2] = gl[:, w // 3:w // 3 + 1]
    gr[:, w // 4:2 * w // 3] //= 32
    return vol.astype(np.int32), gl, gr


@pytest.mark.parametrize("h, w, nd, zd, pen, ties", [
    (2, 1, 12, 5, (40.0, 120.0), False),      # one column
    (2, 15, 12, 6, (40.0, 120.0), False),     # below two segments
    (2, 17, 126, 63, (40.0, 120.0), False),   # a short last segment, K=4
    (1, 203, 130, 65, (40.0, 120.0), False),  # K=8, 26 segments
    (1, 203, 12, 0, (40.0, 120.0), False),    # zd = 0: reach to one side
    (2, 40, 30, 15, (40.0, 120.0), True),     # ties: first-min rule
    (1, 33, 32, 16, (0.0, 0.0), False),       # zero penalties, K=1 full
    (1, 33, 64, 32, (5000.0, 9000.0), False),  # above every cost, K=2
])
@pytest.mark.parametrize("early", [False, True])
def test_hslo_replay_matches_plain(h, w, nd, zd, pen, ties, early,
                                   monkeypatch):
    """Both eyes in one launch, as band_stereo_core_chunked calls it,
    and one eye with sign -1, against the plain version of each; the
    copies landing as late and as early as they may."""
    monkeypatch.setattr(_Copies, "early", early)
    vol_l, gl, gr = _hslo_inputs(70 + w + nd, h, w, nd, ties)
    vol_r = np.roll(vol_l, 3, axis=1)
    T, (H1, H2) = 15.0, pen
    got = _replay_hslo((vol_l, vol_r), gl, gr, nd, zd, T, H1, H2, +1)
    t = torch.from_numpy
    for g, v, ga, gb, sign in ((got[0], vol_l, gl, gr, +1),
                               (got[1], vol_r, gr, gl, -1)):
        ref = thk.dc_hslo_wta_plain(t(v), t(ga), t(gb), nd, zd, T, H1, H2,
                                    sign).numpy()
        np.testing.assert_array_equal(g, ref)
    one = _replay_hslo((vol_r,), gr, gl, nd, zd, T, H1, H2, -1)[0]
    np.testing.assert_array_equal(one, got[1])
    if ties:
        wta = np.argmin(vol_l, axis=2) - zd
        last = nd - 1 - np.argmin(vol_l[:, :, ::-1], axis=2) - zd
        assert np.mean(wta != last) > 0.5


def test_hslo_replay_catches_an_early_read():
    """A replay that waits for one group fewer (reads a unit before its
    copy lands) disagrees with the plain version: the copy model bites."""
    vol, gl, gr = _hslo_inputs(80, 1, 40, 12)
    t = torch.from_numpy
    ref = thk.dc_hslo_wta_plain(t(vol), t(gl), t(gr), 12, 6, 15.0, 40.0,
                                120.0, +1).numpy()
    orig_wait = _Copies.wait
    try:
        _Copies.wait = lambda self, n: orig_wait(self, n + 1)
        bad = _replay_hslo((vol,), gl, gr, 12, 6, 15.0, 40.0, 120.0, +1)[0]
    finally:
        _Copies.wait = orig_wait
    assert not np.array_equal(bad, ref)


@pytest.mark.parametrize("d, zd", [(16, 8), (12, 5)])
def test_dc_hslo_wta_lr_matches_hslo_kern(d, zd):
    """The two-eye wrapper against the TPU kernel in interpret mode, eye
    by eye (the left with sign +1, the right with -1 and the grays
    swapped).  The port equals argmin(dc_hslo_hwd) of the JAX package
    exactly; the TPU kernel's first forward column is (c + 1e30) - 1e30
    = 0, not c, so it may differ at a few pixels, and exactly where the
    JAX scan differs from it (as tests/test_torch_hslo.py pins for one
    eye)."""
    h, w = 24, 203
    rng = np.random.default_rng(81)
    vol_l = np.round(rng.random((h, w, d)) * 500).astype(np.float32)
    vol_r = np.round(rng.random((h, w, d)) * 500).astype(np.float32)
    gl = rng.integers(0, 256, (h, w)).astype(np.uint8)
    gr = rng.integers(0, 256, (h, w)).astype(np.uint8)
    gl[:, w // 3:w // 2] = gl[:, w // 3:w // 3 + 1]
    gr[:, w // 4:2 * w // 3] //= 32
    t = torch.from_numpy
    got = thk.dc_hslo_wta_lr(t(vol_l.astype(np.int32)),
                             t(vol_r.astype(np.int32)), t(gl), t(gr), d, zd,
                             15.0, 2.0, 6.0)
    for g, vol, ga, gb, sign in ((got[0], vol_l, gl, gr, +1),
                                 (got[1], vol_r, gr, gl, -1)):
        scan = dc_hslo_hwd(jnp.asarray(vol), jnp.asarray(gl),
                           jnp.asarray(gr), d, zd, 15.0, 2.0, 6.0, sign=sign)
        scan_d = np.asarray(jnp.argmin(scan, axis=2) - zd).astype(np.float32)
        kern_d = np.asarray(dc_hslo_wta_kern(
            jnp.swapaxes(jnp.asarray(vol), 0, 1), jnp.asarray(ga),
            jnp.asarray(gb), d, zd, 15.0, 2.0, 6.0, sign=sign,
            interpret=True))
        g = g.numpy()
        assert g.shape == (h, w) and g.dtype == np.float32
        np.testing.assert_array_equal(g, scan_d)
        diff = g != kern_d
        assert np.mean(diff) < 1e-3
        np.testing.assert_array_equal(diff, scan_d != kern_d)


def test_dc_hslo_wta_eyes_counts_and_rejects():
    """The two-eye wrapper on the CPU takes the plain version of each eye
    and counts no launch; on another device it raises."""
    vol, gl, gr = _hslo_inputs(82, 3, 20, 12)
    t = torch.from_numpy
    thk.dc_hslo_wta_eyes.launches = 0
    dl, dr = thk.dc_hslo_wta_lr(t(vol), t(vol), t(gl), t(gr), 12, 6, 15.0,
                                40.0, 120.0)
    assert thk.dc_hslo_wta_eyes.launches == 0
    np.testing.assert_array_equal(dr.numpy(), thk.dc_hslo_wta(
        t(vol), t(gr), t(gl), 12, 6, 15.0, 40.0, 120.0, -1).numpy())
    meta = torch.empty((3, 20, 12), dtype=torch.int32, device="meta")
    g = torch.empty((3, 20), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        thk.dc_hslo_wta_lr(meta, meta, g, g, 12, 6, 15.0, 1.0, 3.0)


# ---- B3 ------------------------------------------------------------------

CHUNK, PF, SCALAR_TX = 128, 1, 192      # csrc/shear.cu
STREAM_TILES = {1: 32, 2: 16, 4: 8}     # TX by element size


def _replay_stream(pair, zd, nxs=1):
    """shear_stream_kernel: a warp per (row, chunk of d, segment of x);
    pair columns into a ring by lane-private words, E words kept to
    assemble each output word.  `nxs` segments of x a row (the launch
    picks it from the card's slots; the replay takes it as given)."""
    h, wp, nd = pair.shape
    es = pair.dtype.itemsize
    e, dcm, tx = 4 // es, CHUNK // es, STREAM_TILES[es]
    m = max(zd, nd - zd)
    w = wp - 2 * m
    nt = 1 + (min(nd, dcm) + tx - 2) // tx + PF
    r_cols = nt * tx
    words = pair.reshape(h, wp, nd // e, e).copy().view(
        np.uint32).reshape(h, wp, nd // e) if e > 1 else pair.view(
        np.uint32)
    out = np.zeros((h, w, nd // e), np.uint32)
    xlen = -(-w // nxs)
    for item in range(h * -(-nd // dcm) * nxs):
        yz, g = divmod(item, nxs)
        y, z = divmod(yz, -(-nd // dcm))
        xa = g * xlen
        nx = min(xlen, w - xa)
        if nx > 0:
            d0 = z * dcm
            dc = min(dcm, nd - d0)
            nr = 1 + (dc + tx - 2) // tx
            nw = dc // e
            cmin = xa + m + zd - d0 - (dc - 1)
            ns = nx + dc - 1
            ring = np.zeros((r_cols, 32), np.uint32)
            cp = _Copies()

            def fill(t):
                for i in range(tx):
                    s = t * tx + i
                    if s < ns:
                        for lane in range(nw):
                            cp.copy(ring, ((t % nt) * tx + i, lane),
                                    words[y, cmin + s, d0 // e + lane])
                cp.commit()

            for t in range(nr + PF - 1):
                fill(t)
            p0 = [dc - 1 - e * lane for lane in range(nw)]
            q = list(p0)
            win = [[0] * e for _ in range(nw)]
            for u in range(-(-nx // tx)):
                fill(u + nr - 1 + PF)
                cp.wait(PF)
                for lane in range(nw):
                    if u == 0:
                        for j in range(e - 1):
                            win[lane][j] = ring[p0[lane] - 1 - j, lane]
                    for i in range(tx):
                        x = u * tx + i
                        if x >= nx:
                            continue
                        win[lane] = [ring[q[lane], lane]] + win[lane][:-1]
                        q[lane] = 0 if q[lane] + 1 == r_cols else q[lane] + 1
                        v = 0
                        for j in range(e):
                            mask = (M32 >> (32 - 32 // e)) << (32 // e * j)
                            v |= int(win[lane][j]) & mask
                        out[y, xa + x, d0 // e + lane] = v
    return out.view(pair.dtype).reshape(h, w, nd)


def _replay_scalar(pair, zd):
    """shear_scalar_kernel: blocks of SCALAR_TX columns of one row and
    one chunk of d, staging SCALAR_TX + dc - 1 columns."""
    h, wp, nd = pair.shape
    dcm = CHUNK // pair.dtype.itemsize
    m = max(zd, nd - zd)
    w = wp - 2 * m
    out = np.zeros((h, w, nd), pair.dtype)
    for y in range(h):
        for z in range(-(-nd // dcm)):
            d0 = z * dcm
            dc = min(dcm, nd - d0)
            for x0 in range(0, w, SCALAR_TX):
                c0 = x0 + m - (d0 + dc - 1 - zd)
                stage = np.zeros((SCALAR_TX + dc - 1, dcm), pair.dtype)
                for j in range(SCALAR_TX + dc - 1):
                    if 0 <= c0 + j < wp:
                        stage[j, :dc] = pair[y, c0 + j, d0:d0 + dc]
                for xi in range(min(SCALAR_TX, w - x0)):
                    for dd in range(dc):
                        out[y, x0 + xi, d0 + dd] = stage[xi + dc - 1 - dd, dd]
    return out


def _replay_shear(pair, zd, nxs):
    """stm_shear_right: the stream where D % 4 == 0, else the scalar
    tiles."""
    if pair.shape[2] % 4 == 0:
        return _replay_stream(pair, zd, nxs)
    return _replay_scalar(pair, zd)


@pytest.mark.parametrize("dtype, h, w, nd, zd, nxs", [
    (np.uint8, 2, 50, 128, 64, 1),    # the main path's chunk, 2 tiles
    (np.uint8, 2, 9, 128, 0, 1),      # zd = 0, W below one tile
    (np.uint8, 1, 40, 128, 128, 1),   # zd = D
    (np.uint8, 1, 37, 64, 32, 1),     # half a chunk (the lowres D)
    (np.uint8, 1, 70, 64, 32, 3),     # ... in three segments of x
    (np.uint8, 1, 21, 132, 66, 1),    # a second chunk of 4 d
    (np.uint8, 1, 41, 132, 0, 2),     # ... two segments, one short
    (np.uint8, 1, 30, 126, 63, 1),    # scalar path
    (np.uint8, 1, 25, 130, 65, 1),    # scalar path, two chunks
    (np.int16, 1, 45, 128, 64, 1),    # two chunks of 64
    (np.int16, 1, 12, 128, 128, 1),   # zd = D, W below one tile
    (np.int16, 1, 37, 128, 64, 4),    # four segments of 10, the last 7
    (np.float32, 1, 30, 128, 64, 1),  # four chunks of 32
    (np.float32, 1, 11, 36, 0, 1),    # zd = 0, a chunk of 4
    (np.float32, 1, 31, 36, 36, 2),   # zd = D, two segments
    (np.float32, 1, 9, 126, 63, 1),   # scalar path
])
@pytest.mark.parametrize("early", [False, True])
def test_shear_replay_matches_plain(dtype, h, w, nd, zd, nxs, early,
                                    monkeypatch):
    monkeypatch.setattr(_Copies, "early", early)
    m = tck.pair_margin(nd, zd)
    rng = np.random.default_rng(90 + nd + w)
    if dtype is np.float32:
        pair = rng.random((h, w + 2 * m, nd)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        pair = rng.integers(info.min, info.max, (h, w + 2 * m, nd),
                            endpoint=True).astype(dtype)
    ref = tck.shear_right_plain(torch.from_numpy(pair), zd).numpy()
    np.testing.assert_array_equal(_replay_shear(pair, zd, nxs), ref)


def test_shear_replay_catches_an_early_read():
    """Waiting for one group fewer reads ring slots before they land."""
    m = tck.pair_margin(128, 64)
    pair = np.random.default_rng(99).integers(
        0, 256, (1, 70 + 2 * m, 128)).astype(np.uint8)
    ref = tck.shear_right_plain(torch.from_numpy(pair), 64).numpy()
    orig_wait = _Copies.wait
    try:
        _Copies.wait = lambda self, n: orig_wait(self, n + 1)
        bad = _replay_stream(pair, 64)
    finally:
        _Copies.wait = orig_wait
    assert not np.array_equal(bad, ref)
