"""Replays of the staged kernels B1 (csrc/arms.cu) and B2 (csrc/cost.cu)
in Python, index for index: B2's blocks of 4 rows x 256 columns, the
gray rows and columns each block stages (`cost_eye_layout`), the census
of four columns at a time in 16-bit lanes (`cost_census4`) or one at a
time at the frame's edges (`cost_census1`), the skewed slots of the
other eye, the 4 x 16 outputs of a thread and the 19 positions they
read; B1's cross-shaped tile and its walks.  Each replay is held against
the kernel's plain version (`cost_pair_plain`, `cross_arms_plain`) on
frames whose shapes reach the kernels' edges: row ranges that start
inside the frame and end at its last row, both signs, D not a multiple
of 16 (D=12, 126, 130), widths below one group of four and above one
block.  A change of either kernel's index logic belongs in its replay
too.  No card is needed: this runs on the CPU in seconds.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import costkern as tck
from stereo_to_multiview_tpu_torch.ops import cross as tcross

torch.set_num_threads(1)

XB, RB, XT, DPT = 256, 4, 4, 16     # csrc/cost.cu COST_XB, _RB, _XT, _DPT
GR = RB + 6
M32 = 0xFFFFFFFF
THIRD = np.float32(0.3333333333333)


def _clamp(v, hi):
    return min(max(v, 0), hi)


def _byte_perm(x, y, s):
    """__byte_perm(x, y, s): byte i of the result is byte (s >> 4i) & 7
    of the eight bytes x0..x3, y0..y3."""
    src = (x & M32) | ((y & M32) << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _funnelshift_r(lo, hi, sh):
    return ((((hi & M32) << 32) | (lo & M32)) >> (sh & 31)) & M32


def _layout(base, length, w):
    """cost_eye_layout: the gray origin (= base mod 4) and row pitch."""
    a = _clamp(base, w - 1) - 4
    gorg = a - ((a - base) & 3)
    gend = _clamp(base + length - 1, w - 1) + 4
    return gorg, (gend - gorg + 4) & ~3


def _gray(img, ylo, gorg, gwp, h, w):
    """cost_stage_gray: (GR, gwp) u8, each product and sum in float32."""
    g = np.zeros((GR, gwp), np.int64)
    for r in range(GR):
        y = _clamp(ylo - 3 + r, h - 1)
        for j in range(gwp):
            p = img[y, _clamp(gorg + j, w - 1)].astype(np.float32)
            acc = np.float32(p[0] * THIRD)
            acc = np.float32(acc + np.float32(p[1] * THIRD))
            acc = np.float32(acc + np.float32(p[2] * THIRD))
            g[r, j] = int(acc)
    return g


def _census1(gray, gorg, r, cc, w):
    col = [_clamp(cc + dx, w - 1) - gorg for dx in range(-4, 5)]
    ctr = gray[r + 3, col[4]]
    words = [0, 0]
    for dy in (-3, -2, -1, 1, 2, 3):
        for dx in (-4, -3, -2, -1, 1, 2, 3, 4):
            acc = words[dy > 0]
            words[dy > 0] = (acc << 1) | int(gray[r + 3 + dy, col[dx + 4]]
                                             < ctr)
    return words


def _census4(gray, r, wi):
    """cost_census4 on the gray rows as little-endian words."""
    def word(row, i):
        b = gray[row, 4 * i:4 * i + 4]
        return int(b[0]) | int(b[1]) << 8 | int(b[2]) << 16 | int(b[3]) << 24
    ctr = word(r + 3, wi)
    ce, co = _byte_perm(ctr, 0, 0x4240), _byte_perm(ctr, 0, 0x4341)
    rows = {}
    for dy in (-3, -2, -1, 1, 2, 3):
        wm, w0, wp = (word(r + 3 + dy, wi + i) for i in (-1, 0, 1))
        ge_e = ge_o = 0
        for dx in (-4, -3, -2, -1, 1, 2, 3, 4):
            if dx == -4:
                nb = wm
            elif dx < 0:
                nb = _funnelshift_r(wm, w0, 8 * (dx + 4))
            elif dx < 4:
                nb = _funnelshift_r(w0, wp, 8 * dx)
            else:
                nb = wp
            te = (_byte_perm(nb, 0, 0x4240) + 0x01000100 - ce) & M32
            to = (_byte_perm(nb, 0, 0x4341) + 0x01000100 - co) & M32
            ge_e = ((ge_e << 1) | (te & 0x01000100)) & M32
            ge_o = ((ge_o << 1) | (to & 0x01000100)) & M32
        rows[dy] = ~_byte_perm(ge_e, ge_o, 0x7351) & M32
    out = []
    for p in range(4):
        s = p | (4 + p) << 4
        w0 = ((_byte_perm(rows[-1], rows[-2], s) & 0xFFFF)
              | (_byte_perm(rows[-3], 0, 0x4440 | p) << 16))
        w1 = ((_byte_perm(rows[3], rows[2], s) & 0xFFFF)
              | (_byte_perm(rows[1], 0, 0x4440 | p) << 16))
        out.append((w0, w1))
    return out


def _pack(p):
    return int(p[0]) | int(p[1]) << 8 | int(p[2]) << 16


def _stage_eye(img, base, length, skew, ylo, h, w):
    """cost_stage_census: {slot: (pixel, c0, c1)} per row of the block."""
    gorg, gwp = _layout(base, length, w)
    gray = _gray(img, ylo, gorg, gwp, h, w)
    staged = [dict() for _ in range(RB)]
    for r in range(RB):
        y = _clamp(ylo + r, h - 1)
        for k in range(0, length, 4):
            c = base + k
            if c >= 0 and c + 3 <= w - 1:
                assert (c - gorg) % 4 == 0
                cens = _census4(gray, r, (c - gorg) >> 2)
            else:
                cens = [_census1(gray, gorg, r, _clamp(c + p, w - 1), w)
                        for p in range(4)]
            for p in range(4):
                slot = k + p + ((k + p) >> 5 if skew else 0)
                staged[r][slot] = (_pack(img[y, _clamp(c + p, w - 1)]),
                                   *cens[p])
    return staged


def replay_cost_pair(own, oth, table, d, zd, m, sign, row0, nrows):
    """The kernel's blocks, staging and threads, one output at a time: the
    cost is the quantized table's entry AD * 49 + H (u8, int16), or the
    sum of the two terms, which is the float32 table's entry."""
    h, w = own.shape[:2]
    g_n = -(-d // DPT)
    wp = w + 2 * m
    out = np.full((nrows, wp, d), -1, np.float64)
    omin = 0 if sign > 0 else 1 - DPT
    for bx in range(-(-wp // XB)):
        for by in range(-(-nrows // RB)):
            xp0, ylo = bx * XB, row0 + by * RB
            s_own = _stage_eye(own, xp0 - m, XB, False, ylo, h, w)
            oth_base = (xp0 - m - zd if sign > 0
                        else xp0 - m + zd - (DPT * g_n - 1))
            s_oth = _stage_eye(oth, oth_base, XB + DPT * g_n, True, ylo, h,
                               w)
            rows = min(RB, row0 + nrows - ylo)
            for t in range(rows * (XB // XT) * g_n):
                g, rest = t % g_n, t // g_n
                qd, r = rest % (XB // XT), rest // (XB // XT)
                xl = qd * XT
                if xp0 + xl >= wp:
                    continue
                d0 = g * DPT
                kb = xl + (d0 if sign > 0 else DPT * (g_n - g) - 1) + omin
                tv = [s_oth[r][kb + i + ((kb + i) >> 5)]
                      for i in range(DPT + XT - 1)]
                for xi in range(XT):
                    if xp0 + xl + xi >= wp:
                        break
                    op, o0, o1 = s_own[r][xl + xi]
                    for j in range(DPT):
                        if d0 + j >= d:
                            break
                        tp, t0, t1 = tv[(xi + j if sign > 0 else xi - j)
                                        - omin]
                        ad = sum(abs((op >> s & 255) - (tp >> s & 255))
                                 for s in (0, 8, 16))
                        ham = bin(o0 ^ t0).count("1") + bin(o1 ^ t1).count(
                            "1")
                        out[ylo + r - row0, xp0 + xl + xi, d0 + j] = (
                            table[ad * 49 + ham])
    return out


def _frame(h, w, seed):
    """Two images of smooth texture (the census sees ties and order)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4, w + 4, 3)).astype(np.float32)
    sm = sum(base[i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9
    img = sm.astype(np.uint8)
    return img, np.roll(img, -3, axis=1) ^ (rng.random(img.shape) < 0.05)


@pytest.mark.parametrize("h, w, nd, zd, eye, rows, mode", [
    (20, 45, 12, 6, "pair", None, "u8"),
    (20, 45, 12, 6, "pair", (5, 11), "u8"),
    (20, 45, 12, 6, "r", (9, 11), "int16"),
    (20, 45, 12, 4, "l", None, "float32"),
    (9, 37, 126, 63, "pair", (2, 6), "u8"),
    (6, 37, 130, 65, "r", None, "u8"),
    (7, 3, 12, 6, "pair", (1, 6), "u8"),
    (5, 300, 32, 10, "pair", None, "int16"),
])
def test_cost_pair_replay_matches_plain(h, w, nd, zd, eye, rows, mode):
    """B2's replay equals `cost_pair_plain` in every element."""
    left, right = _frame(h, w, nd + w)
    q = 510.0 if mode == "int16" else 127.0
    quant = mode != "float32"
    table = tck.cost_table(10.0, 30.0, q, quant)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    want = tck.cost_pair_plain(tl, tr, table, nd, zd, eye, rows).numpy()
    margin, sign, swap = tck._pair_geometry(eye, nd, zd)
    start, count = tck._row_range(rows, h)
    own, oth = (right, left) if swap else (left, right)
    got = replay_cost_pair(own, oth, table.numpy().astype(np.float64), nd,
                           zd, margin, sign, start, count)
    np.testing.assert_array_equal(got, want.astype(np.float64))


def test_census4_matches_census1_everywhere():
    """The 16-bit-lane census of four columns equals the one-bit-at-a-time
    census on gray rows full of ties and of both orders."""
    rng = np.random.default_rng(5)
    w = 64
    gray = rng.integers(0, 4, (GR, w)) * 60 + rng.integers(0, 2, (GR, w))
    for r in range(RB):
        for wi in range(1, w // 4 - 1):
            got = _census4(gray, r, wi)
            for p in range(4):
                assert list(got[p]) == _census1(gray, 0, r, 4 * wi + p,
                                                10 ** 6)


ARMS_TW, ARMS_TH, ARMS_THREADS = 64, 32, 256   # csrc/arms.cu


def arms_test(c):
    """csrc/arms.cu `arms_test`: (lo, k, o, a) of the threshold c."""
    if 1 <= c <= 128:
        return M32, (128 - c) * 0x010101, M32, M32
    if 129 <= c <= 255:
        return 0x7F7F7F, (256 - c) * 0x010101, 0, 0
    if c == 0:
        return 0x7F7F7F, 0x808080, 0, M32
    return 0, 0, 0, 0


def arms_fail(d, t):
    """csrc/arms.cu `arms_fail` (its general form; the SMALL form is the
    same at lo = o = a = ~0): bit 7 of a byte set where it is >= c."""
    lo, k, o, a = t
    return ((((d & lo) + k) & M32) | (d & o)) & (d | a)


def vabsdiff(a, b):
    return sum(abs((a >> s & 255) - (b >> s & 255)) << s for s in (0, 8, 16))


def test_arms_step_test_is_exact():
    """The carry test equals "some byte >= c" for every c in 0..256 on
    every value of one byte beside bytes at the test's edges."""
    edge = np.array([0, 1, 127, 128, 129, 200, 254, 255], np.int64)
    b0 = np.arange(256, dtype=np.int64)
    d = (b0[:, None, None] | edge[None, :, None] << 8
         | edge[None, None, :] << 16).ravel()
    bytes_ = np.stack([d & 255, d >> 8 & 255, d >> 16 & 255])
    for c in range(257):
        lo, k, o, a = arms_test(c)
        got = ((((d & lo) + k) & M32) | (d & o)) & (d | a) & 0x808080
        np.testing.assert_array_equal(got != 0, (bytes_ >= c).any(axis=0))


CH, EDGE_NEXT, EDGE_PREV = 0x808080, 0x80000000, 0x40000000


def replay_cross_arms(img, ucd, lcd, usd, lsd, row0=0, gh=None):
    """B1's blocks: the cross-shaped staged tile whose words carry the
    edge bits of the steps to the next and previous pixel (`arms_stage`),
    8 pixels a thread, the four walks two steps at a time; with row0/gh
    the halo-shard mode's vertical bounds."""
    h, w = img.shape[:2]
    gh = h if gh is None else gh
    tl = arms_test(tcross.arm_threshold(lcd))
    tu = arms_test(tcross.arm_threshold(ucd))
    reach = max(h - 1 + row0, gh - 1 - row0)
    rv, rh = max(min(usd, reach), 0), min(usd, w - 1)
    hw = ARMS_TW + 2 * rh
    arms = np.full((4, h, w), -1, np.int64)

    def stage(y, x, dy, dx):
        """arms_stage: the pixel's word and the edge bits of its steps to
        the next and previous pixel along (dy, dx), each read clamped
        from its unclamped coordinates."""
        yc, xc = _clamp(y, h - 1), _clamp(x, w - 1)
        c = _pack(img[yc, xc])
        n = _pack(img[_clamp(y + dy, h - 1), _clamp(x + dx, w - 1)])
        p = _pack(img[_clamp(y - dy, h - 1), _clamp(x - dx, w - 1)])
        word = c
        if arms_fail(vabsdiff(c, n), tl) & CH:
            word |= EDGE_NEXT
        if arms_fail(vabsdiff(c, p), tl) & CH:
            word |= EDGE_PREV
        return word

    def fails(c, anc, t, edge):
        d = vabsdiff(c & 0xFFFFFF, anc) | (c & 0xFF000000)
        return ((arms_fail(d, t) & CH) | (d & edge)) != 0

    def walk(words, i0, stride, kmax, edge):
        anc = words[i0] & 0xFFFFFF
        k1 = min(lsd, kmax)
        k = 1
        while k < k1:
            if fails(words[i0 + k * stride], anc, tl, edge):
                return k
            if fails(words[i0 + (k + 1) * stride], anc, tl, edge):
                return k + 1
            k += 2
        if k == k1:
            if fails(words[i0 + k * stride], anc, tl, edge):
                return k
            k += 1
        while k < kmax:
            if fails(words[i0 + k * stride], anc, tu, 0):
                return k
            if fails(words[i0 + (k + 1) * stride], anc, tu, 0):
                return k + 1
            k += 2
        if k == kmax and fails(words[i0 + k * stride], anc, tu, 0):
            return k
        return kmax

    for by in range(-(-h // ARMS_TH)):
        for bx in range(-(-w // ARMS_TW)):
            x0, y0 = bx * ARMS_TW, by * ARMS_TH
            vs = [stage(y0 - rv + i // ARMS_TW, x0 + i % ARMS_TW, 1, 0)
                  for i in range((ARMS_TH + 2 * rv) * ARMS_TW)]
            hs = [stage(y0 + i // hw, x0 - rh + i % hw, 0, 1)
                  for i in range(ARMS_TH * hw)]
            for tid in range(ARMS_THREADS):
                tx = tid % ARMS_TW
                x = x0 + tx
                if x >= w:
                    continue
                for i in range(ARMS_TH * ARMS_TW // ARMS_THREADS):
                    ty = tid // ARMS_TW + i * (ARMS_THREADS // ARMS_TW)
                    y = y0 + ty
                    if y >= h:
                        break
                    v, hh = (rv + ty) * ARMS_TW + tx, ty * hw + rh + tx
                    g = y + row0
                    kmax = max(min(usd, g), 0)
                    arms[0, y, x] = max(walk(vs, v, -ARMS_TW, kmax,
                                             EDGE_NEXT)
                                        - max(1, g - gh + 1) + 1, 0)
                    kmax = max(min(usd, gh - 1 - g), 0)
                    arms[1, y, x] = max(walk(vs, v, ARMS_TW, kmax,
                                             EDGE_PREV)
                                        - max(1, -g) + 1, 0)
                    arms[2, y, x] = walk(hs, hh, -1, min(usd, x), EDGE_NEXT)
                    arms[3, y, x] = walk(hs, hh, 1, min(usd, w - 1 - x),
                                         EDGE_PREV)
    return arms


@pytest.mark.parametrize("h, w, ucd, lcd, usd, lsd", [
    (40, 70, 6.0, 20.0, 9, 4),
    (37, 70, 5.99, 19.97, 34, 17),
    (12, 30, 6.0, 20.0, 34, 34),
    (20, 20, 255.0, -0.5, 5, 2),
    (20, 20, -1.0, 300.0, 5, 5),
    (20, 20, 150.5, 130.0, 6, 3),
    (20, 20, 128.0, 127.0, 6, 3),
])
def test_cross_arms_replay_matches_plain(h, w, ucd, lcd, usd, lsd):
    """B1's replay equals `cross_arms_plain`: tiles that cross the frame's
    edges, usd above the height, usd = lsd, thresholds past 255 and below
    0, fractional ones and both forms of the carry test (c up to 128 and
    above)."""
    img, _ = _frame(h, w, h * w)
    want = tcross.cross_arms_plain(torch.from_numpy(img), ucd, lcd, usd,
                                   lsd).numpy()
    np.testing.assert_array_equal(replay_cross_arms(img, ucd, lcd, usd,
                                                    lsd), want)


@pytest.mark.parametrize("h, gh, row0, usd, lsd", [
    (40, 100, -21, 7, 3),      # the top shard: rows above the frame
    (40, 100, 30, 7, 3),       # a middle shard
    (40, 100, 81, 7, 3),       # the bottom shard: rows below the frame
    (12, 100, 40, 34, 17),     # usd above the shard's height
    (30, 20, -6, 34, 34),      # both frame borders inside the tensor
])
def test_cross_arms_replay_halo_shard(h, gh, row0, usd, lsd):
    """B1's replay in its halo-shard mode (row0, global_h) equals
    `cross_arms_plain(row_offset=row0, global_h=gh)` on every row: walks
    bounded by the frame's rows, reads past the tensor's rows clamped,
    and rows outside the frame, whose in-bounds steps start past 1."""
    img, _ = _frame(h, 70, h * 70 + row0)
    want = tcross.cross_arms_plain(torch.from_numpy(img), 6.0, 20.0, usd,
                                   lsd, row0, gh).numpy()
    np.testing.assert_array_equal(
        replay_cross_arms(img, 6.0, 20.0, usd, lsd, row0, gh), want)
