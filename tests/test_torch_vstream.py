"""Numpy emulations of the streaming schedules of kernels B5 (the fused
vertical passes, `csrc/vpass.cu`) and B9 (the IRV vote, `csrc/irv.cu`),
held exactly against their plain versions `vv_pass_plain` and
`irv_vote_plain`.

The CUDA kernels run only on the card; these emulations replay their
index logic step by step on the CPU: the ring slots, the lags of reach
and 2 * reach, the bottom flush, the batches of rows (B5's staged path:
its ring of stages filled by bulk copies, and the choice of path), the
packed u16 prefixes of B9 with their word realignment, its row segments
and the restart of its rings at each run of live tiles under `need`.  Each
emulation follows its kernel line for line, vectorised over the threads
(B5) or the lanes (B9).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import band as tband
from stereo_to_multiview_tpu_torch.ops import irv as tirv

torch.set_num_threads(1)

IRV_TILE, IRV_SEG, IRV_STEP = 64, 256, 4     # irv.cu


def _slot(w, back, n):
    s = w - back
    return np.where(s < 0, s + n, s)


# ---- B5 --------------------------------------------------------------

def _vp_window(up, down, y, h, reach):
    """The window [lo, hi) of row y for every column of the arms."""
    lo = np.maximum(y - np.clip(up[y], 0, reach), 0)
    hi = np.minimum(y + np.clip(down[y], 0, reach), h)
    return lo, hi


def _slot1(j, n):
    """Ring1's slot of P1[j] (`vp_slot1`)."""
    return (j + n - 1) % n


def _slot2(j, reach, n):
    """Ring2's slot of P2[j] (`vp_slot2`)."""
    return (j + n - 1 + reach) % n


def _vp_slots(up, down, y, h, reach, n):
    """The slots of row y's window ends for every column of the arms:
    (ring1 hi, ring1 lo, ring2 hi, ring2 lo); zeros outside the frame."""
    if y < 0 or y >= h:
        z = np.zeros(up.shape[1], np.int64)
        return z, z, z, z
    lo, hi = _vp_window(up, down, y, h, reach)
    return (_slot1(hi, n), _slot1(lo, n), _slot2(hi, reach, n),
            _slot2(lo, reach, n))


def emulate_vv_pass(vol, up, down, reach, s2, s3, base_aligned=True):
    """vpass_kernel for every thread of every block at once, on the path
    the launch picks (`vv_plan`: K stages, or 0 for the register path)
    for a volume whose base is 16-byte aligned or, with `base_aligned`
    False, is not.

    P1[j] sits in ring1's slot (j - 1) % N, P2[j] in ring2's slot
    (j - 1 + reach) % N, N a multiple of the path's batch: step i writes
    both rings' slot i % N.  Each step i runs the kernel's D, C, A, B in
    order: P1[i + 1] into ring1 and the ring1 slots of pass 2's row
    i + 1 - reach; pass 3 of row i - 1 - 2 reach from the ring2 slots
    loaded a step ago; pass 2 of row i - reach from the ring1 slots loaded
    a step ago, into ring2; the ring2 slots of pass 3's row i - 2 reach.
    Batches whose steps all have their rows in the frame skip the tests.
    The register path streams batches of VV_STEP rows loaded by each
    thread (0 past H; threads of columns past W return); lane k of a batch
    computes the slots of its step's windows, the others take them by
    shuffle.  The staged path keeps every thread (no return before its
    barriers) and streams batches of VV_ROWS rows from a ring of K stages
    per block: the producer issues batches 0 .. K - 1, then after every
    stream warp has read batch b from stage b % K it refills that stage
    with batch b + K, and writes the slots of rows b VV_ROWS + 1 ..
    + VV_ROWS into each column's slot ring (row 0's first), which the
    stream threads read.  A stage is the box of min(D, TD) d x the block's
    columns x VV_ROWS rows of the volume; its elements out of the volume
    arrive as zeros.  Stages and slot rings start as garbage, so a wrong
    word or a stale row shows.  Returns the output, the number of times
    each element was written, and K."""
    h, w, nd = vol.shape
    k_st, n, td, threads = tband.vv_plan(nd, reach,
                                         base_aligned and nd % 4 == 0)
    step = tband.VV_ROWS if k_st else tband.VV_STEP
    assert n >= 2 * reach + 2 and n % step == 0
    cols = threads // td
    gx, gy = -(-w // cols), -(-nd // td)
    bx, by, t = (a.reshape(-1) for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(threads), indexing="ij"))
    x0, d0 = bx * cols, by * td
    x, d = x0 + t // td, d0 + t % td
    keep = slice(None) if k_st else x < w      # register path: return
    bx, by, t, x0, d0, x, d = (a[keep] for a in (bx, by, t, x0, d0, x, d))
    col = x < w
    live = col & (d < nd)
    xc = np.minimum(x, w - 1)
    # each thread's column of arms; 0 in a column past W (not loaded)
    up_t = np.where(col, up[:, xc], 0)
    down_t = np.where(col, down[:, xc], 0)

    m = len(t)
    lanes = np.arange(m)
    rng = np.random.default_rng(7)
    ring1 = rng.integers(0, 1 << 32, (n, m), dtype=np.uint32)
    ring2 = rng.integers(0, 1 << 32, (n, m), dtype=np.uint32)
    ring1[_slot1(0, n)] = 0                    # P1[0]
    ring2[_slot2(0, reach, n)] = 0             # P2[0]
    p1 = np.zeros(m, np.uint32)
    p2 = np.zeros(m, np.uint32)
    half2 = 1 << (s2 - 1) if s2 else 0
    half3 = 1 << (s3 - 1) if s3 else 0
    out = np.zeros(vol.shape, np.int32)
    writes = np.zeros(vol.shape, np.int64)
    out_row = 0                 # pass 3's next output row
    zero = np.zeros(m, np.uint32)
    r = q = (zero, zero)        # the slots loaded a step ago (A's, C's)
    steps = h + 2 * reach + 1   # the last step for C alone

    if k_st:
        blocks = gx * gy
        blk = bx * gy + by
        box_d = min(nd, td)
        sw = cols * box_d
        assert 4 * box_d % 16 == 0 and box_d <= 256    # a tensor map's box
        stages = rng.integers(0, 1 << 32, (blocks, k_st, step * threads),
                              dtype=np.uint32)
        held = [None] * k_st                   # the batch each stage holds
        word = (x - x0) * box_d + (d - d0)
        assert (word[live] < sw).all()
        nin = -(-h // step)

        def box(q, r0):
            """Block q's box at row r0: its in-frame elements' (row, x, d)
            in the volume and places in a stage."""
            rr, cc, dd = np.meshgrid(np.arange(step), np.arange(cols),
                                     np.arange(box_d), indexing="ij")
            yy, xx = r0 + rr, (q // gy) * cols + cc
            ds = (q % gy) * td + dd
            ok = (yy >= 0) & (yy < h) & (xx < w) & (ds < nd)
            return (yy[ok], xx[ok], ds[ok],
                    (rr * sw + cc * box_d + dd)[ok])
        # each block column's slot ring: VV_SLOTS rows of 4 slots and a
        # copy of the first VV_ROWS; the row whose slots an entry holds
        nr = tband.VV_SLOTS
        ring_v = rng.integers(0, n, (blocks, cols, nr + step, 4))
        ring_y = np.full((blocks, cols, nr + step), -1)
        cth = t // td                          # the thread's column
        c_up = np.zeros((h, blocks, cols), np.int64)
        c_down = np.zeros((h, blocks, cols), np.int64)
        for qb in range(blocks):
            for c in range(cols):
                xq = (qb // gy) * cols + c
                if xq < w:
                    c_up[:, qb, c], c_down[:, qb, c] = up[:, xq], down[:, xq]

        def put_slots(y):                      # the producer's lanes
            if y >= h:
                return
            e = y & (nr - 1)
            for qb in range(blocks):
                for c in range(cols):      # arms 0 past W
                    v_ = [a_[0] for a_ in _vp_slots(
                        c_up[:, qb, c][:, None], c_down[:, qb, c][:, None],
                        y, h, reach, n)]
                    for at in (e, e + nr) if e < step else (e,):
                        ring_v[qb, c, at], ring_y[qb, c, at] = v_, y

        def issue(stage, b):
            for y in range(b * step + 1, b * step + step + 1):
                put_slots(y)
            for qb in range(blocks):        # out of the frame: zeros
                yy, xx, ds, at = box(qb, b * step)
                stages[qb, stage, :step * sw] = 0
                stages[qb, stage, at] = vol[yy, xx, ds].view(np.uint32)
            held[stage] = b

        put_slots(0)
        for b in range(min(k_st, nin)):
            issue(b, b)

    wslot = 0                   # slot i0 % N
    for b, i0 in enumerate(range(0, steps, step)):
        # the slots of pass 2's row i0 + k + 1 - reach (ring1) and pass
        # 3's row i0 + k - 2 reach (ring2): register path, lane k computes
        # them; staged path, from the slot ring (and which row's they are)
        if not k_st:
            sl2 = [_vp_slots(up_t, down_t, i0 + k + 1 - reach, h, reach,
                             n)[:2] for k in range(step)]
            sl3 = [_vp_slots(up_t, down_t, i0 + k - 2 * reach, h, reach,
                             n)[2:] for k in range(step)]
        else:
            e2 = (i0 + 1 - reach) & (nr - 1)
            e3 = (i0 - 2 * reach) & (nr - 1)
            sl2 = [(ring_v[blk, cth, e2 + k, 0], ring_v[blk, cth, e2 + k, 1])
                   for k in range(step)]
            sl3 = [(ring_v[blk, cth, e3 + k, 2], ring_v[blk, cth, e3 + k, 3])
                   for k in range(step)]
            row2 = [ring_y[blk, cth, e2 + k][col] for k in range(step)]
            row3 = [ring_y[blk, cth, e3 + k][col] for k in range(step)]
        if not k_st:
            v = [vol[i0 + k, xc, np.minimum(d, nd - 1)].astype(np.uint32)
                 * live if i0 + k < h else zero for k in range(step)]
        elif b < nin:
            s = b % k_st
            assert held[s] == b                # the stage's barrier phase
            v = [stages[blk, s, k * sw + word] for k in range(step)]
            if b + k_st < nin:                 # after the stream warps
                issue(s, b + k_st)
        else:
            v = [zero] * step
        edge = not (i0 > 2 * reach and i0 + step < h + (reach > 0))
        for k in range(step):
            i, y2, y3 = i0 + k, i0 + k - reach, i0 + k - 2 * reach
            assert wslot + k == i % n          # the batch's slots
            if not edge:    # a batch without tests: every row in the frame
                assert i < h and 0 <= y2 + 1 < h and 0 <= y3 - 1
            r_new = (zero, zero)
            if not edge or i < h:                           # D
                p1 = p1 + v[k]
                ring1[wslot + k] = p1
            if not edge or 0 <= y2 + 1 < h:
                assert not k_st or (row2[k] == y2 + 1).all()
                r_new = (ring1[sl2[k][0], lanes], ring1[sl2[k][1], lanes])
            if not edge or 0 <= y3 - 1 < h:                 # C
                res = ((q[0] - q[1]).view(np.int32) + half3) >> s3
                out[out_row, x[live], d[live]] = res[live]
                writes[out_row, x[live], d[live]] += 1
                out_row += 1
            if not edge or 0 <= y2 < h:                     # A
                sm = r[0] - r[1]
                p2 = p2 + ((sm.view(np.int32) + half2) >> s2).astype(
                    np.uint32)
                ring2[wslot + k] = p2                       # P2[y2 + 1]
            if not edge or 0 <= y3 < h:                     # B
                assert not k_st or (row3[k] == y3).all()
                q = (ring2[sl3[k][0], lanes], ring2[sl3[k][1], lanes])
            r = r_new
        wslot = (wslot + step) % n
    assert out_row == h
    return out, writes, k_st


VV_CASES = [      # (H, W, D, reach, shifts)
    (1, 5, 32, 34, (6, 6)),
    (37, 7, 64, 34, (6, 6)),         # H < 2 * reach + 2
    (23, 3, 32, 0, (0, 0)),          # reach 0: empty windows
    (40, 5, 96, 1, (3, 6)),
    (90, 3, 128, 34, (6, 6)),
    (33, 9, 40, 5, (2, 1)),          # odd W, D no multiple of 32
    # the staged path's edges, and where the register path runs instead
    (45, 3, 128, 34, (6, 6)),        # H no multiple of a stage's rows
    (9, 5, 128, 34, (6, 6)),         # H < a stage's rows
    (150, 2, 32, 0, (0, 0)),         # reach 0: 8 stages, each refilled
    (40, 2, 32, 108, (6, 6)),        # < 2 stages fit: register path
    (30, 5, 130, 3, (6, 6)),         # D % 4 != 0: register path
    (60, 5, 64, 34, (6, 6)),         # D = 64: two columns a block
]


def _vv_inputs(h, w, nd, reach, seed, vmax=17_600):
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, vmax, (h, w, nd)).astype(np.int32)
    up = rng.integers(-2, reach + 3, (h, w)).astype(np.int32)
    down = rng.integers(-2, reach + 3, (h, w)).astype(np.int32)
    return vol, up, down


@pytest.mark.parametrize("h,w,nd,reach,shifts", VV_CASES)
def test_vv_stream_matches_plain(h, w, nd, reach, shifts):
    """The streamed schedule writes every element once and equals
    `vv_pass_plain`, arms beyond [0, reach] and windows clipped by the
    frame included."""
    vol, up, down = _vv_inputs(h, w, nd, reach, seed=h * 131 + w)
    got, writes, k = emulate_vv_pass(vol, up, down, reach, *shifts)
    assert (writes == 1).all()
    # a slot ring holds the rows of 5 batches and both lags to reach 88
    assert (k == 0) == (nd % 4 != 0 or reach > 88)
    ref = tband.vv_pass_plain(torch.from_numpy(vol), torch.from_numpy(up),
                              torch.from_numpy(down), *shifts, reach)
    np.testing.assert_array_equal(got, ref.numpy())
    # the wrapper takes the plain version on the CPU
    cpu = tband.vv_pass(torch.from_numpy(vol), torch.from_numpy(up),
                        torch.from_numpy(down), *shifts, reach)
    np.testing.assert_array_equal(cpu.numpy(), got)


def test_vv_stream_prefix_wraps_exactly():
    """uint32 prefixes of a long column wrap (here past 2^32); the window
    differences stay exact while every window sum is below 2^31.  Held
    against int64 window sums."""
    h, w, nd, reach, s2, s3 = 400, 2, 32, 34, 7, 6
    vol, up, down = _vv_inputs(h, w, nd, reach, seed=5, vmax=30_000_000)
    got = emulate_vv_pass(vol, up, down, reach, s2, s3)[0]
    assert int(vol[:, 0, 0].astype(np.int64).sum()) > 1 << 32

    def window(v, shift):
        cs = np.concatenate([np.zeros((1, w, nd), np.int64),
                             np.cumsum(v.astype(np.int64), axis=0)])
        y = np.arange(h)[:, None]
        lo = np.maximum(y - np.clip(up, 0, reach), 0)
        hi = np.minimum(y + np.clip(down, 0, reach), h)
        xs = np.arange(w)[None, :]
        s = cs[hi, xs] - cs[lo, xs]
        return (s + (1 << (shift - 1))) >> shift

    np.testing.assert_array_equal(got, window(window(vol, s2), s3))


@pytest.mark.parametrize("h,w,nd,reach", [(37, 3, 128, 34), (9, 4, 64, 5),
                                          (70, 3, 32, 0)])
def test_vv_stream_paths_agree(h, w, nd, reach):
    """A volume whose base is not 16-byte aligned takes the register path
    at shapes whose aligned volume takes the staged one; both write each
    element once and give the same output."""
    vol, up, down = _vv_inputs(h, w, nd, reach, seed=h + 17 * w)
    staged, w_s, k_s = emulate_vv_pass(vol, up, down, reach, 6, 6)
    plain, w_r, k_r = emulate_vv_pass(vol, up, down, reach, 6, 6,
                                      base_aligned=False)
    assert k_s >= 2 and k_r == 0
    assert (w_s == 1).all() and (w_r == 1).all()
    np.testing.assert_array_equal(staged, plain)


def test_vv_path_choice():
    """`vv_stages`, the launch's path as the wrapper counts it
    (`vv_pass.staged`): every preset's B5 launches take the staged path
    with two blocks an SM; a D that is no multiple of 4, a misaligned
    base and a reach whose rings leave no two stages take the register
    path.  `reset_launch_counts` zeroes the counter."""
    from stereo_to_multiview_tpu_torch import config, kernels
    for cfg in (config.HD1080_D128, config.HD1080_D128_HSLO_4K,
                config.UHD4K_16V, config.HD1080_LOWRES):
        k, n, td, threads = tband.vv_plan(cfg.num_disp, cfg.usd, True)
        cols = threads // td
        assert k >= 3 and threads == 128 and cols in (1, 2)
        smem = (k * tband.VV_ROWS * threads * 4 + threads * 8 * n
                + tband.VV_BARS
                + cols * (tband.VV_SLOTS + tband.VV_ROWS) * 16)
        assert 2 * (smem + tband.VV_BLOCK_RESERVED) <= tband.VV_SMEM_SM
    for nd in (126, 130):
        assert tband.vv_stages(nd, 34, nd % 4 == 0) == 0
    assert tband.vv_stages(128, 34, False) == 0     # base off 16 bytes
    assert tband.vv_stages(128, 64, True) == 5     # one block an SM
    assert tband.vv_stages(128, 88, True) == 2
    for reach in (89, 104, 108, 112):
        assert tband.vv_stages(128, reach, True) == 0
    assert tband.vv_plan(128, 113, True)[2:] == (64, 64)    # fewer threads
    assert tband.vv_stages(128, 1000, True) == -1           # no launch
    tband.vv_pass.staged = 3
    kernels.reset_launch_counts()
    assert tband.vv_pass.staged == 0 and tband.vv_pass.launches == 0


# ---- B9 --------------------------------------------------------------

def _word(buf, wi):
    """irv_word: little-endian u32 word wi of the byte buffer, the bytes
    past its end read as 0."""
    b = [int(buf[4 * wi + k]) if 4 * wi + k < buf.size else 0
         for k in range(4)]
    return b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24


def _funnel_r(lo, hi, sh):
    return ((hi << 32 | lo) >> sh) & 0xFFFFFFFF


def _perm_pairs(v):
    """__byte_perm(v, 0, 0x4140) and (v, 0, 0x4342)."""
    return (v & 0xFF) | ((v >> 8) & 0xFF) << 16, \
        ((v >> 16) & 0xFF) | ((v >> 24) & 0xFF) << 16


def emulate_irv_vote(cnt, disp, outl, up, down, thresh_s, thresh_h, zd,
                     reach, need=None, tile=IRV_TILE, seg=IRV_SEG,
                     step=IRV_STEP):
    """irv_vote_kernel, one warp (column) at a time, lanes as lists: runs
    from the first to the last voting row of consecutive tiles (restarted
    where two tiles' voters lie more than 2 * reach rows apart), each
    streamed in batches that push `step` rows and then
    vote.  Returns (disp, outl) after the vote and the (H, W) mask of the
    span rows it read."""
    h, w, c = cnt.shape
    nb = c - 1
    ng = (nb + 3) // 4                   # bin groups
    nj = (ng + 31) // 32
    buf = cnt.reshape(-1)
    f32 = np.float32
    disp_out, outl_out = disp.copy(), outl.copy()
    read = np.zeros((h, w), bool)
    voter = outl != 0
    if need is not None:
        voter = voter & (need != 0)
    # irv_vote_rows_kernel: (last + 1) << 8 | (first + 1) of each tile's
    # voting rows, 0 without one
    nt = -(-h // tile)
    rows = np.zeros((nt, w), np.int64)
    for t in range(nt):
        for x in range(w):
            ys = np.nonzero(voter[t * tile:(t + 1) * tile, x])[0]
            if len(ys):
                rows[t, x] = (ys[-1] + 1) << 8 | (ys[0] + 1)
    groups = [[lane + 32 * j for j in range(nj)] for lane in range(32)]
    mask = {g: (0 if g >= ng else 0xFFFFFFFF if nb - 4 * g >= 4
                else (1 << (8 * (nb - 4 * g))) - 1)
            for lane in range(32) for g in groups[lane]}

    def run(x, a, b):
        r0, r1, i_end = max(a - reach, 0), min(b + reach, h), b + reach
        n = 2 * reach + 2 + step
        ring = np.zeros((n, ng, 2), np.uint64)
        ringt = np.zeros(n, np.uint64)
        acc = {g: [0, 0] for g in range(ng)}
        acct = 0
        wslot = 0
        for i0 in range(r0, i_end, step):
            lane_rows = [i0 + k - reach for k in range(step)]
            votes = [a <= y < b and bool(voter[y, x]) for y in lane_rows]
            # the batch's rows into the rings, rows past r1 as zero rows
            for k in range(step):
                i = i0 + k
                wslot = 0 if wslot + 1 == n else wslot + 1
                if i >= r1:
                    ring[wslot] = [[acc[g][0], acc[g][1]]
                                   for g in range(ng)]
                    ringt[wslot] = acct
                    continue
                read[i, x] = True
                o = (i * w + x) * c
                nw = (((o & 3) + nb - 1) >> 2) + 1   # words of bins
                # lanes' words, and lane 0's word after the last group
                wd = [_word(buf, (o >> 2) + idx) if idx < nw else 0
                      for idx in range(32 * nj + 1)]
                for g in range(ng):
                    # the next word, by shuffle from the next lane
                    v = _funnel_r(wd[g], wd[g + 1], 8 * (o & 3)) & mask[g]
                    lo, hi = _perm_pairs(v)
                    acc[g][0] = (acc[g][0] + lo) & 0xFFFFFFFF
                    acc[g][1] = (acc[g][1] + hi) & 0xFFFFFFFF
                    ring[wslot, g] = acc[g]
                acct = (acct + int(buf[o + nb])) & 0xFFFFFFFF
                ringt[wslot] = acct
            # then its votes: prefix i0 + step sits in slot wslot
            for k in range(step):
                if not votes[k]:
                    continue
                y = i0 + k - reach
                au = min(max(int(up[y, x]), 0), reach)
                ad = min(max(int(down[y, x]), 0), reach)
                hi_r, lo_r = min(y + ad + 1, h), max(y - au, 0)
                assert hi_r < 1 << 16
                assert i0 + step - lo_r < n
                s_hi = int(_slot(wslot, i0 + step - hi_r, n))
                s_lo = int(_slot(wslot, i0 + step - lo_r, n))
                keys = []
                for lane in range(32):
                    key = 0          # count << 16 | (0xFFFF - bin)
                    for g in groups[lane]:
                        if mask.get(g, 0) == 0:
                            continue
                        d01 = int(ring[s_hi, g, 0] - ring[s_lo, g, 0]) \
                            & 0xFFFFFFFF
                        d23 = int(ring[s_hi, g, 1] - ring[s_lo, g, 1]) \
                            & 0xFFFFFFFF
                        hq = [d01 & 0xFFFF, d01 >> 16, d23 & 0xFFFF,
                              d23 >> 16]
                        for q in range(4):
                            key = max(key, hq[q] << 16 | (0xFFFF - 4 * g - q))
                    keys.append(key)
                kmax = max(keys)                     # __reduce_max_sync
                tot = int(ringt[s_hi] - ringt[s_lo]) & 0xFFFFFFFF
                m = kmax >> 16
                max_d = (0xFFFF - (kmax & 0xFFFF) - zd if m > 0
                         else int(disp[y, x]))
                ratio = f32(max_d + zd) / f32(max(tot, 1))
                if tot > thresh_s and ratio > f32(thresh_h):
                    disp_out[y, x] = f32(max_d)
                    outl_out[y, x] = 0

    for x in range(w):
        for y0 in range(0, h, seg):
            t1 = -(-min(y0 + seg, h) // tile)
            a = b = -1
            for t in range(y0 // tile, t1):
                v = int(rows[t, x])
                if v == 0:
                    continue
                f, l = t * tile + (v & 0xFF) - 1, t * tile + (v >> 8)
                if a >= 0 and f - b > 2 * reach:
                    run(x, a, b)
                    a = -1
                if a < 0:
                    a = f
                b = l
            if a >= 0:
                run(x, a, b)
    return disp_out, outl_out, read


def _irvstream():
    """tests/test_torch_irvstream.py as a module: its `rowspan_mirror` is
    the set of span rows the gated B8 writes."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_irvstream.py")
    spec = importlib.util.spec_from_file_location("irvstream", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _irv_inputs(h, w, nd, zd, reach, seed):
    rng = np.random.default_rng(seed)
    disp = rng.integers(-zd - 3, nd - zd + 3, (h, w)).astype(np.float32)
    disp += rng.choice(np.array([0, 0.25, -0.75], np.float32), (h, w))
    outl = (rng.random((h, w)) < 0.4).astype(np.uint8)
    # a band of one disparity so that votes accept
    disp[:, : max(1, w // 2)] = np.float32(rng.integers(1, nd - zd))
    arms = rng.integers(-1, reach + 2, (4, h, w)).astype(np.int32)
    # a frontier: dead columns (x % 3 == 1) and dead 16-row bands
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    need = ((rng.random((h, w)) < 0.3) & (xs % 3 != 1)
            & ((ys // 16) % 2 == 0))
    return disp, outl, arms, need


IRV_CASES = [     # (H, W, num_disp, zero_disp, reach, tile, seg)
    (1, 7, 128, 64, 34, IRV_TILE, IRV_SEG),     # B + 1 = 129, H = 1
    (37, 5, 128, 64, 34, IRV_TILE, IRV_SEG),    # H < 2 * reach + 2
    (30, 9, 64, 32, 0, IRV_TILE, IRV_SEG),      # B + 1 = 65, reach 0
    (41, 3, 64, 32, 1, 4, 8),                   # small tiles: segments,
    (75, 5, 128, 64, 34, 8, 16),                # runs and restarts
    (50, 11, 22, 8, 6, 8, 24),                  # odd W, B + 1 = 23
    (20, 3, 130, 64, 5, 8, 16),                 # B + 1 = 131: two groups
]


@pytest.mark.parametrize("gated", [False, True], ids=["full", "need"])
@pytest.mark.parametrize("h,w,nd,zd,reach,tile,seg", IRV_CASES)
def test_irv_vote_stream_matches_plain(h, w, nd, zd, reach, tile, seg,
                                       gated):
    """The streamed vote equals `irv_vote_plain`.  Under `need` it reads
    only spans that the gated B8 writes: every other span holds 255 (a
    count no span reaches), and the read rows are checked too."""
    disp, outl, arms, need = _irv_inputs(h, w, nd, zd, reach,
                                         seed=h * 7 + w + 1000 * gated)
    ta = torch.from_numpy(arms)
    t_d, t_o = torch.from_numpy(disp), torch.from_numpy(outl)
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT
    cnt = tirv.irv_rowspan_plain(t_d, t_o, ta[LEFT], ta[RIGHT], nd, zd,
                                 reach).numpy()
    thresh_s, thresh_h = 1, 0.05
    need_t = torch.from_numpy(need) if gated else None
    ref = tirv.irv_vote_plain(torch.from_numpy(cnt), t_d, t_o, ta[UP],
                              ta[DOWN], thresh_s, thresh_h, zd, reach,
                              need_t)
    fed = cnt
    allowed = np.ones((h, w), bool)
    if gated:
        allowed = _irvstream().rowspan_mirror((outl != 0) & need, reach,
                                                tile)
        fed = np.where(allowed[:, :, None], cnt, np.uint8(255))
    got_d, got_o, read = emulate_irv_vote(
        fed, disp, outl, arms[UP], arms[DOWN], thresh_s, thresh_h, zd,
        reach, need if gated else None, tile, seg)
    assert not (read & ~allowed).any()
    np.testing.assert_array_equal(got_d, ref[0].numpy())
    np.testing.assert_array_equal(got_o, ref[1].numpy())
    if h > 1 and reach > 0:               # (reach 0: a pixel's region
        assert (got_o != outl).any()      # is itself) some votes accept
    if gated and h > 1:
        assert not read.all()             # and some rows are skipped
