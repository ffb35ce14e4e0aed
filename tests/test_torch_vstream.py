"""Numpy emulations of the streaming schedules of kernels B5 (the fused
vertical passes, `csrc/vpass.cu`) and B9 (the IRV vote, `csrc/irv.cu`),
held exactly against their plain versions `vv_pass_plain` and
`irv_vote_plain`.

The CUDA kernels run only on the card; these emulations replay their
index logic step by step on the CPU: the ring slots, the lags of reach
and 2 * reach, the bottom flush, the batches of rows, the packed u16
prefixes of B9 with their word realignment, its row segments and the
restart of its rings at each run of live tiles under `need`.  Each
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

VP_STEP = 8                   # vpass.cu
IRV_TILE, IRV_SEG, IRV_STEP = 64, 256, 8     # irv.cu (B + 1 <= 257)


def _slot(w, back, n):
    s = w - back
    return np.where(s < 0, s + n, s)


# ---- B5 --------------------------------------------------------------

def _vp_window(up, down, y, h, reach):
    """Lane-held window of row y for every x, packed (hi << 16) | lo."""
    if y < 0 or y >= h:
        return np.zeros(up.shape[1], np.uint32)
    a = np.clip(up[y], 0, reach)
    b = np.clip(down[y], 0, reach)
    return ((np.minimum(y + b, h).astype(np.uint32) << 16)
            | np.maximum(y - a, 0).astype(np.uint32))


def emulate_vv_pass(vol, up, down, reach, s2, s3, step=VP_STEP):
    """vpass_kernel for every (x, d) at once: returns the output and the
    number of times each element was written."""
    h, w, nd = vol.shape
    n = 2 * reach + 2
    xs = np.arange(w)
    ring1 = np.zeros((n, w, nd), np.uint32)
    ring2 = np.zeros((n, w, nd), np.uint32)
    p1 = np.zeros((w, nd), np.uint32)
    p2 = np.zeros((w, nd), np.uint32)
    w1 = w2 = 0
    half2 = 1 << (s2 - 1) if s2 else 0
    half3 = 1 << (s3 - 1) if s3 else 0
    out = np.zeros(vol.shape, np.int32)
    writes = np.zeros(h, np.int64)
    steps = h + 2 * reach
    for i0 in range(0, steps, step):
        win2 = [_vp_window(up, down, i0 + k - reach, h, reach)
                for k in range(step)]
        win3 = [_vp_window(up, down, i0 + k - 2 * reach, h, reach)
                for k in range(step)]
        for k in range(step):
            i, y2, y3 = i0 + k, i0 + k - reach, i0 + k - 2 * reach
            if i < h:
                p1 = p1 + vol[i].astype(np.uint32)
                w1 = 0 if w1 + 1 == n else w1 + 1
                ring1[w1] = p1
            if 0 <= y2 < h:
                j1 = min(i + 1, h)
                hi = (win2[k] >> 16).astype(np.int64)
                lo = (win2[k] & 0xFFFF).astype(np.int64)
                s = (ring1[_slot(w1, j1 - hi, n), xs]
                     - ring1[_slot(w1, j1 - lo, n), xs])
                p2 = p2 + ((s.view(np.int32) + half2) >> s2).astype(
                    np.uint32)
                w2 = 0 if w2 + 1 == n else w2 + 1
                ring2[w2] = p2
            if 0 <= y3 < h:
                j2 = min(y2 + 1, h)
                hi = (win3[k] >> 16).astype(np.int64)
                lo = (win3[k] & 0xFFFF).astype(np.int64)
                s = (ring2[_slot(w2, j2 - hi, n), xs]
                     - ring2[_slot(w2, j2 - lo, n), xs])
                out[y3] = (s.view(np.int32) + half3) >> s3
                writes[y3] += 1
    return out, writes


VV_CASES = [      # (H, W, D, reach, shifts)
    (1, 5, 32, 34, (6, 6)),
    (37, 7, 64, 34, (6, 6)),         # H < 2 * reach + 2
    (23, 3, 32, 0, (0, 0)),          # reach 0: empty windows
    (40, 5, 96, 1, (3, 6)),
    (90, 3, 128, 34, (6, 6)),
    (33, 9, 40, 5, (2, 1)),          # odd W, D no multiple of 32
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
    got, writes = emulate_vv_pass(vol, up, down, reach, *shifts)
    assert (writes == 1).all()
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
    got, _ = emulate_vv_pass(vol, up, down, reach, s2, s3)
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
