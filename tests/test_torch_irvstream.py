"""A numpy emulation of the streaming schedule of kernel B8 (the IRV row
spans, `csrc/irv.cu` `irv_rowspan_kernel`), held exactly against its
plain version `irv_rowspan_plain`.

The CUDA kernel runs only on the card; the emulation replays its index
logic on the CPU, vectorised over a warp's lanes and channel groups: the
row segments and their 32-column output chunks, the priming batches, the
byte-packed u32 prefixes of the bins in a ring of 2 * reach + 33 slots
(their wrapped differences), the total's prefix a slot taken from the
batch's reliable positions (a ballot and a count in the kernel), the gating of chunks and batches under `need` with the
prefixes restarting after a skipped batch, and the staging of a chunk's
outputs at their alignment in the volume, stored as a byte head, 16-byte
pieces and a byte tail.  The same for B9's staged vote and for G3, the
frontier between rounds (`irv_frontier_kernel`: tiles of 16 x 16 blocks
with their halo, a 64-bit mask a halo block row, the separable OR).
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import irv as tirv
from stereo_to_multiview_tpu_torch.ops.cross import LEFT, RIGHT

torch.set_num_threads(1)

RS_STEP, RS_SEG, TILE, IRV_SEG = 32, 256, 64, 256      # irv.cu
U32 = np.uint64(0xFFFFFFFF)


def rs_segments(w, seg=RS_SEG):
    """(S, nseg) of stm_irv_rowspan: segments of at most `seg` columns,
    rounded up to whole 32-column chunks."""
    nseg = -(-w // seg)
    s = -(-(-(-w // nseg)) // RS_STEP) * RS_STEP
    return s, -(-w // s)


def live_map(voter, tile=TILE):
    """irv_live_kernel: (last + 1) << 8 | (first + 1) of each tile's voting
    rows in each column, 0 without one."""
    h, w = voter.shape
    nt = -(-h // tile)
    live = np.zeros((nt, w), np.int64)
    for t in range(nt):
        for x in range(w):
            ys = np.nonzero(voter[t * tile:(t + 1) * tile, x])[0]
            if len(ys):
                live[t, x] = (ys[-1] + 1) << 8 | (ys[0] + 1)
    return live


def irv_keys(disp, outl, nb, zd):
    """irv_key: the bin, nb for a reliable pixel outside the bins, -1 for
    an outlier."""
    b = disp.astype(np.int64) + zd          # trunc toward zero
    k = np.where((b >= 0) & (b < nb), b, nb)
    return np.where(outl != 0, -1, k)


def emulate_irv_rowspan(disp, outl, left, right, nb, zd, reach, need=None,
                        seg=RS_SEG, tile=TILE):
    """irv_rowspan_kernel, one warp (row, segment) at a time.  Returns the
    (H, W, nb + 1) volume (0 where nothing was written) and the number of
    times each byte was written."""
    h, w = disp.shape
    c = nb + 1
    gb = (nb + 3) // 4                  # bin groups
    n_slots = 2 * reach + RS_STEP + 1
    s_cols, nseg = rs_segments(w, seg)
    out = np.zeros(h * w * c, np.uint8)
    writes = np.zeros(h * w * c, np.int64)
    keys = irv_keys(disp, outl, nb, zd)
    live = None
    if need is not None:
        live = live_map((outl != 0) & (need != 0), tile)
    g4 = 4 * np.arange(gb)
    nbin = np.clip(nb - g4, 0, 4)
    magic = (2 ** 32 + c - 1) // c
    for y in range(h):
        for sg in range(nseg):
            x0 = sg * s_cols
            x1 = min(x0 + s_cols, w)
            m_chunks = -(-(x1 - x0) // RS_STEP)
            k_prime = -(-2 * reach // RS_STEP)
            # liveness of each pixel of the segment
            mine = np.zeros((m_chunks, RS_STEP), bool)
            for m in range(m_chunks):
                for lane in range(RS_STEP):
                    p = x0 + RS_STEP * m + lane
                    v = p < x1
                    if v and live is not None:
                        v = False
                        t0 = max(y - reach, 0) // tile
                        t1 = min(y + reach, h - 1) // tile
                        for t in range(t0, t1 + 1):
                            code = int(live[t, p])
                            base = t * tile - 1
                            v |= (code != 0
                                  and base + (code & 0xFF) - reach <= y
                                  <= base + (code >> 8) + reach)
                    mine[m, lane] = v
            chunks = mine.any(axis=1)
            if not chunks.any():
                continue
            n_b = k_prime + m_chunks

            def runs(b):
                return chunks[max(b - k_prime, 0):b + 1].any()

            q0, q1 = max(x0 - reach, 0), min(x1 + reach, w)
            ring = np.zeros((n_slots, gb), np.uint64)
            ringt = np.zeros(n_slots, np.uint64)
            acc = np.zeros(gb, np.uint64)
            acct = 0
            wslot, prev, oldest = 0, -2, 0
            for b in range(n_b):
                if not runs(b):
                    continue
                m = b - k_prime
                if b != prev + 1:               # (re)start the prefixes
                    acc[:] = 0
                    ring[wslot] = 0
                    acct = 0
                    ringt[wslot] = 0
                    oldest = x0 + reach + RS_STEP * m   # boundary in wslot
                w0 = wslot
                qs = x0 + reach + RS_STEP * m + np.arange(RS_STEP)
                inside = (qs >= q0) & (qs < q1)
                bkeys = np.where(inside, keys[y, np.clip(qs, 0, w - 1)], -1)
                # the totals: lane k takes the prefix after position k
                rel = np.cumsum(bkeys >= 0)
                for k in range(RS_STEP):
                    ringt[(w0 + k + 1) % n_slots] = (acct + rel[k]) & 0xFFFFFFFF
                acct += int(rel[-1])
                for k in range(RS_STEP):
                    kk = int(bkeys[k])
                    dk = kk - g4
                    inc = np.where((dk >= 0) & (dk < nbin),
                                   np.left_shift(1, 8 * np.clip(dk, 0, 3)),
                                   0)
                    acc = (acc + inc.astype(np.uint64)) & U32
                    slot = w0 + k + 1
                    ring[slot if slot < n_slots else slot - n_slots] = acc
                wslot = (w0 + RS_STEP) % n_slots
                prev = b
                if m < 0 or not chunks[m]:
                    continue
                xc = x0 + RS_STEP * m
                n = min(RS_STEP, x1 - xc)
                bnew = xc + reach + RS_STEP
                gbase = (y * w + xc) * c
                off = gbase & 15
                stage = np.zeros(RS_STEP * c + 16, np.uint8)
                for k in range(n):
                    p = xc + k
                    an = min(max(int(left[y, p]), 0), reach)
                    ap = min(max(int(right[y, p]), 0), reach)
                    hi, lo = min(p + ap + 1, w), max(p - an, 0)
                    assert 0 <= bnew - hi and bnew - lo < n_slots
                    assert lo >= oldest          # no slot from before it
                    s_hi = (wslot - (bnew - hi)) % n_slots
                    s_lo = (wslot - (bnew - lo)) % n_slots
                    v = (ring[s_hi] - ring[s_lo]) & U32
                    for q in range(4):
                        ok = q < nbin
                        stage[off + k * c + g4[ok] + q] = (
                            (v[ok] >> np.uint64(8 * q)) & np.uint64(0xFF))
                    stage[off + k * c + nb] = (ringt[s_hi] - ringt[s_lo]) \
                        & np.uint64(0xFF)
                reads = mine[m]

                def read(j0, j1):
                    k0, k1 = (j0 * magic) >> 32, (j1 * magic) >> 32
                    assert k0 == j0 // c and k1 == j1 // c
                    return live is None or reads[k0:k1 + 1].any()

                nbytes = n * c
                head = min((16 - off) & 15, nbytes)
                body = (nbytes - head) >> 4
                tail = nbytes - head - 16 * body
                pieces = [(j, j + 1) for j in range(head)]
                pieces += [(head + 16 * i, head + 16 * i + 16)
                           for i in range(body)]
                pieces += [(head + 16 * body + j, head + 16 * body + j + 1)
                           for j in range(tail)]
                for j0, j1 in pieces:
                    if j1 - j0 == 16:
                        assert (gbase + j0) % 16 == 0
                    if read(j0, j1 - 1):
                        out[gbase + j0:gbase + j1] = stage[off + j0:off + j1]
                        writes[gbase + j0:gbase + j1] += 1
    return out.reshape(h, w, c), writes.reshape(h, w, c)


def rowspan_mirror(voter, reach, tile=TILE):
    """(H, W) bool: the spans the gated B8 must write, B9's runs: rows
    [first - reach, last + reach] of each live vote tile's column."""
    h, w = voter.shape
    rows = np.zeros((h, w), bool)
    for t in range(-(-h // tile)):
        blk = voter[t * tile:(t + 1) * tile]
        for x in np.nonzero(blk.any(axis=0))[0]:
            ys = np.nonzero(blk[:, x])[0] + t * tile
            rows[max(ys[0] - reach, 0):ys[-1] + reach + 1, x] = True
    return rows


def b9_streamed_rows(voter, reach, tile=TILE, seg=IRV_SEG):
    """(H, W) bool: the span rows irv_vote_kernel streams: its runs from a
    tile's first to a later tile's last voting row within a segment of
    `seg` rows, joined while the voters lie at most 2 * reach rows apart,
    each with reach rows either side."""
    h, w = voter.shape
    live = live_map(voter, tile)
    rows = np.zeros((h, w), bool)
    for x in range(w):
        for y0 in range(0, h, seg):
            t1 = -(-min(y0 + seg, h) // tile)
            a = b = -1
            found = []
            for t in range(y0 // tile, t1):
                v = int(live[t, x])
                if v == 0:
                    continue
                f, l = t * tile + (v & 0xFF) - 1, t * tile + (v >> 8)
                if a >= 0 and f - b > 2 * reach:
                    found.append((a, b))
                    a = -1
                if a < 0:
                    a = f
                b = l
            if a >= 0:
                found.append((a, b))
            for a, b in found:
                rows[max(a - reach, 0):min(b + reach, h), x] = True
    return rows


def _inputs(h, w, nd, zd, reach, seed, need_share=0.3):
    rng = np.random.default_rng(seed)
    disp = rng.integers(-zd - 3, nd - zd + 3, (h, w)).astype(np.float32)
    disp += rng.choice(np.array([0, 0.25, -0.75], np.float32), (h, w))
    outl = (rng.random((h, w)) < 0.3).astype(np.uint8)
    arms = rng.integers(-1, reach + 2, (4, h, w)).astype(np.int32)
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    need = ((rng.random((h, w)) < need_share) & (xs % 70 < 40)
            & ((ys // 16) % 3 == 0))
    return disp, outl, arms, need


def _plain(disp, outl, arms, nd, zd, reach):
    return tirv.irv_rowspan_plain(
        torch.from_numpy(disp), torch.from_numpy(outl),
        torch.from_numpy(arms[LEFT]), torch.from_numpy(arms[RIGHT]), nd, zd,
        reach).numpy()


RS_CASES = [      # (H, W, num_disp, zero_disp, reach, seg)
    (3, 300, 128, 64, 34, RS_SEG),     # B + 1 = 129: 32 full groups
    (2, 301, 126, 63, 34, RS_SEG),     # B + 1 = 127, odd W
    (4, 77, 64, 32, 0, 64),            # B + 1 = 65, reach 0
    (3, 190, 64, 32, 5, 64),           # several segments, B + 1 = 65
    (37, 33, 12, 6, 9, 32),            # B + 1 = 13: a piece spans pixels
    (2, 150, 130, 64, 40, 96),         # B + 1 = 131: two groups a lane
    (2, 40, 8, 4, 127, RS_SEG),        # reach 127: 8 priming batches
]


@pytest.mark.parametrize("h,w,nd,zd,reach,seg", RS_CASES)
def test_irv_rowspan_stream_matches_plain(h, w, nd, zd, reach, seg):
    """Without `need` the streamed schedule writes every byte once and
    equals `irv_rowspan_plain`; the wrapper takes the plain version on the
    CPU."""
    disp, outl, arms, _ = _inputs(h, w, nd, zd, reach, seed=h * 31 + w)
    got, writes = emulate_irv_rowspan(disp, outl, arms[LEFT], arms[RIGHT],
                                      nd, zd, reach, seg=seg)
    assert (writes == 1).all()
    ref = _plain(disp, outl, arms, nd, zd, reach)
    np.testing.assert_array_equal(got, ref)
    cpu = tirv.irv_rowspan(*(torch.from_numpy(a) for a in (
        disp, outl, arms[LEFT], arms[RIGHT])), nd, zd, reach)
    np.testing.assert_array_equal(cpu.numpy(), ref)


GATED_CASES = [   # (H, W, num_disp, zero_disp, reach, seg)
    (150, 70, 128, 64, 34, RS_SEG),
    (90, 101, 126, 63, 9, 64),
    (70, 65, 64, 32, 0, 32),
    (130, 100, 12, 6, 70, 32),         # reach > 64: three tiles a pixel
]


@pytest.mark.parametrize("h,w,nd,zd,reach,seg", GATED_CASES)
def test_irv_rowspan_stream_gated_covers_b9_runs(h, w, nd, zd, reach, seg):
    """Under `need` the schedule writes each byte at most once, every byte
    it writes equals the plain version, and it writes every span of the
    mirror, which is exactly the set of rows B9 streams; some spans are
    skipped."""
    disp, outl, arms, need = _inputs(h, w, nd, zd, reach, seed=h + 7 * w)
    got, writes = emulate_irv_rowspan(disp, outl, arms[LEFT], arms[RIGHT],
                                      nd, zd, reach, need=need, seg=seg)
    ref = _plain(disp, outl, arms, nd, zd, reach)
    assert writes.max() == 1
    np.testing.assert_array_equal(got[writes == 1], ref[writes == 1])
    voter = (outl != 0) & need
    mirror = rowspan_mirror(voter, reach)
    np.testing.assert_array_equal(mirror, b9_streamed_rows(voter, reach))
    assert writes[mirror].all()
    assert mirror.any() and not mirror.all()
    assert not (writes == 1).all()


def test_irv_rowspan_stream_byte_prefixes_wrap():
    """Windows of 255 reliable pixels of one bin at reach 127: each byte of
    the packed prefixes wraps past 255 many times in a row of 600
    positions, and every window is still exact."""
    h, w, nd, zd, reach = 2, 600, 16, 8, 127
    disp = np.full((h, w), 3.0, np.float32)
    outl = np.zeros((h, w), np.uint8)
    outl[1, ::97] = 1
    arms = np.full((4, h, w), 127, np.int32)
    arms[:, 1, ::5] = 300                 # clamped to the reach
    got, writes = emulate_irv_rowspan(disp, outl, arms[LEFT], arms[RIGHT],
                                      nd, zd, reach)
    ref = _plain(disp, outl, arms, nd, zd, reach)
    assert int(ref.max()) == 255 and (writes == 1).all()
    np.testing.assert_array_equal(got, ref)


# ---- B9's staged stream ---------------------------------------------------

VOTE_ROWS, VOTE_SEG = 8, 256    # irv.cu IRV_ROWS, IRV_SSEG


def vote_segment(h, tile=TILE):
    """irv_segment: rows of a staged block's segment at H = h, whole
    tiles, about equal, at most VOTE_SEG."""
    nseg = -(-h // VOTE_SEG)
    return -(-(-(-h // nseg)) // tile) * tile


def strip_runs(live, x0, n, y0, y1, reach, tile=TILE):
    """irv_runs: the runs [a, b) of columns x0 .. x0 + n - 1 in the rows
    [y0, y1): the tiles' first and last voting rows over the columns, a
    tile joining the run while the rows between voters are at most
    2 * reach."""
    found, a, b = [], -1, -1
    for t in range(y0 // tile, -(-y1 // tile)):
        codes = [int(live[t, x]) for x in range(x0, x0 + n)]
        last = max(c >> 8 for c in codes)
        if last == 0:
            continue
        first = min((c & 0xFF) if c else 0xFF for c in codes)
        f, l = t * tile + first - 1, t * tile + last
        if a >= 0 and f - b > 2 * reach:
            found.append((a, b))
            a = -1
        if a < 0:
            a = f
        b = l
    if a >= 0:
        found.append((a, b))
    return found


def _funnel(lo, hi, sh):
    """__funnelshift_r of u64 arrays holding u32 words."""
    return ((hi << np.uint64(32) | lo) >> np.uint64(sh)) & U32


def _le_words(buf):
    """The little-endian u32 words of a byte buffer (a multiple of 4)."""
    return buf.view("<u4").astype(np.uint64)


def emulate_irv_vote_staged(cnt, disp, outl, up, down, thresh_s, thresh_h,
                            zd, reach, strip, stages, need=None, seg=None,
                            tile=TILE, base_off=0, seed=0):
    """irv_vote_kernel's staged path, block by block: a strip of `strip`
    columns and a segment of `seg` rows, the strip's runs, the producer's
    row copies into a ring of `stages` stages of VOTE_ROWS rows (each row
    the strip's bytes rounded out to 16-byte bounds inside the volume: one
    bulk copy, the volume's first or last bytes by hand), issued as soon
    as the consumers release a stage, and each consumer's pushes from the
    stage (its words realigned by a funnel shift), its ring of N slots
    restarted at each run, and its votes.  The volume lies in a memory
    buffer `base_off` bytes past a 16-byte bound, between random bytes;
    the stages start random.  `seg` defaults to the kernel's segment at
    H.  Returns (disp, outl) after the vote and the
    number of bytes the bulk copies read."""
    h, w, c = cnt.shape
    nb = c - 1
    gb = -(-nb // 4)
    gj = -(-gb // 32)
    s_cols, k_st = strip, stages
    seg = seg or vote_segment(h)
    n_slots = -(-(2 * reach + 2 + VOTE_ROWS) // VOTE_ROWS) * VOTE_ROWS
    rb = (s_cols * c + 30) // 16 * 16
    rng = np.random.default_rng(seed)
    total = h * w * c
    base = 64 + base_off
    mem = rng.integers(0, 256, base + total + 64, dtype=np.uint8)
    mem[base:base + total] = cnt.reshape(-1)
    vlo, vhi = -(-base // 16) * 16, (base + total) // 16 * 16
    f32 = np.float32
    disp_out, outl_out = disp.copy(), outl.copy()
    voter = outl != 0
    if need is not None:
        voter = voter & (need != 0)
    live = live_map(voter, tile)
    lanes = np.arange(32 * gj)
    left = nb - 4 * lanes
    mask = np.where(lanes >= gb, 0,
                    np.where(left >= 4, 0xFFFFFFFF,
                             (1 << (8 * np.clip(left, 0, 3))) - 1)
                    ).astype(np.uint64)
    bins = 4 * lanes[:, None] + np.arange(4)[None, :]    # (lanes, 4)
    copied = 0

    def produce(stage, stamp, bt, i0, r1, x0, n_cols):
        """Lane k of the producer: row i0 + k's copy into stage bt % K."""
        nonlocal copied
        sl = bt % k_st
        for k in range(VOTE_ROWS):
            i = i0 + k
            if i >= r1:
                continue
            s0 = base + (i * w + x0) * c
            e0 = s0 + n_cols * c
            lo, hi = s0 // 16 * 16, -(-e0 // 16) * 16
            b0, b1 = max(lo, vlo), min(hi, vhi)
            if b1 <= b0:
                b0 = b1 = e0                   # every byte by hand
            row = stage[sl, k]
            if b1 > b0:                        # the bulk copy
                assert b0 % 16 == 0 and (b1 - b0) % 16 == 0
                assert vlo <= b0 and b1 <= vhi and b1 - lo <= rb
                row[b0 - lo:b1 - lo] = mem[b0:b1]
                stamp[sl, k, b0 - lo:b1 - lo] = bt
                copied += b1 - b0
            for q in list(range(s0, b0)) + list(range(max(b1, s0), e0)):
                assert base <= q < base + total
                row[q - lo] = mem[q]
                stamp[sl, k, q - lo] = bt

    for x0 in range(0, w, s_cols):
        n_cols = min(s_cols, w - x0)
        for y0 in range(0, h, seg):
            runs = strip_runs(live, x0, n_cols, y0, min(y0 + seg, h), reach,
                              tile)
            batches = [(a, b, i0) for a, b in runs
                       for i0 in range(max(a - reach, 0), b + reach,
                                       VOTE_ROWS)]
            stage = rng.integers(0, 256, (k_st, VOTE_ROWS, rb),
                                 dtype=np.uint8)
            stamp = np.full((k_st, VOTE_ROWS, rb), -1)
            for bt in range(min(k_st, len(batches))):     # K ahead
                a, b, i0 = batches[bt]
                produce(stage, stamp, bt, i0, min(b + reach, h), x0, n_cols)
            cols = {x: {} for x in range(x0, x0 + n_cols)}
            for bt, (a, b, i0) in enumerate(batches):
                r0, r1 = max(a - reach, 0), min(b + reach, h)
                sl = bt % k_st
                for x, st in cols.items():
                    if i0 == r0:                   # a run's start
                        st.update(ring=np.zeros((n_slots, 32 * gj, 2),
                                                np.uint64),
                                  ringt=np.zeros(n_slots, np.uint64),
                                  acc=np.zeros((32 * gj, 2), np.uint64),
                                  acct=0, w=n_slots - 1)   # P[0]
                    for k in range(VOTE_ROWS):
                        i = i0 + k
                        st["w"] = (st["w"] + 1) % n_slots
                        if i < r1:
                            off = (base + (i * w + x0) * c) % 16 \
                                + (x - x0) * c
                            nw = (((off & 3) + nb - 1) >> 2) + 1
                            assert (stamp[sl, k, off:off + c] == bt).all()
                            row = stage[sl, k]
                            idx = (off >> 2) + np.arange(32 * gj + 1)
                            assert 4 * ((off >> 2) + nw) <= rb
                            wd = np.zeros(32 * gj + 1, np.uint64)
                            have = np.arange(32 * gj + 1) < nw
                            wd[have] = _le_words(row[:rb])[idx[have]]
                            v = _funnel(wd[:-1], wd[1:], 8 * (off & 3)) & mask
                            lo_pair = (v & 0xFF) | ((v >> 8) & 0xFF) << 16
                            hi_pair = ((v >> 16) & 0xFF) | (v >> 24) << 16
                            st["acc"][:, 0] = (st["acc"][:, 0] + lo_pair) & U32
                            st["acc"][:, 1] = (st["acc"][:, 1] + hi_pair) & U32
                            st["acct"] = (st["acct"] + int(row[off + nb])) \
                                & 0xFFFFFFFF
                        st["ring"][st["w"]] = st["acc"]
                        st["ringt"][st["w"]] = st["acct"]
                # every consumer released the stage: the producer refills it
                if bt + k_st < len(batches):
                    a2, b2, i2 = batches[bt + k_st]
                    produce(stage, stamp, bt + k_st, i2, min(b2 + reach, h),
                            x0, n_cols)
                for x, st in cols.items():         # the batch's votes
                    i_new = i0 + VOTE_ROWS
                    for k in range(VOTE_ROWS):
                        y = i0 + k - reach
                        if not (a <= y < b and voter[y, x]):
                            continue
                        au = min(max(int(up[y, x]), 0), reach)
                        ad = min(max(int(down[y, x]), 0), reach)
                        hi_r, lo_r = min(y + ad + 1, h), max(y - au, 0)
                        assert lo_r >= r0 and hi_r <= i_new
                        assert i_new - lo_r < n_slots
                        s_hi = (st["w"] - (i_new - hi_r)) % n_slots
                        s_lo = (st["w"] - (i_new - lo_r)) % n_slots
                        d = (st["ring"][s_hi] - st["ring"][s_lo]) & U32
                        cnts = np.stack([d[:, 0] & 0xFFFF, d[:, 0] >> 16,
                                         d[:, 1] & 0xFFFF, d[:, 1] >> 16], 1)
                        keys = np.where(mask[:, None] != 0,
                                        cnts << np.uint64(16)
                                        | (0xFFFF - bins).astype(np.uint64),
                                        0)
                        kmax = int(keys.max())
                        tot = int(st["ringt"][s_hi] - st["ringt"][s_lo]) \
                            & 0xFFFFFFFF
                        m = kmax >> 16
                        max_d = (0xFFFF - (kmax & 0xFFFF) - zd if m > 0
                                 else int(disp[y, x]))
                        ratio = f32(max_d + zd) / f32(max(tot, 1))
                        if tot > thresh_s and ratio > f32(thresh_h):
                            disp_out[y, x] = f32(max_d)
                            outl_out[y, x] = 0
    return disp_out, outl_out, copied


def _vote_inputs(h, w, nd, zd, reach, seed):
    rng = np.random.default_rng(seed)
    disp = rng.integers(-zd - 3, nd - zd + 3, (h, w)).astype(np.float32)
    disp += rng.choice(np.array([0, 0.25, -0.75], np.float32), (h, w))
    outl = (rng.random((h, w)) < 0.4).astype(np.uint8)
    disp[:, : max(1, w // 2)] = np.float32(rng.integers(1, nd - zd))
    arms = rng.integers(-1, reach + 2, (4, h, w)).astype(np.int32)
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    # a frontier: dead columns and dead 16-row bands, so that runs restart
    need = ((rng.random((h, w)) < 0.3) & (xs % 5 != 2)
            & ((ys // 16) % 3 == 0))
    return disp, outl, arms, need


STAGED_CASES = [  # (H, W, num_disp, zero_disp, reach, strip, K, tile, seg,
    #                base_off, gated); strip and K as the kernel's plan gives
    #                them at W < 240 (1, 8), 1080p (5, 2), D = 130 (4, 6),
    #                reach 127 (3, 7), or others
    (37, 10, 128, 64, 34, 1, 8, TILE, None, 0, False),  # a narrow frame
    (45, 12, 128, 64, 34, 5, 2, TILE, None, 4, True),  # 1080p's strip, K
    (75, 9, 128, 64, 34, 4, 3, 8, 24, 4, True),     # runs restart, base + 4
    (70, 11, 128, 64, 34, 1, 8, 8, None, 4, True),
    (30, 7, 64, 32, 0, 3, 2, 8, 16, 4, False),      # reach 0
    (21, 6, 130, 64, 5, 4, 2, 8, 16, 0, True),      # B = 130: two groups
    (21, 5, 130, 66, 34, 4, 6, TILE, None, 4, False),
    (22, 5, 128, 64, 127, 3, 7, TILE, None, 4, False),  # reach 127
    (41, 13, 22, 8, 6, 4, 2, 8, 24, 4, True),       # B + 1 = 23
    (3, 2, 2, 0, 1, 2, 2, 8, 16, 4, False),         # B + 1 = 3: by hand
]


@pytest.mark.parametrize(
    "h,w,nd,zd,reach,strip,k_st,tile,seg,base_off,gated", STAGED_CASES)
def test_irv_vote_staged_stream_matches_plain(h, w, nd, zd, reach, strip,
                                              k_st, tile, seg, base_off,
                                              gated):
    """The staged vote equals `irv_vote_plain`, with the volume off a
    16-byte bound or not, every consumed byte copied for its batch (no
    stage reused early), and under `need` with every span the gated B8
    may skip holding 255: the strip's runs push spans no vote of their
    column reads, whose prefixes cancel."""
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN
    disp, outl, arms, need = _vote_inputs(h, w, nd, zd, reach,
                                          seed=h * 7 + w + 100 * gated)
    ta = torch.from_numpy(arms)
    t_d, t_o = torch.from_numpy(disp), torch.from_numpy(outl)
    cnt = tirv.irv_rowspan_plain(t_d, t_o, ta[LEFT], ta[RIGHT], nd, zd,
                                 reach).numpy()
    thresh_s, thresh_h = 1, 0.05
    need_t = torch.from_numpy(need) if gated else None
    ref = tirv.irv_vote_plain(torch.from_numpy(cnt), t_d, t_o, ta[UP],
                              ta[DOWN], thresh_s, thresh_h, zd, reach,
                              need_t)
    fed = cnt
    if gated:
        allowed = rowspan_mirror((outl != 0) & need, reach, tile)
        assert allowed.any() and not allowed.all()
        fed = np.where(allowed[:, :, None], cnt, np.uint8(255))
    got_d, got_o, copied = emulate_irv_vote_staged(
        fed, disp, outl, arms[UP], arms[DOWN], thresh_s, thresh_h, zd,
        reach, strip, k_st, need if gated else None, seg, tile, base_off,
        seed=h + w)
    np.testing.assert_array_equal(got_d, ref[0].numpy())
    np.testing.assert_array_equal(got_o, ref[1].numpy())
    if h > 3 and reach > 0:
        assert (got_o != outl).any()          # some votes accept
    assert copied > 0 or h * w * (nd + 1) < 32


def test_irv_vote_staged_copy_slip_fails():
    """A consumer that takes its pixel one byte off (the realignment
    missing the row's offset in its 16 bytes) must fail the replay: the
    exact comparison above can see a wrong byte."""
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN
    h, w, nd, zd, reach = 30, 6, 128, 64, 5
    disp, outl, arms, _ = _vote_inputs(h, w, nd, zd, reach, seed=3)
    ta = torch.from_numpy(arms)
    cnt = tirv.irv_rowspan_plain(torch.from_numpy(disp),
                                 torch.from_numpy(outl), ta[LEFT], ta[RIGHT],
                                 nd, zd, reach).numpy()
    ref = tirv.irv_vote_plain(torch.from_numpy(cnt), torch.from_numpy(disp),
                              torch.from_numpy(outl), ta[UP], ta[DOWN], 1,
                              0.05, zd, reach)
    # the volume shifted by one byte stands for a consumer reading at the
    # wrong offset
    slipped = np.roll(cnt.reshape(-1), 1).reshape(cnt.shape)
    got_d, got_o, _ = emulate_irv_vote_staged(
        slipped, disp, outl, arms[UP], arms[DOWN], 1, 0.05, zd, reach,
        strip=4, stages=2, base_off=4)
    assert not (np.array_equal(got_d, ref[0].numpy())
                and np.array_equal(got_o, ref[1].numpy()))


def test_irv_vote_staged_counter():
    """`irv_vote.staged` is a counter beside `irv_vote.launches`, zeroed
    by `reset_launch_counts`; the plain version on the CPU counts
    neither."""
    from stereo_to_multiview_tpu_torch import kernels
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN
    disp, outl, arms, _ = _vote_inputs(9, 7, 16, 8, 3, seed=5)
    ta = torch.from_numpy(arms)
    t_d, t_o = torch.from_numpy(disp), torch.from_numpy(outl)
    cnt = tirv.irv_rowspan_plain(t_d, t_o, ta[LEFT], ta[RIGHT], 16, 8, 3)
    tirv.irv_vote.staged = 2
    kernels.reset_launch_counts()
    assert tirv.irv_vote.staged == 0 and tirv.irv_vote.launches == 0
    tirv.irv_vote(cnt, t_d, t_o, ta[UP], ta[DOWN], 1, 0.05, 8, 3)
    assert tirv.irv_vote.staged == 0 and tirv.irv_vote.launches == 0


G3_GRAIN, G3_TILE, G3_WARPS = 8, 16, 16        # irv.cu
U64 = (1 << 64) - 1


def emulate_irv_frontier(before, after, usd, vec, short=None):
    """irv_frontier_kernel on (H, W) u8 planes: each tile's halo block rows
    as 64-bit masks (a lane's two blocks from 16 bytes of each of their
    rows: 16-byte loads with `vec`, else bytes up to the frame's edge),
    the 2r + 1 masks of an output block row ORed, then 2r + 1 shifts, the
    tile written 16 bytes (two blocks of a row) at a time.  `short`
    replays a mutant: "rows" ORs one halo row too few, "pairs" gives the
    halo one lane too few."""
    h, w = before.shape
    r = -(-usd // G3_GRAIN) + 1
    nbh, nbw = -(-h // G3_GRAIN), -(-w // G3_GRAIN)
    need = np.full((h, w), 7, np.uint8)         # every byte written
    s = r + (r & 1)
    pairs = (s + G3_TILE + r + 1) // 2 - (short == "pairs")
    assert pairs <= 32 and G3_TILE + 2 * r <= G3_TILE + 2 * 17
    for by0 in range(0, nbh, G3_TILE):
        for bx0 in range(0, nbw, G3_TILE):
            hx0 = bx0 - s
            rows = []
            for hy in range(G3_TILE + 2 * r):    # a warp each, in turns
                by = by0 - r + hy
                lo = hi = 0
                for lane in range(32):
                    x0 = (hx0 + 2 * lane) * G3_GRAIN
                    bits = 0
                    if 0 <= by < nbh and lane < pairs and 0 <= x0 < w:
                        y0 = by * G3_GRAIN
                        n = min(G3_GRAIN, h - y0)
                        if vec:
                            assert x0 % 16 == 0 and x0 + 16 <= w
                        nx = 16 if vec else min(16, w - x0)
                        diff = (before[y0:y0 + n, x0:x0 + nx]
                                != after[y0:y0 + n, x0:x0 + nx])
                        bits = int(diff[:, :8].any()) | (
                            int(diff[:, 8:].any()) << 1)
                    if lane < 16:
                        lo |= bits << 2 * lane
                    else:
                        hi |= bits << 2 * (lane - 16)
                assert lo < 1 << 32 and hi < 1 << 32
                rows.append(hi << 32 | lo)
            tile = []
            for oy in range(G3_TILE):
                v = 0
                for k in range(2 * r + 1 - (short == "rows")):
                    v |= rows[oy + k]
                d = v
                for k in range(1, r + 1):
                    d |= (v >> k) | ((v << k) & U64)
                tile.append((d >> s) & 0xFFFF)
            for t in range(G3_TILE * G3_GRAIN * G3_TILE // 2):
                y = by0 * G3_GRAIN + t // (G3_TILE // 2)
                x = (bx0 + 2 * (t % (G3_TILE // 2))) * G3_GRAIN
                if y >= h or x >= w:
                    continue
                m = tile[t // (G3_TILE // 2) // G3_GRAIN] >> 2 * (
                    t % (G3_TILE // 2))
                nx = 16 if vec else min(16, w - x)
                for c in range(nx):
                    need[y, x + c] = (m >> (c // G3_GRAIN)) & 1
    return need


def _frontier_planes(h, w, pattern, seed):
    rng = np.random.default_rng(seed)
    before = rng.integers(0, 2, (h, w)).astype(np.uint8)
    after = before.copy()
    if pattern == "sparse":
        flip = rng.random((h, w)) < 0.002
        flip[rng.integers(h), rng.integers(w)] = True
        after[flip] ^= 1
    elif pattern == "corners":
        for y, x in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)):
            after[y, x] ^= 1
    elif pattern == "full":
        after ^= 1
    return before, after


# (h, w): tiles and halos past the frame's edges, W % 16 == 0 (the 16-byte
# path) and not, partial blocks, one row, one column, a halo wider than
# the frame
FRONTIER_CASES = [(h, w, usd, pattern)
                  for h, w in ((150, 272), (1, 1), (1, 45), (45, 1),
                               (77, 90), (133, 144))
                  for usd in (0, 1, 7, 8, 34, 127)
                  for pattern in ("sparse", "corners")]
FRONTIER_CASES += [(37, 48, 34, "empty"), (37, 48, 1, "full")]


@pytest.mark.parametrize("h,w,usd,pattern", FRONTIER_CASES)
def test_irv_frontier_replay_matches_dilate_frontier(h, w, usd, pattern):
    """G3's replay equals `dilate_frontier(after != before)` bit for bit,
    on both load paths where W % 16 == 0."""
    before, after = _frontier_planes(h, w, pattern, seed=h * w + usd)
    ref = tirv.dilate_frontier(torch.from_numpy(after != before),
                               usd).numpy().astype(np.uint8)
    for vec in ((False, True) if w % 16 == 0 else (False,)):
        np.testing.assert_array_equal(
            emulate_irv_frontier(before, after, usd, vec), ref)


@pytest.mark.parametrize("short", ["rows", "pairs"])
def test_irv_frontier_replay_short_halo_fails(short):
    """A halo one block row or one lane short must fail the replay."""
    failed = False
    for usd in (0, 34, 127):
        before, after = _frontier_planes(150, 272, "sparse", seed=usd)
        ref = tirv.dilate_frontier(torch.from_numpy(after != before),
                                   usd).numpy().astype(np.uint8)
        got = emulate_irv_frontier(before, after, usd, True, short)
        failed |= not np.array_equal(got, ref)
    assert failed
