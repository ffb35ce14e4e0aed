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
pieces and a byte tail.
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
