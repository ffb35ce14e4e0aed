"""Numpy emulation of the streaming schedule of kernels B4 and B6 (the
horizontal window passes, `csrc/hpass.cu`), held exactly against their
plain versions `h_pass_sum_plain` and `h_pass_wta_plain`.

The CUDA kernel runs only on the card; this emulation replays its index
logic step by step on the CPU, line for line, vectorised over the warps
of a segment and their lanes: the segments and their priming over the
reach, the right-end flush, the batches, the ring slots and the reach
lag, the u16 prefixes packed two a word (pass 1 on u8 costs), the u32
prefixes of pass 1 on int16 costs (band_qscale > 127.5) and of pass 4,
the bf16 rounding of each pass-4 input as its batch comes up
(band_lossy_wta), the chunks of d beyond 4 * G, the windows handed out
by shuffle, and the in-warp first minimum.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import band as tband

torch.set_num_threads(1)

HP_STEP_SUM, HP_STEP_WTA, HP_SEG = 16, 8, 256     # hpass.cu
MAX = 0xFFFFFFFF


def _slot(w, jn, j, n):
    s = w - (jn - j)
    return np.where(s < 0, s + n, s)


def launch_geometry(w, nd, reach, wta=False):
    """launch_hpass: (nseg, S, N, G, STEP)."""
    nseg = -(-w // HP_SEG)
    step = HP_STEP_WTA if wta else HP_STEP_SUM
    return (nseg, -(-w // nseg), 2 * reach + step + 1,
            16 if nd <= 64 else 32, step)


def vector_path(vol) -> bool:
    """launch_hpass's test for the vector loads and stores: D % 4 == 0,
    the row stride and the base offset aligned to one lane's 4 d."""
    nd = vol.shape[2]
    item = vol.itemsize
    base = vol.__array_interface__["data"][0] - (
        vol.base.__array_interface__["data"][0] if vol.base is not None
        else vol.__array_interface__["data"][0])
    return (nd % 4 == 0 and (vol.strides[0] // item) % 4 == 0
            and base % (4 * item) == 0)


def _load(vol, rows, q, d0, nd_lane):
    """hp_load for every (warp, lane): the lane's 4 values (0 where d or
    the row does not exist), shape (warps, 32, 4)."""
    h = vol.shape[0]
    v = np.zeros(d0.shape + (4,), np.int64)
    for j in range(4):
        ok = j < nd_lane
        d = np.where(ok, d0 + j, 0)
        v[..., j] = np.where(ok, vol[np.minimum(rows, h - 1), q, d], 0)
    return v


def _bf16(v):
    """hp_bf16: each value rounded to bf16 (round to nearest, ties to even)
    on its float32 bits, and back to an integer."""
    bits = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return bits.astype(np.uint32).view(np.float32).astype(np.int64)


def _add(prefix, v, u8):
    """hp_add: u8 packs d0 | d1 << 16 and d2 | d3 << 16 (__byte_perm
    0x4140, 0x4342) and adds them to two u32 words; int32 adds each d."""
    if u8:
        words = np.stack([v[..., 0] | (v[..., 1] << 16),
                          v[..., 2] | (v[..., 3] << 16)], axis=-1)
        return prefix + words.astype(np.uint32)
    return prefix + v.astype(np.uint32)      # wraps like u32


def _sums(hi, lo, u8):
    """hp_sums: the 4 window sums as uint32 (the u16 halves of each word's
    wrapped difference for u8)."""
    s = (hi - lo).astype(np.uint32)
    if u8:
        return np.stack([s[..., 0] & 0xFFFF, s[..., 0] >> 16,
                         s[..., 1] & 0xFFFF, s[..., 1] >> 16], axis=-1)
    return s


def emulate_hpass(vol, arm_neg, arm_pos, reach, shift=0, zd=None,
                  carry=True, lossy=False):
    """hpass_kernel for every warp: the (H, W, D) int32 sums, or with `zd`
    the (H, W) float32 first-min WTA (each input rounded to bf16 first
    with `lossy`), and the number of writes of each output.  `carry=False`
    drops the carries out of the low u16 halves of pass 1's prefixes (a
    deliberately broken prefix, for the test that the wraps are
    exercised)."""
    h, w, nd = vol.shape
    u8 = vol.dtype == np.uint8
    wta = zd is not None
    nseg, seg_w, n, g_lanes, step = launch_geometry(w, nd, reach, wta)
    rows_a_warp = 32 // g_lanes
    nwarps = -(-h // rows_a_warp)
    lane = np.arange(32)
    r, g = lane // g_lanes, lane % g_lanes
    y0 = np.arange(nwarps)[:, None] * rows_a_warp           # (warps, 1)
    y = y0 + r[None, :]                                      # (warps, 32)
    row_ok = y < h
    ar, ak = lane // step, lane % step
    arm_y = y0 + ar[None, :]
    arm_lane = (ar[None, :] < rows_a_warp) & (arm_y < h)
    arm_y = np.minimum(arm_y, h - 1)
    src0 = r * step
    half = 1 << (shift - 1) if shift else 0
    nchunk = -(-nd // (4 * g_lanes))
    words = 2 if u8 else 4
    out = (np.full((h, w), np.nan, np.float32) if wta
           else np.zeros((h, w, nd), np.int32))
    writes = np.zeros((h, w) if wta else (h, w, nd), np.int64)
    wi = np.arange(nwarps)[:, None]

    for seg in range(nseg):
        x0, x1 = seg * seg_w, min(seg * seg_w + seg_w, w)
        q0, q1 = max(x0 - reach, 0), min(x1 + reach, w)
        steps = x1 + reach - q0
        best = np.zeros((nwarps, seg_w, 2), np.int64)
        for c in range(nchunk):
            d0 = np.broadcast_to(c * 4 * g_lanes + 4 * g, (nwarps, 32))
            nd_lane = np.where(row_ok, nd - d0, 0)
            prefix = np.zeros((nwarps, 32, words), np.uint32)
            ring = np.zeros((n, nwarps, 32, words), np.uint32)
            ring[0] = prefix
            slot_w = 0

            def loads(i1):
                vs = []
                for k in range(step):
                    q = q0 + i1 + k
                    vs.append(_load(vol, y, min(q, w - 1), d0,
                                    nd_lane if q < q1 else 0))
                x = q0 + i1 + ak - reach
                ok = arm_lane & (x >= x0) & (x < x1)
                xc = np.clip(x, 0, w - 1)
                return (vs, np.where(ok, arm_neg[arm_y, xc], 0),
                        np.where(ok, arm_pos[arm_y, xc], 0))

            nxt = loads(0)
            for i0 in range(0, steps, step):
                v, an_raw, ap_raw = nxt
                if i0 + step < steps:
                    nxt = loads(i0 + step)
                w0 = slot_w
                npush = min(step, q1 - q0 - i0)
                for k in range(step):
                    if k < npush:
                        if lossy:
                            prefix = _add(prefix, _bf16(v[k]), u8)
                        elif carry or not u8:
                            prefix = _add(prefix, v[k], u8)
                        else:
                            lo = (prefix & 0xFFFF) + (_add(
                                np.zeros_like(prefix), v[k], u8) & 0xFFFF)
                            hi = ((prefix >> 16) + (_add(
                                np.zeros_like(prefix), v[k], u8) >> 16))
                            prefix = ((hi << 16) | (lo & 0xFFFF)).astype(
                                np.uint32)
                        slot = w0 + k + 1
                        ring[slot if slot < n else slot - n] = prefix
                if npush > 0:
                    slot_w = (w0 + npush if w0 + npush < n
                              else w0 + npush - n)
                jn = min(i0 + step, q1 - q0)
                x = q0 + i0 + ak - reach
                ok = arm_lane & (x >= x0) & (x < x1)
                an = np.clip(an_raw, 0, reach)
                ap = np.clip(ap_raw, 0, reach)
                hi_j = np.minimum(x + ap, w) - q0
                lo_j = np.maximum(x - an, 0) - q0
                win = np.where(ok, (hi_j << 16) | lo_j, (jn << 16) | jn)

                res = np.zeros((nwarps, 32), np.int64)
                res_m = np.zeros((nwarps, 32), np.int64)
                for k in range(step):
                    wk = win[:, src0 + k]                    # the shuffle
                    xk = q0 + i0 + k - reach
                    if xk < x0 or xk >= x1:
                        continue
                    sh = _slot(slot_w, jn, wk >> 16, n)
                    sl = _slot(slot_w, jn, wk & 0xFFFF, n)
                    assert (sh >= 0).all() and (sl >= 0).all()
                    ph = ring[sh, wi, lane[None, :]]
                    pl = ring[sl, wi, lane[None, :]]
                    s = _sums(ph, pl, u8).astype(np.int64)
                    if not wta:
                        o = (s + half) >> shift
                        for j in range(4):
                            m = row_ok & (j < nd_lane)
                            yy, ll = np.nonzero(m)
                            dd = d0[yy, ll] + j
                            out[y[yy, ll], xk, dd] = o[yy, ll, j]
                            writes[y[yy, ll], xk, dd] += 1
                        continue
                    bv = np.full((nwarps, 32), MAX, np.int64)
                    bd = np.full((nwarps, 32), MAX, np.int64)
                    for j in range(4):
                        take = (j < nd_lane) & (s[..., j] < bv)
                        bv = np.where(take, s[..., j], bv)
                        bd = np.where(take, d0 + j, bd)
                    for rr in range(rows_a_warp):
                        m = np.where(r == rr, bv, MAX).min(axis=1)
                        a = np.where((r == rr) & (bv == m[:, None]), bd,
                                     MAX).min(axis=1)
                        res_m[:, rr * step + k] = m
                        res[:, rr * step + k] = a
                if wta:
                    x = q0 + i0 + ak - reach
                    ok = arm_lane & (x >= x0) & (x < x1)
                    for wv, ln in zip(*np.nonzero(ok)):
                        xi = x[ln] - x0
                        m, a = res_m[wv, ln], res[wv, ln]
                        if c > 0 and not m < best[wv, xi, 0]:
                            m, a = best[wv, xi]
                        if c + 1 < nchunk:
                            best[wv, xi] = (m, a)
                        else:
                            out[arm_y[wv, ln], x[ln]] = np.float32(a - zd)
                            writes[arm_y[wv, ln], x[ln]] += 1
    return out, writes


def _inputs(h, w, nd, reach, seed, dtype, vmax):
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, vmax, (h, w, nd)).astype(dtype)
    an = rng.integers(-2, reach + 3, (h, w)).astype(np.int32)
    ap = rng.integers(-2, reach + 3, (h, w)).astype(np.int32)
    return vol, an, ap


def _plain_sum(vol, an, ap, shift, reach):
    return tband.h_pass_sum_plain(torch.from_numpy(vol), torch.from_numpy(an),
                                  torch.from_numpy(ap), shift,
                                  reach).numpy()


def _plain_wta(vol, an, ap, zd, reach, lossy=False):
    return tband.h_pass_wta_plain(torch.from_numpy(vol), torch.from_numpy(an),
                                  torch.from_numpy(ap), zd, reach,
                                  lossy).numpy()


SUM_CASES = [     # (H, W, D, reach, shift): pass 1 on u8 costs
    (3, 100, 128, 34, 0),            # W < S
    (2, 256, 64, 5, 0),              # W == S, two rows a warp
    (3, 600, 30, 34, 7),             # W no multiple of S, D % 4 != 0
    (2, 301, 128, 0, 0),             # reach 0: empty windows
    (1, 520, 130, 5, 3),             # D > 128: two chunks of d
    (5, 33, 64, 34, 0),              # odd rows, W < 2 * reach
]


@pytest.mark.parametrize("h,w,nd,reach,shift", SUM_CASES)
def test_pass1_stream_matches_plain(h, w, nd, reach, shift):
    """The streamed pass 1 writes every element once and equals
    `h_pass_sum_plain`, arms beyond [0, reach] and windows clipped by the
    row included."""
    vol, an, ap = _inputs(h, w, nd, reach, h * 131 + w, np.uint8, 256)
    got, writes = emulate_hpass(vol, an, ap, reach, shift)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, _plain_sum(vol, an, ap, shift, reach))


@pytest.mark.parametrize("digits", [1, 2, 3])
def test_pass1_stream_at_digits_shifts(digits):
    """Pass 1 at the rescale shift of each band_digits setting (usd=34:
    7, 0, 0)."""
    reach = 34
    s1 = tband.agg_rescale_shifts(reach, digits)[0]
    vol, an, ap = _inputs(2, 300, 128, reach, digits, np.uint8, 256)
    got, _ = emulate_hpass(vol, an, ap, reach, s1)
    np.testing.assert_array_equal(got, _plain_sum(vol, an, ap, s1, reach))


def test_pass1_stream_on_the_left_eye_view():
    """The left eye is a column slice of the pair volume: a strided view
    whose offset and row stride keep the vector path at D = 128."""
    h, w, nd, zd, reach = 2, 280, 128, 64, 34
    margin = max(zd, nd - zd)
    pair, an, ap = _inputs(h, w + 2 * margin, nd, reach, 9, np.uint8, 256)
    an, ap = an[:, :w].copy(), ap[:, :w].copy()
    left = pair[:, margin:margin + w]
    assert not left.flags.c_contiguous and vector_path(left)
    assert not vector_path(pair[:, 1:w + 1, :126])
    got, _ = emulate_hpass(left, an, ap, reach)
    ref = tband.h_pass_sum(torch.from_numpy(pair)[:, margin:margin + w],
                           torch.from_numpy(an), torch.from_numpy(ap), 0,
                           reach)
    np.testing.assert_array_equal(got, ref.numpy())


def test_pass1_u16_prefixes_wrap_exactly():
    """Costs near 255 over a whole segment carry the u16 prefix halves
    past 2^16; the wrapped word differences stay exact.  Dropping the
    carry out of the low halves breaks exactly these windows."""
    h, w, nd, reach = 2, 512, 64, 34
    rng = np.random.default_rng(3)
    vol = (255 - rng.integers(0, 16, (h, w, nd))).astype(np.uint8)
    an = rng.integers(0, reach + 1, (h, w)).astype(np.int32)
    ap = rng.integers(0, reach + 1, (h, w)).astype(np.int32)
    # the first segment streams columns [0, 256 + reach)
    assert launch_geometry(w, nd, reach)[:2] == (2, 256)
    assert int(vol[0, :256 + reach, 0].astype(np.int64).sum()) > 1 << 16
    ref = _plain_sum(vol, an, ap, 0, reach)
    got, _ = emulate_hpass(vol, an, ap, reach)
    np.testing.assert_array_equal(got, ref)
    broken, _ = emulate_hpass(vol, an, ap, reach, carry=False)
    assert (broken != ref).any()


WTA_CASES = [     # (H, W, D, reach, zd, vmax): pass 4 + WTA on int32
    (3, 100, 128, 34, 64, 17_600),   # W < S
    (3, 256, 64, 5, 32, 17_600),     # W == S, two rows a warp (one past H)
    (2, 600, 30, 34, 10, 17_600),    # D % 4 != 0, W no multiple of S
    (2, 301, 128, 0, 64, 17_600),    # reach 0: every sum is 0, d = 0
    (1, 300, 130, 5, 60, 17_600),    # D > 128: the minimum across chunks
    (3, 260, 128, 34, 64, 2),        # many ties: the first minimum
    (2, 290, 132, 5, 66, 2),         # ties across the two chunks of d
]


@pytest.mark.parametrize("h,w,nd,reach,zd,vmax", WTA_CASES)
def test_pass4_wta_stream_matches_plain(h, w, nd, reach, zd, vmax):
    """The streamed pass 4 + WTA writes every pixel once and equals
    `h_pass_wta_plain` (the first minimum on ties)."""
    vol, an, ap = _inputs(h, w, nd, reach, h * 7 + w, np.int32, vmax)
    got, writes = emulate_hpass(vol, an, ap, reach, zd=zd)
    assert (writes == 1).all()
    ref = _plain_wta(vol, an, ap, zd, reach)
    np.testing.assert_array_equal(got, ref)
    if vmax == 2:
        # ties are common: the last minimum would differ somewhere
        sums = _plain_sum(vol, an, ap, 0, reach)
        last = sums.shape[2] - 1 - np.argmin(sums[:, :, ::-1], axis=2)
        assert (last - zd != ref).any()


@pytest.mark.parametrize("h,w,nd,reach", [(3, 100, 128, 34),
                                          (2, 600, 30, 5),
                                          (3, 256, 64, 34)])
def test_pass4_sum_stream_matches_plain(h, w, nd, reach):
    """Pass 4 without the WTA (the volume of the scanline optimisation):
    u32 prefixes, int32 sums, every element written once."""
    vol, an, ap = _inputs(h, w, nd, reach, w, np.int32, 17_600)
    got, writes = emulate_hpass(vol, an, ap, reach)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, _plain_sum(vol, an, ap, 0, reach))


def test_pass4_u32_prefixes_wrap_exactly():
    """Pass-4 inputs near the digits=3 bound carry the u32 prefixes past
    2^32 within a segment; the differences stay exact.  Held against int64
    window sums."""
    h, w, nd, reach = 1, 512, 64, 34
    rng = np.random.default_rng(11)
    vol = rng.integers(25_000_000, 31_000_000, (h, w, nd)).astype(np.int32)
    an = rng.integers(-2, reach + 3, (h, w)).astype(np.int32)
    ap = rng.integers(-2, reach + 3, (h, w)).astype(np.int32)
    assert int(vol[0, :256 + reach, 0].astype(np.int64).sum()) > 1 << 32
    got, _ = emulate_hpass(vol, an, ap, reach)
    cs = np.concatenate([np.zeros((h, 1, nd), np.int64),
                         np.cumsum(vol.astype(np.int64), axis=1)], axis=1)
    x = np.arange(w)[None, :]
    lo = np.maximum(x - np.clip(an, 0, reach), 0)
    hi = np.minimum(x + np.clip(ap, 0, reach), w)
    rows = np.arange(h)[:, None]
    ref = cs[rows, hi] - cs[rows, lo]
    assert ref.max() < 1 << 31
    np.testing.assert_array_equal(got, ref)


I16_CASES = [     # (H, W, D, reach, shift, vmax): pass 1 on int16 costs
    (3, 100, 128, 34, 0, 1021),      # qscale 510, digits 3: s1 = 0
    (2, 300, 128, 34, 2, 1021),      # qscale 510, digits 2
    (2, 600, 64, 34, 9, 1021),       # qscale 510, digits 1; two rows a warp
    (3, 301, 30, 5, 4, 8001),        # qscale 4000; D % 4 != 0
    (1, 520, 130, 34, 6, 32768),     # the int16 ceiling; D > 128
    (2, 301, 128, 0, 0, 32768),      # reach 0
]


@pytest.mark.parametrize("h,w,nd,reach,shift,vmax", I16_CASES)
def test_pass1_int16_stream_matches_plain(h, w, nd, reach, shift, vmax):
    """Pass 1 on the int16 costs of band_qscale > 127.5: u32 prefixes (a
    window reaches 129 x 32766 > 2^16), every element written once, equal
    to `h_pass_sum_plain`."""
    vol, an, ap = _inputs(h, w, nd, reach, h * 17 + w, np.int16, vmax)
    got, writes = emulate_hpass(vol, an, ap, reach, shift)
    assert (writes == 1).all()
    ref = _plain_sum(vol, an, ap, shift, reach)
    np.testing.assert_array_equal(got, ref)
    if vmax > 8000 and reach and not shift:
        assert ref.max() >= 1 << 16


def test_pass1_int16_stream_on_the_left_eye_view():
    """The int16 left eye is a column slice of the pair volume; its offset
    and row stride keep the 8-byte vector loads at D = 128."""
    h, w, nd, zd, reach = 2, 280, 128, 64, 34
    margin = max(zd, nd - zd)
    pair, an, ap = _inputs(h, w + 2 * margin, nd, reach, 4, np.int16, 1021)
    an, ap = an[:, :w].copy(), ap[:, :w].copy()
    left = pair[:, margin:margin + w]
    assert not left.flags.c_contiguous and vector_path(left)
    got, _ = emulate_hpass(left, an, ap, reach, 2)
    ref = tband.h_pass_sum(torch.from_numpy(pair)[:, margin:margin + w],
                           torch.from_numpy(an), torch.from_numpy(ap), 2,
                           reach)
    np.testing.assert_array_equal(got, ref.numpy())


def test_bf16_rounding_matches_torch():
    """The replay's bit-level rounding equals torch's float32 -> bf16 (the
    plain version's), ties to even included."""
    rng = np.random.default_rng(8)
    v = np.concatenate([np.arange(0, 4096), rng.integers(0, 1 << 24, 50_000),
                        (np.arange(1, 2000) << 9) + 256]).astype(np.int32)
    ref = tband.round_bf16(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_bf16(v), ref)
    assert (ref != v).any() and (ref[:256] == v[:256]).all()


LOSSY_CASES = [   # (H, W, D, reach, zd, vmax): pass 4 + lossy WTA
    (3, 100, 128, 34, 64, 243_148),  # the digits=3 bound at usd=34
    (2, 300, 64, 5, 32, 1_525_201),  # the digits=3 bound at usd=5
    (2, 600, 30, 34, 10, 32_768),    # digits=2 inputs; D % 4 != 0
    (1, 300, 130, 5, 60, 243_148),   # D > 128: the minimum across chunks
    (3, 260, 128, 34, 64, 2),        # ties: the first minimum
]


@pytest.mark.parametrize("h,w,nd,reach,zd,vmax", LOSSY_CASES)
def test_pass4_lossy_wta_stream_matches_plain(h, w, nd, reach, zd, vmax):
    """band_lossy_wta: each int32 input rounded to bf16 as its batch comes
    up, then the exact u32 window sums and the first minimum; equal to
    `h_pass_wta_plain(..., lossy=True)`.  Large inputs lie within 4096 of
    the bound, closer than a bf16 step there, so the rounding moves
    argmins and the test is not the exact pass in disguise."""
    vol, an, ap = _inputs(h, w, nd, reach, h * 5 + w, np.int32, vmax)
    if vmax > 1 << 16:
        vol = vmax - 1 - vol % 4096
    got, writes = emulate_hpass(vol, an, ap, reach, zd=zd, lossy=True)
    assert (writes == 1).all()
    ref = _plain_wta(vol, an, ap, zd, reach, lossy=True)
    np.testing.assert_array_equal(got, ref)
    if vmax > 1 << 16:
        assert (ref != _plain_wta(vol, an, ap, zd, reach)).any()
