"""A numpy replay of kernel B17's u8 paths (csrc/shear_dm.cu
`stm_shear_dm`), index for index, held exactly against its plain version
`shear_right_dm_plain`.

Rows of whole 16-byte words (W % 16 == 0) take `shear_dm_u8_vec_kernel`:
a persistent grid of warps walks the (row, chunk) items, item = warp +
k * (the grid's warps); a chunk is 32 * U words, lane l the words c * 32
U + l + 32 u.  Output word x of plane d reads the source words x + A and
x + A + 1 (A = floor(-s / 16), r = -s mod 16, s = d - zd), 0 outside the
row (the second not at all where r = 0), and assembles bytes r .. r + 15
of them from their 32-bit parts by funnel shifts.  Other rows take
`shear_dm_u8_kernel`: a thread 4 columns, two aligned 32-bit words and a
funnel shift where the four source bytes lie inside a row of W % 4 == 0,
else bytes.  Device memory is an array filled with a marker: a byte no
store writes, or a store outside the volume, shows.  Mutants whose
rotation is one byte off or whose source word is one word off must fail.
No card is needed.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import costkern

torch.set_num_threads(1)

U = 4                      # csrc/shear_dm.cu SHEAR_V_U
CHUNK = 32 * U
MARK = 0x5A
M32 = 0xFFFFFFFF


def funnel_r(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> sh."""
    return (((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64))
            >> np.uint64(sh)) & np.uint64(M32)


def parts(words):
    """(n, 16) bytes -> (n, 4) little-endian 32-bit parts."""
    return words.reshape(-1, 4, 4).astype(np.uint64) @ (
        np.uint64(1) << (np.uint64(8) * np.arange(4, dtype=np.uint64)))


def to_bytes(p):
    """(n, 4) 32-bit parts -> (n, 16) bytes."""
    return ((p[:, :, None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64)))
            & np.uint64(0xFF)).reshape(-1, 16)


def emulate_vec(vol, zd, mem, warps=7, mutant=None):
    """The 16-byte path on a (D, H, W) u8 volume, W % 16 == 0, written
    into `mem` (the output volume's bytes at address 0, marker-filled)."""
    nd, h, w = vol.shape
    nw = w // 16
    src = vol.reshape(nd * h, nw, 16)
    nchunks = -(-nw // CHUNK)
    items = nd * h * nchunks
    seen = np.zeros(items, np.int64)
    for warp in range(min(warps, items)):
        for item in range(warp, items, warps):
            seen[item] += 1
            row, c = divmod(item, nchunks)
            ns = zd - row // h                     # -s
            a_off, r = ns >> 4, ns & 15
            if mutant == "word_off" and row // h == 1:
                a_off += 1
            if mutant == "byte_off" and row // h == 1:
                r = (r + 1) & 15
            lane = np.arange(32)
            ow = (c * CHUNK + lane[None, :] + 32 * np.arange(U)[:, None])
            ow = ow[ow < nw]
            sa = ow + a_off

            def word(i, use):
                ok = use & (i >= 0) & (i < nw)
                out = np.zeros((len(i), 16), np.int64)
                out[ok] = src[row, i[ok]]
                return out

            a = parts(word(sa, np.ones_like(sa, bool)))
            b = parts(word(sa + 1, np.full_like(sa, r != 0, dtype=bool)))
            cat = np.concatenate([a, b], axis=1)          # (n, 8)
            q, sh = r >> 2, 8 * (r & 3)
            out = np.stack([funnel_r(cat[:, q + j], cat[:, q + j + 1], sh)
                            for j in range(4)], axis=1)
            base = row * w + 16 * ow
            mem[base[:, None] + np.arange(16)] = to_bytes(out)
    assert (seen == 1).all()


def emulate_4byte(vol, zd, mem):
    """`shear_dm_u8_kernel`: a thread the 4 columns from x = 4 (128 bx +
    t) of one (d, y) row."""
    nd, h, w = vol.shape
    aligned = w % 4 == 0
    for d in range(nd):
        s = d - zd
        for y in range(h):
            srcrow = vol[d, y].astype(np.int64)
            base = (d * h + y) * w
            for x in range(0, w, 4):
                xs = x - s
                a = xs & ~3
                if aligned and xs >= 0 and a + 8 <= w:
                    w0 = parts(np.pad(srcrow[a:a + 4], (0, 12))[None])[0, 0]
                    w1 = parts(np.pad(srcrow[a + 4:a + 8], (0, 12))[None])[0, 0]
                    v = int(funnel_r(np.array([w0]), np.array([w1]),
                                     8 * (xs & 3))[0])
                    mem[base + x:base + x + 4] = [(v >> (8 * j)) & 0xFF
                                                  for j in range(4)]
                    continue
                v = [srcrow[c] if 0 <= c < w else 0
                     for c in range(xs, xs + 4)]
                n = 4 if aligned else min(4, w - x)
                mem[base + x:base + x + n] = v[:n]


def replay(vol, zd, mutant=None):
    nd, h, w = vol.shape
    mem = np.full(nd * h * w + 64, MARK, np.int64)
    if w % 16 == 0:
        emulate_vec(vol, zd, mem, mutant=mutant)
    else:
        emulate_4byte(vol, zd, mem)
    assert (mem[nd * h * w:] == MARK).all()
    return mem[:nd * h * w].reshape(nd, h, w)


def _check(nd, h, w, zd, seed=0, mutant=None):
    vol = np.random.default_rng(seed).integers(0, 256, (nd, h, w),
                                               dtype=np.uint8)
    want = costkern.shear_right_dm_plain(torch.from_numpy(vol), zd).numpy()
    return np.array_equal(replay(vol, zd, mutant), want.astype(np.int64))


@pytest.mark.parametrize("nd,h,w,zd", [
    (20, 2, 1920, 10),       # 16-byte path: all 16 rotations, both signs
    (20, 2, 1920, 0),        # zd = 0: every s >= 0
    (20, 2, 1920, 20),       # zd = D: every s < 0
    (40, 2, 32, 20),         # rows shorter than the shifts: zero rows
    (3, 2, 4096, 1),         # two chunks a row
    (18, 2, 1004, 9),        # 4-byte words: every alignment
    (18, 2, 1001, 9),        # bytes
    (18, 2, 1, 9),           # W = 1
    (18, 2, 15, 0),
    (18, 2, 17, 18),
])
def test_shear_dm_replay_matches_plain(nd, h, w, zd):
    assert _check(nd, h, w, zd)


def test_shear_dm_replay_covers_every_rotation():
    """16 consecutive planes give r = -s mod 16 every value."""
    assert {(10 - d) & 15 for d in range(20)} == set(range(16))


@pytest.mark.parametrize("mutant", ["byte_off", "word_off"])
def test_shear_dm_replay_mutant_fails(mutant):
    assert not _check(20, 2, 1920, 10, mutant=mutant)
