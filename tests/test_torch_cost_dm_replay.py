"""A numpy replay of kernel B16 (csrc/cost_dm.cu), index for index, held
exactly against its plain version `cost_dm_plain`.

The replay follows the kernel's blocks (tiles of 256 columns x 4 rows,
or 64 x 8 for the right-eye strips, range a's tiles before range b's),
the staging of both eyes over the tile and the disparities' reach (gray
rows 3 either side of the block, clamped at the frame's edges, never at
the row range's; each staged word at slot k + (k >> 3) of a row pitch of
0 or 8 mod 32 words, every other slot garbage), the work items (8
columns, a row, an eye and a group of 32 planes), the 8-slot register
ring that slides one column a plane (slot (j + i) % 8 holds the other
column x0 + o + i; slot j then takes column x0 + o + 8), the planes of
each eye's offsets, and the columns a store keeps.  The census and table
arithmetic are B2's (csrc/census.cuh), which tests/test_torch_stage_replay.py
replays bit for bit; here the census is computed from the staged gray
tile with the kernel's clamps.  Two mutants must fail: the census rows
clamped to the row range, and a window one column short.  No card is
needed: this runs on the CPU in seconds.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import costkern as tck

torch.set_num_threads(1)

COLS, PLANES, SKEW, THREADS = 8, 32, 3, 256    # csrc/cost_dm.cu
RB = {256: 4, 64: 8}                           # CdTile
THIRD = np.float32(0.3333333333333)
SMEM_MAX = 227 * 1024


def slot(k):
    return k + (k >> SKEW)


def cd_smem(xb, omin, omax, elem):
    """cd_smem: (len, pitch, gwp, bytes) of a block."""
    nq = xb // COLS
    length = (xb + omax - omin + 1 + 3) & ~3
    slots = length + (length >> SKEW) + 1
    pitch = (slots - nq + 31) // 32 * 32 + nq
    gwp = (length + 11 + 3) & ~3
    tab = 816 if elem == 4 else (766 * 49 + 15) // 16 * 4
    words = tab + 2 * 3 * RB[xb] * pitch + 2 * (RB[xb] + 6) * gwp // 4
    return length, pitch, gwp, 4 * words


def layout(base, length, w):
    """cost_eye_layout: the gray origin (= base mod 4) and row pitch."""
    a = min(max(base, 0), w - 1) - 4
    gorg = a - ((a - base) & 3)
    gend = min(max(base + length - 1, 0), w - 1) + 4
    return gorg, (gend - gorg + 4) & ~3


def popcount(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def stage_eye(img, base, length, ylo, rb, pitch, gwp, gray_rows):
    """cost_stage_gray + cost_stage_census of one eye: the staged words
    (pix, c0, c1) at their slots of rb rows, -1 in every other slot.
    `gray_rows` = (lo, hi): the rows the gray's row index clamps to."""
    h, w = img.shape[:2]
    gorg, g_w = layout(base, length, w)
    assert g_w <= gwp
    ys = np.clip(np.arange(ylo - 3, ylo + rb + 3), *gray_rows)
    xs = np.clip(gorg + np.arange(g_w), 0, w - 1)
    p = img[ys][:, xs].astype(np.float32)
    acc = p[..., 0] * THIRD
    acc = acc + p[..., 1] * THIRD
    acc = acc + p[..., 2] * THIRD
    gray = acc.astype(np.int64)
    staged = np.full((3, rb * pitch), -1, np.int64)
    ks = np.arange((length + 3) & ~3)
    cc = np.clip(base + ks, 0, w - 1)
    for r in range(rb):
        y = min(max(ylo + r, 0), h - 1)
        ctr = gray[r + 3, cc - gorg]
        words = [np.zeros_like(ks), np.zeros_like(ks)]
        for dy in (-3, -2, -1, 1, 2, 3):
            for dx in (-4, -3, -2, -1, 1, 2, 3, 4):
                nb = gray[r + 3 + dy, np.clip(cc + dx, 0, w - 1) - gorg]
                words[dy > 0] = (words[dy > 0] << 1) | (nb < ctr)
        px = img[y, cc].astype(np.int64)
        s = r * pitch + slot(ks)
        assert s.max() < (r + 1) * pitch
        staged[0, s] = px[:, 0] | px[:, 1] << 8 | px[:, 2] << 16
        staged[1, s], staged[2, s] = words
    return staged


def emulate_cost_dm(img_l, img_r, nd, zd, quant=True, eyes="lr", rows=None,
                    cols=None, mutant=None):
    """The kernel's launch on numpy images: a (2D or D, nrows, W) volume,
    NaN where no store wrote."""
    h, w = img_l.shape[:2]
    row0, nrows = rows or (0, h)
    ranges = cols or ((0, w),)
    xbt = 64 if eyes == "r" else 256
    rb, nq = RB[xbt], xbt // COLS
    omin, omax = min(-zd, zd - nd + 1), max(nd - 1 - zd, zd)
    length, pitch, gwp, nbytes = cd_smem(xbt, omin, omax, 1 if quant else 4)
    assert nbytes <= SMEM_MAX and pitch % 32 == nq % 32
    if quant:
        table = tck.cost_table(10.0, 30.0).numpy().astype(np.float64)
    else:
        a, c = (t.numpy() for t in tck.cost_terms(10.0, 30.0))
    n_e = 2 if eyes == "lr" else 1
    n_g = -(-nd // PLANES)
    out = np.full((n_e * nd if eyes != "r" else nd, nrows, w), np.nan)
    gray_rows = ((row0, row0 + nrows - 1) if mutant == "census_in_range"
                 else (0, h - 1))
    step = COLS - 1 if mutant == "window_short" else COLS
    for x_lo, x_hi in ranges:
        for xb in range(x_lo, x_hi, xbt):
            for ylo in range(row0, row0 + nrows, rb):
                staged = [stage_eye(img, xb + omin, length, ylo, rb, pitch,
                                    gwp, gray_rows)
                          for img in (img_l, img_r)]
                n_rows = min(rb, row0 + nrows - ylo)
                for it in range(nq * rb * n_e * n_g):
                    q, rest = it % nq, it // nq
                    r, rest = rest % rb, rest // rb
                    e = 1 if eyes == "r" else 0 if eyes == "l" else rest % 2
                    g = rest // n_e
                    x0 = xb + q * COLS
                    if r >= n_rows or x0 >= x_hi:
                        continue
                    own, oth = staged[e], staged[1 - e]
                    olo = zd - nd + 1 if e else -zd
                    o0 = olo + g * PLANES
                    o1 = min(o0 + PLANES, olo + nd)
                    ko, row = q * COLS - omin, r * pitch
                    ic = np.arange(COLS)
                    mine = own[:, row + slot(ko + ic)]
                    ring = oth[:, row + slot(ko + o0 + ic)]
                    xs = x0 + ic
                    keep = xs < x_hi
                    for ob in range(o0, o1, COLS):
                        for j in range(COLS):
                            o = ob + j
                            if o >= o1:
                                break
                            t = ring[:, (j + ic) & (COLS - 1)]
                            ad = sum(np.abs((mine[0] >> s & 255)
                                            - (t[0] >> s & 255))
                                     for s in (0, 8, 16))
                            ham = (popcount(mine[1] ^ t[1])
                                   + popcount(mine[2] ^ t[2]))
                            assert (ad >= 0).all() and (ham <= 48).all()
                            v = (table[ad * 49 + ham] if quant
                                 else (a[ad] + c[ham]).astype(np.float64))
                            d = zd - o if e else o + zd
                            plane = nd + d if eyes == "lr" and e else d
                            out[plane, ylo + r - row0, xs[keep]] = v[keep]
                            ring[:, j] = oth[:, row + slot(ko + o + step)]
    return out


def _frame(h, w, seed):
    """Two images of smooth texture whose right eye is the left shifted
    by 3 columns with 5% of its bits flipped."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4, w + 4, 3)).astype(np.float32)
    sm = sum(base[i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9
    img = sm.astype(np.uint8)
    return img, np.roll(img, -3, axis=1) ^ (rng.random(img.shape) < 0.05)


def _check(h, w, nd, zd, quant=True, eyes="lr", rows=None, cols=None,
           seed=0, mutant=None):
    left, right = _frame(h, w, seed)
    got = emulate_cost_dm(left, right, nd, zd, quant, eyes, rows, cols,
                          mutant)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    args = (tl, tr, 10.0, 30.0, nd, zd, quant)
    if eyes == "r":
        n = rows[1] if rows else h
        vol = torch.full((nd, n, w), 7, dtype=torch.uint8 if quant
                         else torch.float32)
        want = tck.cost_dm(*args, eyes="r", rows=rows, cols=cols,
                           out=vol).numpy().astype(np.float64)
        mask = np.zeros(w, bool)
        for x0, x1 in cols:
            mask[x0:x1] = True
        assert np.isnan(got[:, :, ~mask]).all()
        return np.array_equal(got[:, :, mask], want[:, :, mask])
    want = tck.cost_dm(*args, eyes=eyes, rows=rows).numpy()
    return np.array_equal(got, want.astype(np.float64))


@pytest.mark.parametrize("h,w,nd,zd,eyes,rows", [
    (21, 40, 12, 6, "lr", None),
    (21, 40, 12, 6, "lr", (0, 9)),          # a range at the frame's top
    (21, 40, 12, 6, "lr", (6, 9)),          # inside: census rows outside it
    (21, 40, 12, 6, "lr", (12, 9)),         # at the bottom
    (9, 300, 16, 8, "lr", None),            # two tiles, the second ragged
    (6, 1, 8, 4, "lr", None),               # W = 1
    (6, 15, 8, 3, "lr", None),              # W = 15: a partial group
    (6, 17, 8, 3, "lr", None),              # W = 17
    (7, 37, 30, 11, "lr", (2, 5)),          # D = 30: one partial group
    (5, 48, 40, 0, "lr", None),             # zd = 0, two plane groups
    (5, 48, 24, 24, "l", None),             # zd = D, left eye alone
    (5, 52, 70, 35, "lr", (1, 3)),          # three plane groups
])
def test_cost_dm_replay_matches_plain(h, w, nd, zd, eyes, rows):
    assert _check(h, w, nd, zd, eyes=eyes, rows=rows)


@pytest.mark.parametrize("w,m,rows", [(40, 1, None), (90, 6, (3, 14)),
                                      (200, 64, (0, 20))])
def test_cost_dm_replay_merged_strips(w, m, rows):
    """Both right-eye strips [0, m) and [w - m, w) in one launch of 64 x 8
    tiles, written at their columns of the volume and nowhere else."""
    nd = min(2 * m, 16) if m > 1 else 2
    assert _check(20, w, nd, nd // 2, eyes="r", rows=rows,
                  cols=((0, m), (w - m, w)))


def test_cost_dm_replay_float32():
    assert _check(9, 40, 12, 6, quant=False, rows=(2, 6))


def test_cost_dm_replay_largest_block_fits():
    """D = 256 at zd = 128, the widest reach: every block's shared memory
    fits the card's 227 KB (u8 table, both tile shapes)."""
    for xb in (256, 64):
        assert cd_smem(xb, -128, 128, 1)[3] <= SMEM_MAX


def test_cost_dm_replay_census_clamped_to_the_range_fails():
    """Gray rows clamped to the row range, not the frame, differ at a
    range inside the frame."""
    assert _check(21, 40, 12, 6, rows=(6, 9))
    assert not _check(21, 40, 12, 6, rows=(6, 9), mutant="census_in_range")


def test_cost_dm_replay_window_one_column_short_fails():
    assert not _check(21, 40, 12, 6, mutant="window_short")
