"""A numpy replay of kernels B19/B20 (csrc/warp.cu
`stm_warp_views_bounded`), index for index, held bit for bit against
their plain version `warp_views_bounded_plain`.

The replay follows the launch: blocks over (segment of up to 1024 pixels,
row, group of views), the groups as many as make the blocks fill twice
the card's block slots (3 an SM), at most one a view; both images' rows
staged in shared memory (16-byte words from an aligned row, else bytes)
where a block takes more than one view, else read from device memory;
thread t's pixels 4t .. 4t + 3 (whose disparities it loads 16 bytes at
once or 4, the same values either way); the loop over the
block's views, each view's two (segment, 3) outputs staged at float 3j of
one of two buffers (thread t's 12 values an eye as three 16-byte words);
and the store split: 16-byte words where the segment's first value is
16-byte aligned, then the tail, else 4 bytes at a time.  A sample is the
conversion-free lerp in float32, each product and sum rounded on its own,
floored, and +0.0 where floor(c) - x leaves the view's (lo, hi).  Device
memory is a float array filled with a marker: a value no store writes, or
a store outside the volume, shows.  A mutant that stores a view's words
one float off must fail.  No card is needed.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
from stereo_to_multiview_tpu_torch.ops import dibr, warpkern

torch.set_num_threads(1)

TX, PX = 256, 4                       # csrc/warp.cu WVB_TX, WVB_PX
SEG = TX * PX
OBUF = 3 * SEG
F32 = np.float32
MARK = F32(-3.5)                      # never a sample: samples are >= 0
SMEM_CAP = 227 * 1024


def view_groups(w, h, nv, sms=132):
    """The entry point's views per block and number of groups."""
    segs = -(-w // SEG)
    groups = min(-(-(2 * 3 * sms) // (segs * h)), nv)
    vpb = -(-nv // groups)
    return vpb, -(-nv // vpb)


def sample(row, x, d, s, lo, hi, w):
    """fast_lerp + lerp_f of the three channels of pixels x, or +0.0."""
    c = np.clip(x.astype(F32) + d * F32(s), F32(0), F32(w - 1))
    x0 = np.floor(c)
    w0 = np.maximum(F32(1) - np.abs(c - x0), F32(0))
    w1 = np.maximum(F32(1) - np.abs(c - (x0 + F32(1))), F32(0))
    i0 = x0.astype(np.int64)
    i1 = np.minimum(i0 + 1, w - 1)
    keep = ((i0 - x) >= lo) & ((i0 - x) <= hi)
    out = np.zeros((len(x), 3), F32)
    for ch in range(3):
        v = np.floor(w0 * row[i0 * 3 + ch].astype(F32)
                     + w1 * row[i1 * 3 + ch].astype(F32))
        out[:, ch] = np.where(keep, v, F32(0))
    return out


def emulate(img_l, img_r, dl, dr, shifts, nd, zd, sms=132, mutant=None):
    """The launch: ((va, vb) read back from emulated device memory,
    whether the memory past the volumes kept its marker)."""
    h, w = img_l.shape[:2]
    nv = len(shifts)
    sl, sr = dibr.merge_shifts(shifts)
    bl, br = warpkern._view_bounds(shifts, nd, zd)
    vpb, groups = view_groups(w, h, nv, sms)
    rb = 3 * w
    rp = (rb + 15) & ~15
    staged = vpb > 1 and 2 * rp + 4 * OBUF * 4 <= SMEM_CAP
    size = nv * h * w * 3
    mem = {e: np.full(size + 16, MARK, F32) for e in "ab"}
    for y in range(h):
        rows = []
        for img in (img_l, img_r):
            src = img[y].reshape(-1).astype(np.int64)
            if staged:
                smem = np.full(rp, -1, np.int64)
                n16 = rb // 16 * 16 if (y * rb) % 16 == 0 else 0
                smem[:n16] = src[:n16]
                smem[n16:rb] = src[n16:]
                assert (smem[:rb] >= 0).all()
                src = smem[:rb]
            rows.append(src)
        for seg0 in range(0, w, SEG):
            npx = min(SEG, w - seg0)
            # thread t's pixels 4t .. 4t + 3: every pixel of the segment
            # once
            n = np.clip(npx - PX * np.arange(TX), 0, PX)
            assert n.sum() == npx
            j = np.arange(npx)
            x = seg0 + j
            d_l, d_r = dl[y, x], dr[y, x]
            nf = 3 * npx
            for z in range(groups):
                obuf = np.full((2, 2, OBUF), MARK, F32)
                for v in range(z * vpb, min(nv, (z + 1) * vpb)):
                    buf = obuf[v & 1]
                    for e, row, d, s, (lo, hi) in (
                            (0, rows[0], d_r, sl[v], bl[v]),
                            (1, rows[1], d_l, sr[v], br[v])):
                        buf[e, :nf] = sample(row, x, d, s, lo, hi,
                                             w).reshape(-1)
                    o = ((v * h + y) * w + seg0) * 3
                    for e, name in ((0, "a"), (1, "b")):
                        dst, src = mem[name], buf[e]
                        start = 0
                        if o % 4 == 0:
                            words = nf >> 2
                            off = int(mutant == "word_off" and v == 1)
                            dst[o + off:o + off + 4 * words] = src[:4 * words]
                            start = 4 * words
                        dst[o + start:o + nf] = src[start:nf]
    clean = all((m[size:] == MARK).all() for m in mem.values())
    return tuple(mem[e][:size].reshape(nv, h, w, 3) for e in "ab"), clean


def _inputs(h, w, seed, scale):
    rng = np.random.default_rng(seed)
    img_l, img_r = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                    for _ in range(2))
    dl, dr = (rng.uniform(-scale, scale, (h, w)).astype(F32)
              for _ in range(2))
    return img_l, img_r, dl, dr


def _check(h, w, num_views, nd=16, zd=8, scale=12.0, mutant=None, seed=0,
           sms=132):
    ins = _inputs(h, w, seed, scale)
    shifts = _synth_shifts(num_views)
    got, clean = emulate(*ins, shifts, nd, zd, sms, mutant)
    want = warpkern.warp_views_bounded_plain(
        *(torch.from_numpy(a) for a in ins), shifts, nd, zd)
    return clean and all(
        np.array_equal(g.view(np.int32), wt.numpy().view(np.int32))
        for g, wt in zip(got, want))


@pytest.mark.parametrize("h,w,num_views,sms", [
    (200, 1001, 8, 132),     # 3003 floats a row: every alignment; 1 group
    (200, 1001, 40, 132),    # 38 views in 4 groups of 10
    (37, 17, 8, 132),        # W = 17: one view a block, rows unstaged
    (37, 17, 8, 1),          # one group: rows staged
    (3, 2100, 3, 1),         # three segments, the last partial
    (2, 1, 4, 1),            # W = 1
])
def test_warp_bounded_replay_matches_plain(h, w, num_views, sms):
    assert _check(h, w, num_views, sms=sms)


def test_warp_bounded_replay_groups():
    """The launch's view groups at the chip_smoke shapes."""
    assert view_groups(1920, 1080, 6) == (6, 1)
    assert view_groups(3840, 2160, 14) == (14, 1)
    assert view_groups(1001, 200, 38) == (10, 4)
    assert view_groups(1920, 1080, 1) == (1, 1)
    assert view_groups(17, 37, 6) == (1, 6)


def test_warp_bounded_replay_zeros_are_positive():
    """Disparities far outside the range: most samples are +0.0, never
    -0.0, and the plain version agrees bit for bit."""
    ins = _inputs(4, 300, 1, 60.0)
    shifts = _synth_shifts(6)
    (va, vb), _ = emulate(*ins, shifts, 16, 8, sms=1)
    for v in (va, vb):
        zero = v == 0
        assert zero.mean() > 0.5
        assert not np.signbit(v[zero]).any()
    assert _check(4, 300, 6, scale=60.0, seed=1, sms=1)


def test_warp_bounded_replay_one_word_off_fails():
    assert not _check(8, 1024, 6, mutant="word_off", sms=1)
