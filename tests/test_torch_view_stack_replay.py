"""A numpy replay of B12's view stack (csrc/warp.cu `stm_warp_merge`),
index for index, held exactly against its plain version
`warp_merge_views_plain`.

The replay follows the kernel's blocks (a segment of up to 1024 pixels
of one row), the staged rows of both images (3W bytes each, padded to 16,
copied 16 bytes at a time from an aligned row, else byte by byte), the
pixels a thread owns (j = t + 256 k), the loop over every view with its
two alternating buffers, and the store split of each view's segment:
byte b of the segment staged at buffer offset off + b, off = the
destination's address mod 16, then the bytes before the first 16-byte
boundary one at a time, 16-byte words, and the tail.  Device memory is
an array filled with a marker: a byte no store writes, or a store
outside the volume, shows.  The merge's arithmetic is `merge_u8` in
float32, each product and sum rounded on its own; tests/test_torch_synthesis.py
replays its conversion-free form, and a test here the pixels whose
merge is one sample's lerp.  A mutant that stores a view's segment one
byte off must fail.  No card is needed.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import dibr

torch.set_num_threads(1)

TX, PX = 256, 4                      # csrc/warp.cu WMV_TX, WMV_PX
SEG = TX * PX
OBUF = 3 * SEG + 16
F32 = np.float32
MARK = 0xA5


def to_u8(v):
    """(uint8_t)(long long)v."""
    return np.trunc(v).astype(np.int64) & 0xFF


def lerp(row, x, d, s, w):
    """make_lerp + lerp_u8 of the three channels of pixels x."""
    c = x.astype(F32) + d * F32(s)
    c = np.clip(c, F32(0), F32(w - 1))
    x0 = np.floor(c)
    w0 = np.maximum(F32(1) - np.abs(c - x0), F32(0))
    w1 = np.maximum(F32(1) - np.abs(c - (x0 + F32(1))), F32(0))
    i0 = x0.astype(np.int64)
    i1 = np.minimum(i0 + 1, w - 1)
    return np.stack([to_u8(w0 * row[i0 * 3 + ch].astype(F32)
                           + w1 * row[i1 * 3 + ch].astype(F32))
                     for ch in range(3)], axis=-1)


def merge(row_l, row_r, x, dl, dr, ml, mr, m, sl, sr, w):
    """merge_u8 of pixels x at shifts (sl, sr), (n, 3)."""
    from_l = to_u8(lerp(row_l, x, dr, sl, w).astype(F32) * mr[:, None])
    from_r = to_u8(lerp(row_r, x, dl, sr, w).astype(F32) * ml[:, None])
    b = to_u8((F32(1) - m)[:, None] * from_l.astype(F32))
    a = to_u8(m[:, None] * from_r.astype(F32))
    return (b + a) & 0xFF


def emulate_stack(img_l, img_r, dl, dr, ml, mr, fm, shifts, base=0,
                  mutant=None):
    """The kernel's launch: (nv, H, W, 3) read back from an emulated
    device memory whose volume starts at byte address `base`."""
    h, w = img_l.shape[:2]
    nv = len(shifts)
    sl, sr = dibr.merge_shifts(shifts)
    rb = 3 * w
    rp = (rb + 15) & ~15
    mem = np.full(base + nv * h * rb + 32, MARK, np.int64)
    for y in range(h):
        for seg0 in range(0, w, SEG):
            npx = min(SEG, w - seg0)
            smem = np.full(2 * rp + 2 * OBUF, MARK, np.int64)
            for i, img in enumerate((img_l, img_r)):
                src = img[y].reshape(-1).astype(np.int64)
                # 16-byte words from an aligned row (its address y * rb),
                # then the tail; else bytes: either way every byte
                n16 = rb // 16 * 16 if (y * rb) % 16 == 0 else 0
                smem[i * rp:i * rp + n16] = src[:n16]
                smem[i * rp + n16:i * rp + rb] = src[n16:]
            row_l, row_r = smem[:rb], smem[rp:rp + rb]
            j = np.arange(npx)
            owner = [(j[k * TX:(k + 1) * TX]) for k in range(PX)]
            assert np.array_equal(np.concatenate(owner), j)
            x = seg0 + j
            planes = [p[y, x] for p in (dl, dr, ml, mr, fm)]
            nb = 3 * npx
            for v in range(nv):
                gofs = base + ((v * h + y) * rb + seg0 * 3)
                off = gofs & 15
                ob = 2 * rp + (v & 1) * OBUF + off
                vals = merge(row_l, row_r, x, *planes, sl[v], sr[v], w)
                shift = int(mutant == "one_byte_off" and v == 1)
                smem[ob + shift + 3 * j[:, None] + np.arange(3)] = vals
                head = min((16 - off) & 15, nb)
                words = (nb - head) >> 4
                if words:
                    assert (gofs + head) % 16 == 0
                    assert (ob + head - 2 * rp) % 16 == 0
                body = slice(head, head + 16 * words)
                mem[gofs + body.start:gofs + body.stop] = smem[
                    ob + body.start:ob + body.stop]
                mem[gofs:gofs + head] = smem[ob:ob + head]
                mem[gofs + body.stop:gofs + nb] = smem[ob + body.stop:ob + nb]
    assert (mem[:base] == MARK).all() and (mem[base + nv * h * rb:]
                                           == MARK).all()
    return mem[base:base + nv * h * rb].reshape(nv, h, w, 3)


def _inputs(h, w, seed, wild=False):
    """Images, disparities in (-8, 8) (samples clamped at both borders),
    {0, 1} masks and a feather in [0, 1]; with `wild`, masks and feather
    outside [0, 1] (products that wrap)."""
    rng = np.random.default_rng(seed)
    img_l, img_r = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                    for _ in range(2))
    dl, dr = (rng.uniform(-8, 8, (h, w)).astype(F32) for _ in range(2))
    if wild:
        ml, mr, fm = (rng.uniform(-0.5, 2.5, (h, w)).astype(F32)
                      for _ in range(3))
    else:
        ml, mr = ((rng.random((h, w)) < 0.8).astype(F32) for _ in range(2))
        fm = rng.random((h, w)).astype(F32)
    return img_l, img_r, dl, dr, ml, mr, fm


def _check(h, w, nv, base=0, wild=False, mutant=None, seed=0):
    ins = _inputs(h, w, seed, wild)
    shifts = dibr.synth_shifts(nv + 2)
    got = emulate_stack(*ins, shifts, base, mutant)
    want = dibr.warp_merge_views_plain(
        *(torch.from_numpy(a) for a in ins), shifts).numpy()
    return np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("h,w,nv,base", [
    (3, 40, 6, 0),          # 120-byte rows: a multiple of 8, not of 16
    (2, 1, 3, 0),           # W = 1
    (2, 17, 16, 0),         # W = 17, 16 views
    (4, 1001, 2, 0),        # 3003-byte rows: every alignment
    (2, 2100, 3, 0),        # three segments, the last partial
    (2, 64, 36, 5),         # 38-view stack's 36; the volume at byte 5
    (3, 37, 4, 111111 % 16),  # a 37x1001 stack's middle views' offset
])
def test_view_stack_replay_matches_plain(h, w, nv, base):
    assert _check(h, w, nv, base)


def test_view_stack_replay_masks_outside_unit():
    assert _check(3, 50, 4, wild=True)


def test_view_stack_one_sample_pixels():
    """The kernel's one-sample pixels: where the feather is 0 and mask_r
    1 the merge is the left image's lerp alone, where the feather is 1
    and mask_l 1 the right image's, whatever the other mask."""
    img_l, img_r, dl, dr, ml, mr, fm = _inputs(4, 60, 3, wild=True)
    fm[:2], mr[:2] = 0.0, 1.0
    fm[2:], ml[2:] = 1.0, 1.0
    fm[0, :10] = -0.0
    x = np.arange(60)
    for s in dibr.synth_shifts(5):
        sl, sr = (v[0] for v in dibr.merge_shifts([s]))
        for y in range(4):
            got = merge(img_l[y].reshape(-1), img_r[y].reshape(-1), x,
                        dl[y], dr[y], ml[y], mr[y], fm[y], sl, sr, 60)
            row, d, sh = ((img_l, dr, sl) if y < 2 else (img_r, dl, sr))
            want = lerp(row[y].reshape(-1), x, d[y], sh, 60)
            assert np.array_equal(got, want)


def test_view_stack_replay_one_byte_off_fails():
    assert not _check(3, 40, 3, mutant="one_byte_off")
