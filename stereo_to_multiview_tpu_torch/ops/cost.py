"""Census transform and Hamming distance for the AD-census cost.

Census codes are 48 bits held as two int32 words of 24 bits each (the
JAX package's two-u32 layout), so the cost kernel can popcount them with
two 32-bit `__popc`s.
"""

from __future__ import annotations

import torch


def clamp_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices lo..hi-1 clamped into [0, n) (clamp-to-edge reads)."""
    return torch.arange(lo, hi, device=device).clamp_(0, n - 1)


def census_transform_9x7(gray: torch.Tensor) -> torch.Tensor:
    """Census code of (H, W) uint8 grayscale over a 9(w) x 7(h) window.

    Returns (H, W, 2) int32: word 0 packs the 24 comparisons of rows
    dy in {-3, -2, -1}, word 1 the rows dy in {1, 2, 3} (dx in
    {-4..4} minus 0 each, raster order, shift-then-set).  The anchor row
    and anchor column are excluded.  Bit set iff neighbor < center;
    clamp-to-edge reads."""
    h, w = gray.shape
    g = gray.to(torch.int32)
    rows = clamp_index(h, -3, h + 3, g.device)
    cols = clamp_index(w, -4, w + 4, g.device)
    gp = g[rows][:, cols]                               # (h+6, w+8)
    words = []
    for dys in ((-3, -2, -1), (1, 2, 3)):
        word = torch.zeros((h, w), dtype=torch.int32, device=g.device)
        for dy in dys:
            for dx in (-4, -3, -2, -1, 1, 2, 3, 4):
                nb = gp[3 + dy:3 + dy + h, 4 + dx:4 + dx + w]
                word = (word << 1) + (nb < g).to(torch.int32)
        words.append(word)
    return torch.stack(words, dim=-1)


_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int32)


def popcount24(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 values below 2^24."""
    lut = _POP8.to(x.device)
    x = x.to(torch.int64)
    return (lut[x & 255] + lut[(x >> 8) & 255] + lut[(x >> 16) & 255])


def hamming48(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between (..., 2)-int32 census codes -> (...)."""
    pc = popcount24(a ^ b)
    return pc[..., 0] + pc[..., 1]


# ---- the XLA engine's cost volumes: (D, H, W) float32 -----------------

def shifted(img: torch.Tensor, num_disp: int, zero_disp: int, sign: int):
    """(D, H, W, ...) stack of img's columns read at clamp(x + sign * (d -
    zero_disp), 0, W - 1), d in [0, D)."""
    w = img.shape[1]
    return torch.stack([img[:, clamp_index(w, sign * (d - zero_disp),
                                           w + sign * (d - zero_disp),
                                           img.device)]
                        for d in range(num_disp)])


def ci_ad(img_l: torch.Tensor, img_r: torch.Tensor, num_disp: int,
          zero_disp: int):
    """AD cost volumes (cost_l, cost_r), each (D, H, W) float32: the sum
    of the three channels' absolute differences, times the float32
    constant 0.33333333333."""
    from stereo_to_multiview_tpu_torch.ops.mux import f32
    li, ri = img_l.to(torch.int32), img_r.to(torch.int32)
    third = f32(0.33333333333)
    cost_l = ((li[None] - shifted(ri, num_disp, zero_disp, +1)).abs()
              .to(torch.float32).sum(-1) * third)
    cost_r = ((ri[None] - shifted(li, num_disp, zero_disp, -1)).abs()
              .to(torch.float32).sum(-1) * third)
    return cost_l, cost_r


def ci_census(census_l: torch.Tensor, census_r: torch.Tensor,
              num_disp: int, zero_disp: int):
    """Hamming cost volumes (D, H, W) float32 of (H, W, 2) census codes."""
    cost_l = hamming48(census_l[None], shifted(census_r, num_disp,
                                               zero_disp, +1))
    cost_r = hamming48(census_r[None], shifted(census_l, num_disp,
                                               zero_disp, -1))
    return cost_l.to(torch.float32), cost_r.to(torch.float32)


def ci_adcensus_combine(ad_cost, census_cost, ad_coeff: float,
                        census_coeff: float, fast_exp: bool = False):
    """C = (1 - e^{-C_ad / l_ad}) + (1 - e^{-C_census / l_census}), in
    float32 with the JAX package's op order and its CPU `exp`
    (`fastmath.exp_xla`), so every device gives the JAX package's CPU
    values; `fast_exp` takes the polynomial exp of `fastmath.exp_neg`."""
    from stereo_to_multiview_tpu_torch.ops.fastmath import exp_neg, exp_xla
    from stereo_to_multiview_tpu_torch.ops.mux import f32
    if fast_exp:
        return ((1.0 - exp_neg(ad_cost * f32(1.0 / ad_coeff)))
                + (1.0 - exp_neg(census_cost * f32(1.0 / census_coeff))))
    return ((1.0 - exp_xla(-ad_cost * f32(1.0 / ad_coeff)))
            + (1.0 - exp_xla(-census_cost * f32(1.0 / census_coeff))))


def ci_adcensus(img_l: torch.Tensor, img_r: torch.Tensor, ad_coeff: float,
                census_coeff: float, num_disp: int, zero_disp: int,
                fast_exp: bool = False, planes: range | None = None):
    """The XLA engine's cost init: (cost_l, cost_r), each (D, H, W)
    float32, equal to `ci_adcensus_combine(ci_ad, ci_census)` of the
    whole images' census codes.  Each plane looks its two terms up by the
    integer channel-difference sum (0..765) and Hamming count (0..48), so
    no (D, H, W, 3) stack is held.  `planes`: only those disparities, in
    that order (a disparity shard's slice; default all num_disp)."""
    from stereo_to_multiview_tpu_torch.ops.mux import f32, mux_average
    h, w = img_l.shape[:2]
    dev = img_l.device
    zero = torch.zeros(1, dtype=torch.float32)
    ad_terms = ci_adcensus_combine(
        torch.arange(766, dtype=torch.float32) * f32(0.33333333333), zero,
        ad_coeff, census_coeff, fast_exp).to(dev)
    ham_terms = ci_adcensus_combine(
        zero, torch.arange(49, dtype=torch.float32), ad_coeff, census_coeff,
        fast_exp).to(dev)
    # each table holds its term plus the other's at 0, which is exactly 0
    imgs = (img_l.to(torch.int32), img_r.to(torch.int32))
    cens = tuple(census_transform_9x7(mux_average(x)) for x in (img_l,
                                                                img_r))
    planes = range(num_disp) if planes is None else planes
    out = []
    for own, sign in ((0, +1), (1, -1)):
        oth = 1 - own
        vol = torch.empty((len(planes), h, w), dtype=torch.float32,
                          device=dev)
        for i, d in enumerate(planes):
            off = sign * (d - zero_disp)
            xs = clamp_index(w, off, w + off, dev)
            ad = (imgs[own] - imgs[oth][:, xs]).abs().sum(-1)
            vol[i] = ad_terms[ad] + ham_terms[hamming48(cens[own],
                                                        cens[oth][:, xs])]
        out.append(vol)
    return tuple(out)


def ci_adcensus_hwd(img_l: torch.Tensor, img_r: torch.Tensor,
                    ad_coeff: float, census_coeff: float, num_disp: int,
                    zero_disp: int, fast_exp: bool = False):
    """`ci_adcensus` in the (H, W, D) layout: the same values."""
    return tuple(v.permute(1, 2, 0).contiguous() for v in ci_adcensus(
        img_l, img_r, ad_coeff, census_coeff, num_disp, zero_disp,
        fast_exp))
