"""Plain PyTorch reference of one stereo -> multiview frame: the band
engine's arithmetic written out with torch operations only.

It imports nothing of the program under test and takes nothing it made:
it builds its own cost table, arms, volumes and masks from the SBS frame
and the configuration's numbers.  Every step is the straightforward
definition:

  cross arms (colour and distance tests per step) -> AD-census cost,
  rint(127 * cost) as u8 from a table over the (AD, Hamming) integers ->
  four-pass cross aggregation (H, V, V, H) of exact int32 window sums with
  the power-of-2 rescales -> first-min WTA -> left-right check and
  disocclusion labels -> `irv_iterations` fixed voting rounds ->
  bilateral filter -> occlusion hits and bleed masks -> feathered blend
  weight -> backward warps and merge of every intermediate view ->
  slanted-lenticular interlace.

Aggregation and voting run in blocks of rows with the halo their windows
reach, so the volumes fit any frame size; their integer sums make the
blocking invisible in the result.  Float steps keep one operation per
torch call, so no multiply-add is contracted and a frame computed on the
CPU and one computed on a GPU differ only where the device's `exp` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3
AD_VALUES, HAM_VALUES = 766, 49
BLOCK_ROWS = 540      # rows a block of the volumes holds: fits 4K on a card


def f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=F32)


def clamp_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(lo, hi, device=device).clamp_(0, n - 1)


def row_blocks(h: int, block: int, halo: int):
    """[(start, stop, keep0, keep1)]: row ranges [start, stop) holding the
    output rows [keep0, keep1) and `halo` rows each side, inside [0, h)."""
    out = []
    for k0 in range(0, h, block):
        k1 = min(h, k0 + block)
        out.append((max(0, k0 - halo), min(h, k1 + halo), k0, k1))
    return out


# ---- grey, census, cost ---------------------------------------------------

def grey(img: torch.Tensor) -> torch.Tensor:
    """Mean of the three channels with float32 weights 0.3333333333333,
    truncated to u8."""
    c = f32(0.3333333333333)
    acc = img[:, :, 0].to(F32) * c
    acc = acc + img[:, :, 1].to(F32) * c
    acc = acc + img[:, :, 2].to(F32) * c
    return acc.to(torch.uint8)


def census(g: torch.Tensor) -> torch.Tensor:
    """9x7 census, (H, W, 2) int32: rows -3..-1 then 1..3, columns -4..4
    without 0, bit set where the neighbour is below the centre, edges
    clamped."""
    h, w = g.shape
    gi = g.to(torch.int32)
    gp = gi[clamp_index(h, -3, h + 3, g.device)][
        :, clamp_index(w, -4, w + 4, g.device)]
    words = []
    for dys in ((-3, -2, -1), (1, 2, 3)):
        word = torch.zeros((h, w), dtype=torch.int32, device=g.device)
        for dy in dys:
            for dx in (-4, -3, -2, -1, 1, 2, 3, 4):
                nb = gp[3 + dy:3 + dy + h, 4 + dx:4 + dx + w]
                word = (word << 1) + (nb < gi).to(torch.int32)
        words.append(word)
    return torch.stack(words, dim=-1)


_POP8 = [bin(i).count("1") for i in range(256)]


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lut = torch.tensor(_POP8, dtype=torch.int32, device=a.device)
    x = (a ^ b).to(torch.int64)
    pc = lut[x & 255] + lut[(x >> 8) & 255] + lut[(x >> 16) & 255]
    return pc[..., 0] + pc[..., 1]


def cost_table(ad_coeff: float, census_coeff: float,
               qscale: float) -> torch.Tensor:
    """(766 * 49,) u8 table, index AD * 49 + H: rint(qscale * ((1 -
    e^(-(AD * 0.33333333333) / l_ad)) + (1 - e^(-H / l_c)))) in float32,
    built on the CPU."""
    ad = torch.arange(AD_VALUES, dtype=F32)
    ham = torch.arange(HAM_VALUES, dtype=F32)
    a = 1.0 - torch.exp(-(ad * f32(0.33333333333)) * f32(1.0 / ad_coeff))
    c = 1.0 - torch.exp(-ham * f32(1.0 / census_coeff))
    q = torch.round((a[:, None] + c[None, :]) * f32(qscale))
    return q.to(torch.int32).to(torch.uint8).reshape(-1)


def cost_volumes(img_l, img_r, cen_l, cen_r, table, nd: int, zd: int):
    """(cost_l, cost_r), each (rows, W, D) u8, of image rows whose census
    codes are given: cost_l[x, d] = C(L(x), R(clamp(x + d - zd))) and
    cost_r[x, d] = C(L(clamp(x - (d - zd))), R(x))."""
    h, w = img_l.shape[:2]
    dev = img_l.device
    li, ri = img_l.to(torch.int32), img_r.to(torch.int32)
    xs = torch.arange(w, device=dev)
    out = []
    for own, oth, own_c, oth_c, sign in ((li, ri, cen_l, cen_r, 1),
                                         (ri, li, cen_r, cen_l, -1)):
        vol = torch.empty((h, w, nd), dtype=torch.uint8, device=dev)
        for d in range(nd):
            xo = (xs + sign * (d - zd)).clamp(0, w - 1)
            ad = (own - oth[:, xo]).abs().sum(dim=-1)
            vol[:, :, d] = table[ad * HAM_VALUES + hamming(own_c,
                                                           oth_c[:, xo])]
        out.append(vol)
    return out


# ---- cross arms ------------------------------------------------------------

def arm(img_i32, dy: int, dx: int, ucd, lcd, usd: int, lsd: int):
    """Arm length (H, W) int32 along (dy, dx): the count of steps k <= usd
    that stay in the image with no colour failure at a step before k.
    Within lsd a step fails when its max channel difference to the anchor
    or to the previous pixel exceeds lcd, beyond it when the difference to
    the anchor exceeds ucd."""
    h, w = img_i32.shape[:2]
    dev = img_i32.device
    axis, step, n = (0, dy, h) if dy else (1, dx, w)
    pos = torch.arange(n, device=dev)
    t_lcd, t_ucd = f32(lcd), f32(ucd)
    length = torch.zeros((h, w), dtype=torch.int32, device=dev)
    alive = torch.ones((h, w), dtype=torch.bool, device=dev)
    prev = img_i32
    for k in range(1, usd + 1):
        cur = img_i32.index_select(axis, clamp_index(n, step * k,
                                                     n + step * k, dev))
        ac = (cur - img_i32).abs().amax(dim=-1).to(F32)
        cp = (cur - prev).abs().amax(dim=-1).to(F32)
        fail = ((ac > t_lcd) | (cp > t_lcd)) if k <= lsd else (ac > t_ucd)
        inside = (pos + step * k >= 0) & (pos + step * k <= n - 1)
        inside = inside[:, None] if dy else inside[None, :]
        length += (inside & alive).to(torch.int32)
        alive &= ~fail
        prev = cur
    return length


def cross_arms(img, cfg) -> torch.Tensor:
    c = img.to(torch.int32)
    args = (cfg["ucd"], cfg["lcd"], cfg["usd"], cfg["lsd"])
    return torch.stack([arm(c, -1, 0, *args), arm(c, 1, 0, *args),
                        arm(c, 0, -1, *args), arm(c, 0, 1, *args)])


# ---- aggregation -------------------------------------------------------------

def rescale_shifts(usd: int, digits: int, qscale: float):
    """Shifts after passes 1-3 keeping each pass's input below (2^24 - 1) /
    (2 usd + 1) (digits 3), 2^15 (2) or 2^8 (1)."""
    wmax = 2 * usd + 1
    bound = (float((1 << 24) - 1) / wmax if digits >= 3 else
             32767.0 if digits == 2 else 255.0)
    v = int(round(2.0 * qscale))
    shifts = []
    for _ in range(3):
        raw = v * wmax
        s = max(0, math.ceil(math.log2(raw / bound)))
        shifts.append(s)
        v = math.floor(raw * 2.0 ** -s + 0.5)
    return shifts


def window_sum(vol, arm_neg, arm_pos, axis: int, usd: int, shift: int = 0):
    """sum vol[max(p - an, 0) : min(p + ap, n)] along axis 0 or 1 of an
    (H, W, D) volume, as exact int32, then floor(y / 2^shift + 1/2)."""
    n = vol.shape[axis]
    cs = torch.cumsum(vol, dim=axis, dtype=torch.int32)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    shape = [1, 1]
    shape[axis] = n
    pos = torch.arange(n, device=vol.device).reshape(shape)
    lo = (pos - arm_neg.clamp(0, usd)).clamp(min=0)[:, :, None]
    hi = (pos + arm_pos.clamp(0, usd)).clamp(max=n)[:, :, None]
    y = cs.gather(axis, hi.expand(vol.shape)) - cs.gather(
        axis, lo.expand(vol.shape))
    return (y + (1 << (shift - 1))) >> shift if shift else y


def aggregate_wta(cost, arms, cfg, shifts):
    """H, V, V, H window sums of one eye's (rows, W, D) cost, then the
    first minimum over d minus zero_disp, (rows, W) float32."""
    usd = cfg["usd"]
    s1, s2, s3 = shifts
    a = window_sum(cost, arms[LEFT], arms[RIGHT], 1, usd, s1)
    a = window_sum(a, arms[UP], arms[DOWN], 0, usd, s2)
    a = window_sum(a, arms[UP], arms[DOWN], 0, usd, s3)
    a = window_sum(a, arms[LEFT], arms[RIGHT], 1, usd)
    return (torch.argmin(a, dim=2) - cfg["zero_disp"]).to(F32)


def stereo_core(img_l, img_r, arms_l, arms_r, cfg, block: int):
    """WTA disparities of both eyes, in row blocks with a halo of 2 usd
    rows (the reach of the two vertical passes)."""
    h = img_l.shape[0]
    nd, zd, usd = cfg["num_disp"], cfg["zero_disp"], cfg["usd"]
    table = cost_table(cfg["ad_coeff"], cfg["census_coeff"],
                       cfg["band_qscale"]).to(img_l.device)
    shifts = rescale_shifts(usd, cfg["band_digits"], cfg["band_qscale"])
    cen_l, cen_r = census(grey(img_l)), census(grey(img_r))
    disp_l = torch.empty((h, img_l.shape[1]), dtype=F32, device=img_l.device)
    disp_r = torch.empty_like(disp_l)
    for a, b, k0, k1 in row_blocks(h, block, 2 * usd):
        costs = cost_volumes(img_l[a:b], img_r[a:b], cen_l[a:b], cen_r[a:b],
                             table, nd, zd)
        for eye, (arms, out) in enumerate(((arms_l, disp_l),
                                           (arms_r, disp_r))):
            d = aggregate_wta(costs[eye], arms[:, a:b], cfg, shifts)
            costs[eye] = None
            out[k0:k1] = d[k0 - a:k1 - a]
    return disp_l, disp_r


# ---- left-right check and voting ----------------------------------------------

def forward_hits(off: torch.Tensor) -> torch.Tensor:
    """hit[y, j]: some x with clamp(x + off[y, x], 0, W - 1) == j."""
    w = off.shape[1]
    tgt = (torch.arange(w, device=off.device) + off).clamp(0, w - 1)
    hit = torch.zeros(off.shape, dtype=torch.bool, device=off.device)
    return hit.scatter_(1, tgt, True)


def lr_labels(disp_l, disp_r, thresh: float):
    """Labels per eye, u8: 0 consistent, 1 |d - d_other(x + trunc(d))| >
    thresh, 2 that and no other-eye pixel maps onto it."""
    w = disp_l.shape[1]
    pos = torch.arange(w, device=disp_l.device)

    def mismatch(d_a, d_b, sign):
        idx = (pos + sign * d_a.to(torch.int64)).clamp(0, w - 1)
        return ((d_a - torch.gather(d_b, 1, idx)).abs()
                > f32(thresh)).to(torch.uint8)

    out_l, out_r = mismatch(disp_l, disp_r, 1), mismatch(disp_r, disp_l, -1)
    dis_r = ~forward_hits(disp_l.to(torch.int64))
    dis_l = ~forward_hits(-disp_r.to(torch.int64))
    return (torch.where((out_l == 1) & dis_l, 2, out_l),
            torch.where((out_r == 1) & dis_r, 2, out_r))


def inclusive_span(vol, arm_neg, arm_pos, axis: int):
    """sum vol[p - arm_neg .. p + arm_pos] along axis 0 or 1 of an
    (H, W, B) integer volume, ends clamped into the axis."""
    n = vol.shape[axis]
    cs = torch.cumsum(vol, dim=axis, dtype=torch.int32)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    shape = [1, 1]
    shape[axis] = n
    pos = torch.arange(n, device=vol.device).reshape(shape)
    hi = (pos + arm_pos + 1).clamp(0, n)[:, :, None].expand(vol.shape)
    lo = (pos - arm_neg).clamp(0, n)[:, :, None].expand(vol.shape)
    return cs.gather(axis, hi) - cs.gather(axis, lo)


def vote_round(disp, labels, arms, cfg):
    """One synchronous round over these rows: each outlier takes its cross
    region's most frequent reliable disparity (the first maximum) when
    more than thresh_s reliable pixels vote and (winner + zero_disp) /
    total > thresh_h (the vote divides the winning disparity, as the
    original does)."""
    nd, zd, usd = cfg["num_disp"], cfg["zero_disp"], cfg["usd"]
    reliable = labels == 0
    bins = torch.arange(nd, device=disp.device, dtype=torch.int32)
    dint = disp.to(torch.int32)
    onehot = reliable[:, :, None] & (dint[:, :, None] + zd == bins)
    vol = torch.cat([onehot, reliable[:, :, None]], dim=2).to(torch.int32)
    rows = inclusive_span(vol, arms[LEFT].clamp(0, usd),
                          arms[RIGHT].clamp(0, usd), 1)
    del vol, onehot
    span = inclusive_span(rows, arms[UP].clamp(0, usd),
                          arms[DOWN].clamp(0, usd), 0)
    del rows
    hist, total = span[:, :, :-1], span[:, :, -1]
    max_bin = hist.amax(dim=2)
    winner = torch.argmax(hist, dim=2).to(torch.int32)
    max_d = torch.where(max_bin > 0, winner - zd, dint)
    ratio = ((max_d + zd).to(F32) / total.clamp(min=1).to(F32))
    accept = ((labels != 0) & (total > cfg["irv_thresh_s"])
              & (ratio > f32(cfg["irv_thresh_h"])))
    return (torch.where(accept, max_d.to(F32), disp),
            torch.where(accept, 0, labels))


def region_vote(disp, labels, arms, cfg, block: int):
    """`irv_iterations` rounds, each over row blocks with a halo of usd
    rows (a vote reads the rows within usd of its own)."""
    h = disp.shape[0]
    for _ in range(cfg["irv_iterations"]):
        nd_, nl_ = torch.empty_like(disp), torch.empty_like(labels)
        for a, b, k0, k1 in row_blocks(h, block, cfg["usd"]):
            d, lab = vote_round(disp[a:b], labels[a:b], arms[:, a:b], cfg)
            nd_[k0:k1], nl_[k0:k1] = d[k0 - a:k1 - a], lab[k0 - a:k1 - a]
        disp, labels = nd_, nl_
    return disp


# ---- filters -----------------------------------------------------------------

def gaussian_2d(radius: int, sigma: float) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1].astype(np.float32)
    var = np.float32(sigma) ** 2
    num = np.exp(-(x * x + y * y) / (np.float32(2) * var))
    return (num / (np.float32(2 * np.pi) * var)).astype(np.float32)


def edge_pad(img: torch.Tensor, r: int) -> torch.Tensor:
    h, w = img.shape
    return img[clamp_index(h, -r, h + r, img.device)][
        :, clamp_index(w, -r, w + r, img.device)]


def bilateral(img, radius: int, sigma_color: float, sigma_spatial: float):
    """Weighted mean over the (2r + 1)^2 window, taps dx outer, dy inner:
    weight = spatial Gaussian tap * exp(-t^2 / 2 s_c^2) / sqrt(2 pi
    s_c^2), t = floor(|centre - sample|); edges clamped."""
    sk = gaussian_2d(radius, sigma_spatial)
    var = float(np.float32(sigma_color)) ** 2
    lut_scale = f32(1.0 / float(np.sqrt(2 * np.pi * var)))
    inv_2var = f32(1.0 / (2.0 * var))
    h, w = img.shape
    a = img.to(F32)
    p = edge_pad(a, radius)
    num = torch.zeros((h, w), dtype=F32, device=img.device)
    den = torch.zeros((h, w), dtype=F32, device=img.device)
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            s = p[dy + radius:dy + radius + h, dx + radius:dx + radius + w]
            t = torch.floor((a - s).abs())
            wgt = f32(sk[dy + radius, dx + radius]) * (
                torch.exp(-(t * t) * inv_2var) * lut_scale)
            num = num + wgt * s
            den = den + wgt
    return num / den


# ---- view synthesis ----------------------------------------------------------

def _bleed_index(n: int, off: int, device) -> torch.Tensor:
    """i + off, negative indices mirrored, indices past the end mapped to
    n - 1 - off (the original's edge rule)."""
    s = torch.arange(n, device=device) + off
    s = torch.where(s < 0, -s, s)
    return torch.where(s > n - 1, n - 1 - off, s)


def bleed_mask(hits: torch.Tensor, radius: int) -> torch.Tensor:
    """1.0 where more than 30% of the (2r + 1)^2 neighbourhood is hit or
    the pixel itself is, else 0.0."""
    h, w = hits.shape
    nz = hits.to(torch.int32)
    cnt = torch.zeros((h, w), dtype=torch.int32, device=hits.device)
    for dy in range(-radius, radius + 1):
        row = nz[_bleed_index(h, dy, hits.device)]
        for dx in range(-radius, radius + 1):
            cnt = cnt + row[:, _bleed_index(w, dx, hits.device)]
    ksz = (2 * radius + 1) ** 2
    out = torch.where(cnt.to(F32) > f32((ksz - 1) * 0.30), 1,
                      hits.to(torch.uint8))
    return (out == 1).to(F32)


def feather(mask_r: torch.Tensor, radius: int, sigma: float):
    """max(1 - m, blur(1 - m)): an x pass then a y pass of the 1-D
    Gaussian taps, normalised by the 2-D kernel's sum, edges clamped."""
    k1 = np.exp(-(np.arange(-radius, radius + 1, dtype=np.float64) ** 2)
                / (2.0 * float(sigma) ** 2)).astype(np.float32)
    k2d_sum = float(gaussian_2d(radius, sigma).astype(np.float64).sum())
    post = np.float32(1.0 / (2.0 * np.pi * float(sigma) ** 2) / k2d_sum)
    a = 1.0 - mask_r.to(F32)
    p = edge_pad(a, radius)
    h, w = a.shape
    acc_r = torch.zeros((h + 2 * radius, w), dtype=F32, device=a.device)
    for j, kv in enumerate(k1):
        acc_r = acc_r + f32(kv) * p[:, j:j + w]
    acc = torch.zeros((h, w), dtype=F32, device=a.device)
    for i, kv in enumerate(k1):
        acc = acc + f32(kv) * acc_r[i:i + h]
    return torch.maximum(a, acc * f32(post))


def warp(img, disp, shift: float, mask) -> torch.Tensor:
    """img sampled at clamp(x + disp * shift, 0, W - 1) with x-only linear
    weights, truncated to u8, times the mask, truncated again."""
    h, w, _ = img.shape
    xs = torch.arange(w, dtype=F32, device=img.device)
    c = (xs[None, :] + disp * f32(shift)).clamp(0.0, float(w - 1))
    x0 = torch.floor(c)
    w0 = (1.0 - (c - x0).abs()).clamp(min=0.0)[:, :, None]
    w1 = (1.0 - (c - (x0 + 1.0)).abs()).clamp(min=0.0)[:, :, None]
    i0 = x0.to(torch.int64)
    i1 = (i0 + 1).clamp(max=w - 1)
    src = img.to(F32)
    v0 = torch.gather(src, 1, i0[:, :, None].expand(h, w, 3))
    v1 = torch.gather(src, 1, i1[:, :, None].expand(h, w, 3))
    u8 = (w0 * v0 + w1 * v1).to(torch.uint8)
    return (u8.to(F32) * mask[:, :, None]).to(torch.uint8)


def merge(img_b, img_a, m) -> torch.Tensor:
    """(u8)((1 - m) B) + (u8)(m A) per channel."""
    m = m[:, :, None]
    term_a = (m * img_a.to(F32)).to(torch.uint8)
    term_b = ((1.0 - m) * img_b.to(F32)).to(torch.uint8)
    return term_b + term_a


def interlace(views: torch.Tensor, angle: float) -> torch.Tensor:
    """Each BGR subpixel of the (H, W) output from view (3 tx +
    trunc((ty % round(y_int) + 1) * V / y_int) + {2, 1, 0}) mod V, y_int
    = V / tan(angle) / 3 in float32."""
    v, h, w = views.shape[:3]
    y_int = np.float32(v / math.tan(angle * math.pi / 180.0) / 3.0)
    inv_y = np.float32(1.0) / y_int
    y_mod = max(int(math.floor(float(y_int) + 0.5)), 1)
    ty = torch.arange(h, device=views.device)
    yv = (((ty % y_mod).to(F32) + 1.0) * f32(v) * f32(inv_y)).to(torch.int64)
    xv = (torch.arange(w, device=views.device)[None, :] * 3
          + yv[:, None]) % v
    vid = torch.stack([(xv + 2) % v, (xv + 1) % v, xv], dim=-1)
    return torch.gather(views, 0, vid[None])[0]


def synthesize(img_l, img_r, disp_l, disp_r, cfg) -> torch.Tensor:
    """Views 0 (the right image) .. V - 1 (the left one); view i between
    them warps L with disp_r at -s and R with disp_l at 1 - s, s = 1 -
    i / (V - 1), merged with the feathered weight; then the interlace."""
    nv = cfg["num_views"]
    if (cfg["num_rows_out"], cfg["num_cols_out"]) != tuple(img_l.shape[:2]):
        raise ValueError("the reference interlaces at the input resolution")
    hits_r = forward_hits(disp_l.to(torch.int64))
    hits_l = forward_hits(-disp_r.to(torch.int64))
    mask_l = bleed_mask(hits_l, cfg["bleed_radius"])
    mask_r = bleed_mask(hits_r, cfg["bleed_radius"])
    wgt = feather(mask_r, cfg["feather_radius"], cfg["feather_sigma"])
    views = [img_r]
    for i in range(1, nv - 1):
        # the fraction rounded to float32, then each warp's shift taken in
        # float64 and rounded once
        s = float(np.float32(1.0) - np.float32(i) / np.float32(nv - 1.0))
        views.append(merge(warp(img_l, disp_r, float(np.float32(-s)), mask_r),
                           warp(img_r, disp_l, float(np.float32(1.0 - s)),
                                mask_l), wgt))
    views.append(img_l)
    return interlace(torch.stack(views), cfg["angle"])


# ---- the frame -------------------------------------------------------------

def process_frame(sbs: torch.Tensor, cfg: dict, block: int = BLOCK_ROWS):
    """(H, 2W, 3) u8 SBS frame -> (disp_l, disp_r, interlaced): the final
    disparities (H, W) float32 and the (H_out, W_out, 3) u8 frame, on the
    frame's device.  `cfg` holds the configuration's numbers by their
    field names; `block` is the rows a block of the volumes holds."""
    for key, want in (("band_lossy_wta", False), ("use_hslo", False),
                      ("use_median", False), ("num_rows_disp", 0)):
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference does not compute {key}")
    if cfg["bilateral_radius"] > 8:
        raise ValueError("the reference's bilateral takes radius <= 8")
    if round(2.0 * cfg["band_qscale"]) > 255:
        raise ValueError("the reference's costs are u8 (qscale <= 127.5)")
    w = sbs.shape[1] // 2
    img_l, img_r = sbs[:, :w].contiguous(), sbs[:, w:].contiguous()
    arms_l, arms_r = cross_arms(img_l, cfg), cross_arms(img_r, cfg)
    disp_l, disp_r = stereo_core(img_l, img_r, arms_l, arms_r, cfg, block)
    lab_l, lab_r = lr_labels(disp_l, disp_r, cfg["dcc_thresh"])
    disp_l = region_vote(disp_l, lab_l, arms_l, cfg, block)
    disp_r = region_vote(disp_r, lab_r, arms_r, cfg, block)
    del arms_l, arms_r
    args = (cfg["bilateral_radius"], cfg["bilateral_sigma_color"],
            cfg["bilateral_sigma_spatial"])
    disp_l, disp_r = bilateral(disp_l, *args), bilateral(disp_r, *args)
    return disp_l, disp_r, synthesize(img_l, img_r, disp_l, disp_r, cfg)
