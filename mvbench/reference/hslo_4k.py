"""Plain PyTorch reference of one frame with the scanline optimisation,
the median filter and an interlaced output of another size than the
input: the route of `HD1080_D128_HSLO_4K` (1080p stereo to a 4K panel).

It imports nothing of the program under test.  The steps it shares with
the plain route (cost, arms, window sums, labels, voting, bilateral,
masks, warps, merge) are `plain.py`'s; what is its own:

  the H, V, V, H window sums stopped at pass 4 (no WTA) -> penalties in
  the aggregate's units (H1, H2 times qscale / 2^(s1 + s2 + s3), in three
  tiers by the count of small colour gradients: full, a quarter, a tenth)
  -> the scanline DP along each row, left to right and right to left,
  each direction's first column its own cost, averaged -> first-min WTA
  -> labels and voting -> 3x3 median, edges clamped -> bilateral ->
  masks, warps, merge -> slanted-lenticular interlace, each output
  subpixel sampling its view bilinearly at the output's coordinate
  (x lerps, then the y lerp, truncated to u8).

One DP step of a direction, prev the previous column's values (D of
them), C this column's costs and p1, p2 its penalties:

  mn = min_k prev(k)
  best = min(min(prev(d), mn + p2), min(prev(d + 1), prev(d - 1)) + p1)
  out(d) = (C(d) + best) - mn

with nothing beyond the ends of d.  Every step is a float32 add, subtract
or minimum, one operation per torch call, and the pass-4 sums are exact
integers below 2^24, so a frame computed on the CPU and one computed on
a GPU agree bit for bit.  The rows are independent in the DP: it runs
over all rows of a block and both eyes at once, a loop over the columns.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

F32 = torch.float32
BLOCK_ROWS = 540          # rows a block of the volumes holds
TIER_SCALES = (0.1, 0.25, 1.0)     # by the count of small gradients

# plain.py beside this file, loaded by its path as the harness loads a
# reference: a reference imports nothing by package name
_spec = importlib.util.spec_from_file_location(
    "mvbench_reference_plain_of_hslo_4k", Path(__file__).with_name("plain.py"))
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)


# ---- the stereo core: pass-4 sums, scanline DP, WTA -------------------------

def aggregate(cost, arms, cfg, shifts):
    """H, V, V, H window sums of one eye's (rows, W, D) cost: the pass-4
    volume, (rows, W, D) int32."""
    usd = cfg["usd"]
    s1, s2, s3 = shifts
    a = plain.window_sum(cost, arms[plain.LEFT], arms[plain.RIGHT], 1, usd,
                         s1)
    a = plain.window_sum(a, arms[plain.UP], arms[plain.DOWN], 0, usd, s2)
    a = plain.window_sum(a, arms[plain.UP], arms[plain.DOWN], 0, usd, s3)
    return plain.window_sum(a, arms[plain.LEFT], arms[plain.RIGHT], 1, usd)


def penalty_tables(cfg):
    """(p1, p2), each the (3,) float32 penalties of tiers 0, 1, 2 in the
    pass-4 volume's units: float32(H * qscale / 2^(s1 + s2 + s3)) times
    float32(tier scale), rounded once."""
    shifts = plain.rescale_shifts(cfg["usd"], cfg["band_digits"],
                                  cfg["band_qscale"])
    unit = cfg["band_qscale"] / float(2 ** sum(shifts))
    return tuple(torch.tensor([np.float32(h * unit) * np.float32(s)
                               for s in TIER_SCALES], dtype=F32)
                 for h in (cfg["hslo_H1"], cfg["hslo_H2"]))


def small_gradients(g: torch.Tensor, T: float) -> torch.Tensor:
    """(H, W) bool: |g(x) - g(x - 1)| < T in float32, column -1 read as
    column 0."""
    a = g.to(F32)
    return (a - torch.cat([a[:, :1], a[:, :-1]], dim=1)).abs() < T


def tiers(own, other, nd: int, zd: int, sign: int) -> torch.Tensor:
    """(rows, W, D) int64 count of small gradients: the eye's own at x
    and the other image's at clamp(x + sign * (d - zd), 0, W - 1)."""
    w = own.shape[1]
    x = torch.arange(w, device=own.device)[:, None]
    d = torch.arange(nd, device=own.device)[None, :]
    xo = (x + sign * (d - zd)).clamp(0, w - 1)
    return own.to(torch.int64)[:, :, None] + other.to(torch.int64)[:, xo]


def scan(cost, p1, p2, cols) -> torch.Tensor:
    """One direction of the DP over the columns `cols` of a (rows, W, D)
    float32 volume; the first column taken is its own cost."""
    out = torch.empty_like(cost)
    edge = cost.new_full((cost.shape[0], 1), float("inf"))
    prev = None
    for x in cols:
        if prev is None:
            prev = cost[:, x]
        else:
            mn = prev.amin(dim=1, keepdim=True)
            up = torch.cat([prev[:, 1:], edge], dim=1)
            down = torch.cat([edge, prev[:, :-1]], dim=1)
            best = torch.minimum(torch.minimum(prev, mn + p2[:, x]),
                                 torch.minimum(up, down) + p1[:, x])
            prev = (cost[:, x] + best) - mn
        out[:, x] = prev
    return out


def scanline_wta(vol, p1, p2, zd: int) -> torch.Tensor:
    """First-min argmin over d of the two directions' average, minus
    zero_disp: (rows, W) float32."""
    w = vol.shape[1]
    a = scan(vol, p1, p2, range(w)) + scan(vol, p1, p2, range(w - 1, -1, -1))
    return (torch.argmin(a * 0.5, dim=2) - zd).to(F32)


def stereo_core(img_l, img_r, arms_l, arms_r, cfg, block: int):
    """Scanline-optimised WTA disparities of both eyes, in row blocks: the
    window sums with a halo of 2 usd rows, the DP on the block's own
    rows."""
    h, w = img_l.shape[:2]
    nd, zd, usd = cfg["num_disp"], cfg["zero_disp"], cfg["usd"]
    dev = img_l.device
    table = plain.cost_table(cfg["ad_coeff"], cfg["census_coeff"],
                             cfg["band_qscale"]).to(dev)
    shifts = plain.rescale_shifts(usd, cfg["band_digits"], cfg["band_qscale"])
    p1_t, p2_t = (t.to(dev) for t in penalty_tables(cfg))
    grey_l, grey_r = plain.grey(img_l), plain.grey(img_r)
    cen_l, cen_r = plain.census(grey_l), plain.census(grey_r)
    small_l = small_gradients(grey_l, cfg["hslo_T"])
    small_r = small_gradients(grey_r, cfg["hslo_T"])
    disp_l = torch.empty((h, w), dtype=F32, device=dev)
    disp_r = torch.empty_like(disp_l)
    for a, b, k0, k1 in plain.row_blocks(h, block, 2 * usd):
        costs = plain.cost_volumes(img_l[a:b], img_r[a:b], cen_l[a:b],
                                   cen_r[a:b], table, nd, zd)
        vols = []
        for eye, arms in enumerate((arms_l, arms_r)):
            vols.append(aggregate(costs[eye], arms[:, a:b], cfg,
                                  shifts)[k0 - a:k1 - a].to(F32))
            costs[eye] = None
        tier = torch.cat([tiers(small_l[k0:k1], small_r[k0:k1], nd, zd, 1),
                          tiers(small_r[k0:k1], small_l[k0:k1], nd, zd, -1)])
        d = scanline_wta(torch.cat(vols), p1_t[tier], p2_t[tier], zd)
        del vols, tier
        disp_l[k0:k1], disp_r[k0:k1] = d[:k1 - k0], d[k1 - k0:]
    return disp_l, disp_r


# ---- the median, the views and the resampled interlace ----------------------

def median3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median of an (H, W) plane, edges clamped."""
    h, w = img.shape
    p = plain.edge_pad(img, 1)
    nine = torch.stack([p[dy:dy + h, dx:dx + w] for dy in range(3)
                        for dx in range(3)])
    return torch.median(nine, dim=0).values


def views(img_l, img_r, disp_l, disp_r, cfg) -> torch.Tensor:
    """(V, H, W, 3) u8: view 0 the right image, V - 1 the left one, the
    merged warps between them, as `plain.synthesize` makes them."""
    nv = cfg["num_views"]
    mask_l = plain.bleed_mask(plain.forward_hits(-disp_r.to(torch.int64)),
                              cfg["bleed_radius"])
    mask_r = plain.bleed_mask(plain.forward_hits(disp_l.to(torch.int64)),
                              cfg["bleed_radius"])
    wgt = plain.feather(mask_r, cfg["feather_radius"], cfg["feather_sigma"])
    out = [img_r]
    for i in range(1, nv - 1):
        s = float(np.float32(1.0) - np.float32(i) / np.float32(nv - 1.0))
        out.append(plain.merge(
            plain.warp(img_l, disp_r, float(np.float32(-s)), mask_r),
            plain.warp(img_r, disp_l, float(np.float32(1.0 - s)), mask_l),
            wgt))
    out.append(img_l)
    return torch.stack(out)


def taps(n_out: int, n_in: int, device):
    """(i0, i1, w) of one output axis: the sample coordinate s =
    clamp(i / n_out * n_in, 0, n_in - 1) in float32, its floor, the next
    index (clamped) and the float32 weight s - floor(s)."""
    i = np.arange(n_out, dtype=np.float32)
    s = np.clip(i / np.float32(n_out) * np.float32(n_in), np.float32(0.0),
                np.float32(n_in - 1))
    i0 = np.floor(s).astype(np.int64)
    w = (s - i0.astype(np.float32)).astype(np.float32)
    return (torch.from_numpy(i0).to(device),
            torch.from_numpy(np.minimum(i0 + 1, n_in - 1)).to(device),
            torch.from_numpy(w).to(device))


def interlace(vs: torch.Tensor, rows: int, cols: int,
              angle: float) -> torch.Tensor:
    """The (rows, cols, 3) u8 interlaced frame of the (V, H, W, 3) views:
    `plain.interlace` at the views' own size; otherwise each subpixel
    takes the view that `plain.interlace`'s pattern gives it at the
    output's size and samples it at (y, x) = the taps of its row and
    column: top = a00 (1 - wx) + a01 wx, bottom alike, top (1 - wy) +
    bottom wy, truncated."""
    v, h, w = vs.shape[:3]
    if (rows, cols) == (h, w):
        return plain.interlace(vs, angle)
    dev = vs.device
    ids = plain.interlace(torch.arange(v, device=dev).reshape(v, 1, 1, 1)
                          .expand(v, rows, cols, 3), angle)
    y0, y1, wy = taps(rows, h, dev)
    x0, x1, wx = taps(cols, w, dev)
    wy, wx = wy[:, None, None], wx[None, :, None]
    flat = vs.reshape(-1)
    chan = torch.arange(3, device=dev)

    def at(ys, xs):
        idx = ((ids * h + ys[:, None, None]) * w + xs[None, :, None]) * 3
        return flat[idx + chan].to(F32)

    top = at(y0, x0) * (1.0 - wx) + at(y0, x1) * wx
    bottom = at(y1, x0) * (1.0 - wx) + at(y1, x1) * wx
    return (top * (1.0 - wy) + bottom * wy).to(torch.uint8)


# ---- the frame -------------------------------------------------------------

def process_frame(sbs: torch.Tensor, cfg: dict, block: int = BLOCK_ROWS):
    """(H, 2W, 3) u8 SBS frame -> (disp_l, disp_r, interlaced): the final
    disparities (H, W) float32 and the (num_rows_out, num_cols_out, 3) u8
    frame, on the frame's device.  `cfg` holds the configuration's
    numbers by their field names; `block` is the rows a block of the
    volumes holds."""
    for key, want in (("use_hslo", True), ("band_lossy_wta", False),
                      ("num_rows_disp", 0)):
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference computes only {key}={want}")
    if cfg["bilateral_radius"] > 8:
        raise ValueError("the reference's bilateral takes radius <= 8")
    if round(2.0 * cfg["band_qscale"]) > 255:
        raise ValueError("the reference's costs are u8 (qscale <= 127.5)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = sbs.shape[1] // 2
    img_l, img_r = sbs[:, :w].contiguous(), sbs[:, w:].contiguous()
    arms_l, arms_r = plain.cross_arms(img_l, cfg), plain.cross_arms(img_r, cfg)
    disp_l, disp_r = stereo_core(img_l, img_r, arms_l, arms_r, cfg, block)
    lab_l, lab_r = plain.lr_labels(disp_l, disp_r, cfg["dcc_thresh"])
    disp_l = plain.region_vote(disp_l, lab_l, arms_l, cfg, block)
    disp_r = plain.region_vote(disp_r, lab_r, arms_r, cfg, block)
    del arms_l, arms_r
    if cfg["use_median"]:
        disp_l, disp_r = median3(disp_l), median3(disp_r)
    args = (cfg["bilateral_radius"], cfg["bilateral_sigma_color"],
            cfg["bilateral_sigma_spatial"])
    disp_l, disp_r = (plain.bilateral(disp_l, *args),
                      plain.bilateral(disp_r, *args))
    vs = views(img_l, img_r, disp_l, disp_r, cfg)
    return disp_l, disp_r, interlace(vs, cfg["num_rows_out"],
                                     cfg["num_cols_out"], cfg["angle"])
