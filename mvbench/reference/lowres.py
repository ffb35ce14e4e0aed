"""Plain PyTorch reference of one frame of the low-resolution disparity
route: the upstream's `adcensus_stm_2` (d_io.cu:240-508), the route of
`HD1080_LOWRES` (1080p stereo, disparity at 540x960, synthesis at 1080p).

It imports nothing of the program under test.  The steps between the
rescales are `plain.py`'s, run at the disparity size; what is its own:

  demux -> each eye scaled down bilinearly to (num_rows_disp,
  num_cols_disp), truncated to u8 -> plain's cross arms, stereo core,
  labels, voting rounds and bilateral at that size -> both disparities
  scaled up bilinearly to (num_rows, num_cols) and multiplied by
  float32(1 / disp_scale) -> plain's synthesis at full resolution.

A bilinear rescale (d_tx_scale.cu:8-52): on each axis, output i samples
s = clamp(i / n_out * n_in, 0, n_in - 1) in float32, between floor(s)
and the next index (clamped to n_in - 1) with the weight w = s -
floor(s); along x first, then along y, each lerp a0 (1 - w) + a1 w with
its products and sum rounded to float32 one by one.  An image that
already has the output's size is not resampled.  So a frame computed on
the CPU and one computed on a GPU agree bit for bit.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

F32 = torch.float32
BLOCK_ROWS = 540          # rows a block of the volumes holds

# plain.py beside this file, loaded by its path as the harness loads a
# reference: a reference imports nothing by package name
_spec = importlib.util.spec_from_file_location(
    "mvbench_reference_plain_of_lowres", Path(__file__).with_name("plain.py"))
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)


def taps(n_out: int, n_in: int, device):
    """(i0, i1, w) of one axis: each output's sample coordinate s in
    float32, its floor, the next index (clamped) and the float32 weight
    s - floor(s)."""
    i = np.arange(n_out, dtype=np.float32)
    s = np.clip(i / np.float32(n_out) * np.float32(n_in), np.float32(0.0),
                np.float32(n_in - 1))
    i0 = np.floor(s)
    w = (s - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    return (torch.from_numpy(i0).to(device),
            torch.from_numpy(np.minimum(i0 + 1, n_in - 1)).to(device),
            torch.from_numpy(w).to(device))


def rescale(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Bilinear rescale of a float32 (H, W) or (H, W, C) plane to (rows,
    cols): the x lerps, then the y lerps."""
    h, w = a.shape[:2]
    if (h, w) == (rows, cols):
        return a
    y0, y1, wy = taps(rows, h, a.device)
    x0, x1, wx = taps(cols, w, a.device)
    tail = (1,) * (a.dim() - 2)
    wx = wx.reshape(1, cols, *tail)
    wy = wy.reshape(rows, 1, *tail)
    xs = a[:, x0] * (1.0 - wx) + a[:, x1] * wx
    return xs[y0] * (1.0 - wy) + xs[y1] * wy


def scale_down(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """An (H, W, 3) u8 image at (rows, cols), truncated to u8."""
    return rescale(img.to(F32), rows, cols).to(torch.uint8)


def scale_up(disp: torch.Tensor, rows: int, cols: int,
             disp_scale: float) -> torch.Tensor:
    """An (h, w) float32 disparity at (rows, cols), times float32(1 /
    disp_scale)."""
    return rescale(disp, rows, cols) * plain.f32(1.0 / disp_scale)


def process_frame(sbs: torch.Tensor, cfg: dict, block: int = BLOCK_ROWS):
    """(H, 2W, 3) u8 SBS frame -> (disp_l, disp_r, interlaced): the final
    disparities at full resolution (H, W) float32 and the (H, W, 3) u8
    frame, on the frame's device.  `cfg` holds the configuration's
    numbers by their field names; `block` is the rows a block of the
    low-resolution volumes holds."""
    for key, want in (("use_hslo", False), ("use_median", False),
                      ("band_lossy_wta", False)):
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference computes only {key}={want}")
    rows, cols = cfg.get("num_rows_disp", 0), cfg.get("num_cols_disp", 0)
    if rows <= 0 or cols <= 0:
        raise ValueError("the reference computes only the low-resolution "
                         "route (num_rows_disp, num_cols_disp > 0)")
    if cfg["bilateral_radius"] > 8:
        raise ValueError("the reference's bilateral takes radius <= 8")
    if round(2.0 * cfg["band_qscale"]) > 255:
        raise ValueError("the reference's costs are u8 (qscale <= 127.5)")
    h, w = sbs.shape[0], sbs.shape[1] // 2
    if (cfg["num_rows_out"], cfg["num_cols_out"]) != (h, w):
        raise ValueError("the reference interlaces at the input resolution")
    img_l, img_r = sbs[:, :w].contiguous(), sbs[:, w:].contiguous()
    lo_l, lo_r = scale_down(img_l, rows, cols), scale_down(img_r, rows, cols)
    arms_l, arms_r = plain.cross_arms(lo_l, cfg), plain.cross_arms(lo_r, cfg)
    disp_l, disp_r = plain.stereo_core(lo_l, lo_r, arms_l, arms_r, cfg, block)
    lab_l, lab_r = plain.lr_labels(disp_l, disp_r, cfg["dcc_thresh"])
    disp_l = plain.region_vote(disp_l, lab_l, arms_l, cfg, block)
    disp_r = plain.region_vote(disp_r, lab_r, arms_r, cfg, block)
    del arms_l, arms_r, lo_l, lo_r
    args = (cfg["bilateral_radius"], cfg["bilateral_sigma_color"],
            cfg["bilateral_sigma_spatial"])
    disp_l, disp_r = (plain.bilateral(disp_l, *args),
                      plain.bilateral(disp_r, *args))
    disp_l = scale_up(disp_l, h, w, cfg["disp_scale"])
    disp_r = scale_up(disp_r, h, w, cfg["disp_scale"])
    return disp_l, disp_r, plain.synthesize(img_l, img_r, disp_l, disp_r,
                                            cfg)
