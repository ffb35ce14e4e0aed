"""Channel muxing and the lenticular multiview interlace.

Float constants are float32 tensors, so every product rounds exactly as
the JAX package's float32 arithmetic does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stereo_to_multiview_tpu_torch.ops.scale import lerp_axis

F32 = torch.float32


def f32(x) -> torch.Tensor:
    """0-dim float32 constant (usable with tensors on any device)."""
    return torch.tensor(np.float32(x), dtype=F32)


def mux_average(img: torch.Tensor) -> torch.Tensor:
    """BGR -> grayscale with uniform 0.3333333333333 weights (f32) and a
    truncating uint8 store."""
    c = f32(0.3333333333333)
    acc = img[:, :, 0].to(F32) * c
    acc = acc + img[:, :, 1].to(F32) * c
    acc = acc + img[:, :, 2].to(F32) * c
    return acc.to(torch.uint8)          # f32 -> u8 truncates toward zero


def mux_merge_ab(img_b: torch.Tensor, img_a: torch.Tensor,
                 mask_a: torch.Tensor) -> torch.Tensor:
    """Masked blend with double truncation:
    out = (u8)((1-m)*B) + (u8)(m*A) per channel."""
    m = mask_a.to(F32)[:, :, None]
    term_a = (m * img_a.to(F32)).to(torch.uint8)
    term_b = ((1.0 - m) * img_b.to(F32)).to(torch.uint8)
    return term_b + term_a


def mux_geometry(v_cnt: int, angle: float):
    """(y_mod, inv_y) of the interlace: y_interval = V / tan(angle) / 3
    in float32, y_mod = round(y_interval) (C round, at least 1), inv_y =
    1 / y_interval in float32."""
    y_interval = np.float32(v_cnt / math.tan(angle * math.pi / 180.0) / 3.0)
    inv_y = np.float32(1.0) / y_interval
    y_mod = max(int(math.floor(float(y_interval) + 0.5)), 1)  # C round()
    return y_mod, inv_y


def mux_row_views(v_cnt: int, rows: int, angle: float,
                  device=None, row0: int = 0) -> torch.Tensor:
    """(rows,) int64 per-row view term trunc((ty % y_mod + 1) * V *
    inv_y), every operation in float32, left to right: what the
    interlace kernel (`ops.dibr.warp_merge_interlace`) computes for each
    output row; ty = row0 + the row's index (a row shard's global
    rows)."""
    y_mod, inv_y = mux_geometry(v_cnt, angle)
    ty = torch.arange(rows, device=device) + int(row0)
    y_view = ((ty % y_mod).to(F32) + 1.0) * f32(v_cnt) * f32(inv_y)
    return y_view.to(torch.int64)


def mux_view_pattern(v_cnt: int, rows: int, cols: int, angle: float,
                     device=None, row0: int = 0) -> torch.Tensor:
    """(rows, cols, 3) int64 view id per BGR color subpixel: R at +0,
    G at +1, B at +2 (channel 0 is B, so it gets +2).  Geometry:
    y_interval = V / tan(angle) / 3 in float32; each subpixel selects
    view (3*tx + trunc((ty % round(y_interval) + 1) * V / y_interval))
    mod V (`mux_row_views`, ty from the global row `row0`)."""
    yv = mux_row_views(v_cnt, rows, angle, device, row0)
    tx = torch.arange(cols, device=device)
    x_view = (tx[None, :] * 3 + yv[:, None]) % v_cnt
    return torch.stack([(x_view + 2) % v_cnt, (x_view + 1) % v_cnt, x_view],
                       dim=-1)


def resample_views_f32(views_f32: torch.Tensor, num_rows_out: int,
                       num_cols_out: int,
                       contract: bool = False) -> torch.Tensor:
    """(V, H, W, 3) float32 -> (V, H_out, W_out, 3) float32 bilinear
    resample of every view: the x-lerps, then the y-lerp (`contract` as
    in `lerp_axis`)."""
    return lerp_axis(lerp_axis(views_f32, 2, num_cols_out, contract), 1,
                     num_rows_out, contract)


def mux_multiview(views: torch.Tensor, num_rows_out: int, num_cols_out: int,
                  angle: float, contract: bool = False) -> torch.Tensor:
    """Slanted-lenticular interlace of (V, H, W, 3) uint8 views into
    (H_out, W_out, 3).  View 0 = right source, view V-1 = left source.
    At identity resolution each output subpixel is the selected view's
    own subpixel; otherwise every view is first resampled bilinearly to
    the output resolution with a truncating u8 store (`contract`: each
    lerp in the JAX package's jitted order, `lerp_axis`)."""
    v_cnt, h_in, w_in = views.shape[:3]
    if (h_in, w_in) != (num_rows_out, num_cols_out):
        views = resample_views_f32(views.to(F32), num_rows_out,
                                   num_cols_out, contract).to(torch.uint8)
    vid = mux_view_pattern(v_cnt, num_rows_out, num_cols_out, angle,
                           views.device)
    return torch.gather(views, 0, vid[None])[0]


def mux_multiview_rows(views: torch.Tensor, angle: float,
                       row_offset: int) -> torch.Tensor:
    """`mux_multiview` of a row shard at identity resolution (the
    interlace is then row-local): (V, h, W, 3) u8 views of the frame's
    rows row_offset .. row_offset + h - 1 -> their (h, W, 3) interlace,
    the lenticular row phase taken from the global row."""
    v_cnt, h, w = views.shape[:3]
    vid = mux_view_pattern(v_cnt, h, w, angle, views.device, row_offset)
    return torch.gather(views, 0, vid[None])[0]
