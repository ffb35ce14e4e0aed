"""Intermediate-tensor dump: the file-based replacement for the
reference's 8 interactive display modes (image_io.cpp:38-48, :321-470).

Every stage output can be written as PNG (display-normalized like the
reference's cv::normalize CV_MINMAX prep) and/or NPY (exact values).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from stereo_to_multiview_tpu_torch.utils.imageio import (
    normalize_for_display, write_png)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DumpWriter:
    """Writes named intermediates to <out_dir>/<name>.png/.npy."""

    def __init__(self, out_dir: str, png: bool = True, npy: bool = False):
        self.out_dir = out_dir
        self.png = png
        self.npy = npy
        os.makedirs(out_dir, exist_ok=True)

    def _path(self, name: str, ext: str) -> str:
        return os.path.join(self.out_dir, f"{name}.{ext}")

    def image(self, name: str, img) -> None:
        """uint8 image (BGR or gray), written as-is."""
        img = _host(img)
        if self.png:
            write_png(self._path(name, "png"), img)
        if self.npy:
            np.save(self._path(name, "npy"), img)

    def map(self, name: str, arr) -> None:
        """Float map (disparity, mask, cost slice): min-max normalized PNG
        plus exact NPY."""
        arr = _host(arr)
        if self.png:
            write_png(self._path(name, "png"), normalize_for_display(arr))
        if self.npy:
            np.save(self._path(name, "npy"), arr)

    def volume_slices(self, name: str, vol, every: int = 8) -> None:
        """(D, H, W) cost volume: one normalized slice per `every` planes
        (the reference's per-disparity-level browsing modes)."""
        vol = _host(vol)
        for d in range(0, vol.shape[0], every):
            self.map(f"{name}_d{d:03d}", vol[d])
        if self.npy:
            np.save(self._path(name, "npy"), vol)


def dump_pipeline_intermediates(writer: DumpWriter, img_l, img_r, cfg,
                                cost_slices: bool = False,
                                device=None) -> Dict[str, np.ndarray]:
    """Run the pipeline stage by stage on `device` (the CUDA device unless
    the caller asks for another), dumping every display mode the
    reference viewer offers; returns the final arrays on the host.

    The stages are the XLA engine's functions, evaluated one by one as the
    JAX package's dump evaluates them: the (D, H, W) cost, the float32
    aggregation and WTA, the labels (B7), `irv_iterations` fixed IRV
    rounds (B8/B9), the XLA-order bilateral, the occlusion hits (B7) and
    bleed masks (B11); the views by `synthesize_views`, which follows
    `cfg.engine`, and `mux_multiview`."""
    from stereo_to_multiview_tpu_torch.models.pipeline import (
        resolve_device, synthesize_views)
    from stereo_to_multiview_tpu_torch.ops.cost import ci_adcensus
    from stereo_to_multiview_tpu_torch.ops.cross import (
        cross_aggregate, cross_arms)
    from stereo_to_multiview_tpu_torch.ops.dcc import dr_dcc
    from stereo_to_multiview_tpu_torch.ops.dibr import (
        dibr_bleed_mask, dibr_occl)
    from stereo_to_multiview_tpu_torch.ops.filters import (
        filter_bilateral_wide)
    from stereo_to_multiview_tpu_torch.ops.irv import dr_irv
    from stereo_to_multiview_tpu_torch.ops.mux import mux_multiview
    from stereo_to_multiview_tpu_torch.ops.wta import dc_wta

    dev = resolve_device(device)
    writer.image("00_left", img_l)
    writer.image("01_right", img_r)
    l, r = (torch.as_tensor(np.ascontiguousarray(_host(x))).to(dev)
            for x in (img_l, img_r))

    cost_l, cost_r = ci_adcensus(l, r, cfg.ad_coeff, cfg.census_coeff,
                                 cfg.num_disp, cfg.zero_disp)
    if cost_slices:
        writer.volume_slices("02_cost_l", cost_l)

    arm_args = (cfg.ucd, cfg.lcd, cfg.usd, cfg.lsd)
    arms_l, arms_r = cross_arms(l, *arm_args), cross_arms(r, *arm_args)
    acost_l = cross_aggregate(cost_l, arms_l, max_arm=cfg.usd)
    acost_r = cross_aggregate(cost_r, arms_r, max_arm=cfg.usd)
    del cost_l, cost_r
    if cost_slices:
        writer.volume_slices("03_acost_l", acost_l)

    disp_l = dc_wta(acost_l, cfg.zero_disp)
    disp_r = dc_wta(acost_r, cfg.zero_disp)
    del acost_l, acost_r
    writer.map("04_disp_raw_l", disp_l)
    writer.map("04_disp_raw_r", disp_r)

    out_l, out_r = dr_dcc(disp_l, disp_r, cfg.dcc_thresh)
    writer.map("05_outliers_l", out_l.to(torch.float32))
    writer.map("05_outliers_r", out_r.to(torch.float32))

    irv = (cfg.irv_thresh_s, cfg.irv_thresh_h, cfg.num_disp, cfg.zero_disp,
           cfg.usd, cfg.irv_iterations)
    disp_l, out_l = dr_irv(disp_l, out_l, arms_l, *irv)
    disp_r, out_r = dr_irv(disp_r, out_r, arms_r, *irv)

    blf = lambda d: filter_bilateral_wide(
        d, cfg.bilateral_radius, cfg.bilateral_sigma_color,
        cfg.bilateral_sigma_spatial, contract=False)
    disp_l, disp_r = blf(disp_l), blf(disp_r)
    writer.map("06_disp_l", disp_l)
    writer.map("06_disp_r", disp_r)

    occl_l, occl_r = dibr_occl(disp_l, disp_r)
    mask_l = dibr_bleed_mask(occl_l, cfg.bleed_radius)
    mask_r = dibr_bleed_mask(occl_r, cfg.bleed_radius)
    writer.map("07_mask_l", mask_l)
    writer.map("07_mask_r", mask_r)

    views = synthesize_views(l.contiguous(), r.contiguous(), disp_l, disp_r,
                             cfg)
    for v in range(cfg.num_views):
        writer.image(f"08_view_{v}", views[v])

    interlaced = mux_multiview(views, cfg.num_rows_out, cfg.num_cols_out,
                               cfg.angle)
    writer.image("09_interlaced", interlaced)

    return {
        "disp_l": _host(disp_l), "disp_r": _host(disp_r),
        "outliers_l": _host(out_l), "outliers_r": _host(out_r),
        "views": _host(views), "interlaced": _host(interlaced),
    }
