"""Whole-frame pipeline: SBS uint8 frame in -> (disp_l, disp_r,
interlaced) out.

Stage order, with the hand-written CUDA kernel of each stage:
  demux_sbs -> cross arms of both eyes (B1, one launch) -> stereo core
  (cost init with the census B2, shear B3, H,V,V,H aggregation B4/B5,
  WTA B6; with use_hslo the pass-4 volumes and the scanline
  optimisation + WTA of both eyes in one launch, B13) -> dcc (B7) -> irv (B8/B9 per round,
  stopping at the fixpoint; over row chunks with cfg.irv_row_chunk)
  -> [median] -> bilateral (B10)
  -> occlusion hits (B7) and bleed masks (B11) of both eyes in one
     launch, the hits kept in shared memory -> feather (G1)
  -> backward warps, merge and interlace in one kernel (B12's interlace
     mode, `synthesize_interlace`): each output subpixel computed from
     the one view it selects, sampled bilinearly where the output
     resolution differs; no view stack is written

`process_frame_lowres` computes the disparities on a downscaled pair and
scales them back up before the synthesis.

The stereo core has band-engine semantics (quantized cost, exact integer
aggregation, first-min WTA); the kernels' plain versions follow the JAX
package's XLA-engine functions, which its tests hold equal to its
band-engine kernels.

Entry points run on the CUDA device unless the caller passes
`device="cpu"` (the tests do); without a GPU and without that request
they raise.  Knobs the port does not have yet raise NotImplementedError
naming their ROADMAP item.
"""

from __future__ import annotations

import math

import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.ops.band import band_stereo_core_chunked
from stereo_to_multiview_tpu_torch.ops.costkern import cost_dtype
from stereo_to_multiview_tpu_torch.ops.cross import cross_arms_lr
from stereo_to_multiview_tpu_torch.ops.dcc import dr_dcc
from stereo_to_multiview_tpu_torch.ops.demux import demux_sbs
from stereo_to_multiview_tpu_torch.ops.dibr import (
    dibr_feather_mask, dibr_occl_masks, synth_shifts, warp_merge_interlace,
    warp_merge_views)
from stereo_to_multiview_tpu_torch.ops.filters import (
    filter_bilateral, filter_median)
from stereo_to_multiview_tpu_torch.ops.irv import dr_irv_early_stop
from stereo_to_multiview_tpu_torch.ops.scale import (
    tx_disp_scale, tx_scale_bilinear)
from stereo_to_multiview_tpu_torch.utils.profiling import (
    StageTimer, stage_scope)


def resolve_device(device=None) -> torch.device:
    """The CUDA device unless the caller asks for another; raise when no
    GPU is present and no device was asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def check_ported(cfg: PipelineConfig):
    """Raise NotImplementedError for a knob that is not ported yet (the
    XLA engine), ValueError for a value out of range."""
    if cfg.engine == "xla":
        raise NotImplementedError(
            "engine='xla' is not ported yet (ROADMAP A.4)")
    if cfg.engine not in ("auto", "band"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    if cfg.band_digits not in (1, 2, 3):
        raise ValueError("band_digits must be 1, 2 or 3")
    cost_dtype(cfg.band_qscale)


def raw_disparities(img_l, img_r, cfg: PipelineConfig,
                    timer: StageTimer | None = None):
    """Stereo matching up to IRV: images -> (disp_l, disp_r) float32
    before the median and bilateral filters, plus the outlier labels
    (u8)."""
    with stage_scope("ca_cross_arms", timer):
        arms_l, arms_r = cross_arms_lr(img_l, img_r, cfg.ucd, cfg.lcd,
                                       cfg.usd, cfg.lsd)
    with stage_scope("stereo_core", timer):
        disp_l, disp_r = band_stereo_core_chunked(img_l, img_r, arms_l,
                                                  arms_r, cfg)
    with stage_scope("dr_dcc", timer):
        out_l, out_r = dr_dcc(disp_l, disp_r, cfg.dcc_thresh)
    with stage_scope("dr_irv", timer):
        irv = lambda d, o, a: dr_irv_early_stop(
            d, o, a, cfg.irv_thresh_s, cfg.irv_thresh_h, cfg.num_disp,
            cfg.zero_disp, cfg.usd, cfg.irv_iterations,
            row_chunk=cfg.irv_row_chunk)
        disp_l, out_l = irv(disp_l, out_l, arms_l)
        disp_r, out_r = irv(disp_r, out_r, arms_r)
    return disp_l, disp_r, out_l, out_r


def compute_disparities(img_l, img_r, cfg: PipelineConfig,
                        timer: StageTimer | None = None):
    """Stereo matching half of the pipeline: images -> refined (disp_l,
    disp_r) float32 plus the outlier labels."""
    disp_l, disp_r, out_l, out_r = raw_disparities(img_l, img_r, cfg, timer)
    if cfg.use_median:
        with stage_scope("filter_median", timer):
            disp_l, disp_r = filter_median(disp_l), filter_median(disp_r)
    with stage_scope("filter_bilateral", timer):
        blf = lambda d: filter_bilateral(d, cfg.bilateral_radius,
                                         cfg.bilateral_sigma_color,
                                         cfg.bilateral_sigma_spatial)
        disp_l, disp_r = blf(disp_l), blf(disp_r)
    return disp_l, disp_r, out_l, out_r


def synth_disp_bounds(cfg: PipelineConfig):
    """(num_disp, zero_disp) bounds covering the disparity values the
    synthesis stages see: the config's own at full resolution; scaled by
    1/disp_scale on the lowres path."""
    if not cfg.lowres or cfg.disp_scale == 1.0:
        return cfg.num_disp, cfg.zero_disp
    inv = 1.0 / cfg.disp_scale
    zd = int(math.ceil(cfg.zero_disp * inv))
    top = int(math.floor((cfg.num_disp - 1 - cfg.zero_disp) * inv))
    return zd + top + 1, zd


# the JAX package's private name for the views' fractions
_synth_shifts = synth_shifts


def synthesis_masks(disp_l, disp_r, cfg: PipelineConfig,
                    timer: StageTimer | None = None):
    """The synthesis' masks from the disparities: (mask_l, mask_r) float32
    {0, 1} (occlusion hits B7 and bleed B11 in one launch) and the
    feathered blend weight (G1)."""
    with stage_scope("dibr_occl", timer):
        mask_l, mask_r = dibr_occl_masks(disp_l, disp_r, cfg.bleed_radius)
    with stage_scope("dibr_feather", timer):
        feathered = dibr_feather_mask(mask_r, cfg.feather_radius,
                                      cfg.feather_sigma)
    return mask_l, mask_r, feathered


def synthesize_views(img_l, img_r, disp_l, disp_r, cfg: PipelineConfig,
                     timer: StageTimer | None = None) -> torch.Tensor:
    """DIBR half: images + disparities -> (V, H, W, 3) u8 view stack.
    View 0 = right source, view V-1 = left source; intermediate view v
    warps L with disp_r at -shift and R with disp_l at 1 - shift,
    shift = 1 - v/(V-1), and merges them with the feathered mask (B12)."""
    masks = synthesis_masks(disp_l, disp_r, cfg, timer)
    with stage_scope("dibr_dbm", timer):
        mids = warp_merge_views(img_l, img_r, disp_l, disp_r, *masks,
                                synth_shifts(cfg.num_views))
    return torch.cat([img_r[None], mids, img_l[None]])


def synthesize_interlace(img_l, img_r, disp_l, disp_r, cfg: PipelineConfig,
                         timer: StageTimer | None = None) -> torch.Tensor:
    """Views synthesis + lenticular interlace: images + disparities ->
    (num_rows_out, num_cols_out, 3) u8, equal to
    `mux_multiview(synthesize_views(...), ...)`.  The warps, merge and
    interlace run as one kernel (B12's interlace mode), which computes
    each output subpixel from the one view it selects and writes no view
    stack; any number of views, bleed radius and output size."""
    masks = synthesis_masks(disp_l, disp_r, cfg, timer)
    with stage_scope("dibr_dbm", timer):
        return warp_merge_interlace(img_l, img_r, disp_l, disp_r, *masks,
                                    cfg.num_views, cfg.num_rows_out,
                                    cfg.num_cols_out, cfg.angle)


def _frame_images(sbs, cfg: PipelineConfig, dev):
    """The SBS frame on `dev`, checked and split into (img_l, img_r)."""
    sbs = torch.as_tensor(sbs).to(dev)
    if tuple(sbs.shape) != cfg.sbs_shape or sbs.dtype != torch.uint8:
        raise ValueError(f"expected a {cfg.sbs_shape} uint8 frame, got "
                         f"{tuple(sbs.shape)} {sbs.dtype}")
    return tuple(t.contiguous() for t in demux_sbs(sbs))


def process_frame(sbs, cfg: PipelineConfig, device=None,
                  timer: StageTimer | None = None):
    """(H, 2W, 3) uint8 SBS frame (numpy array or tensor) -> (disp_l,
    disp_r, interlaced) tensors on `device`: disparities (H, W) float32,
    interlaced (H_out, W_out, 3) uint8."""
    dev = resolve_device(device)
    check_ported(cfg)
    img_l, img_r = _frame_images(sbs, cfg, dev)
    disp_l, disp_r, _, _ = compute_disparities(img_l, img_r, cfg, timer)
    interlaced = synthesize_interlace(img_l, img_r, disp_l, disp_r, cfg,
                                      timer)
    return disp_l, disp_r, interlaced


def process_frame_lowres(sbs, cfg: PipelineConfig, device=None,
                         timer: StageTimer | None = None):
    """`process_frame` with the disparities computed at
    (num_rows_disp, num_cols_disp): the pair is downscaled bilinearly,
    the disparities are upscaled to (H, W) and multiplied by
    1 / disp_scale, and the synthesis runs at full resolution (the
    disparity values then span `synth_disp_bounds(cfg)`)."""
    if not cfg.lowres:
        raise ValueError("cfg must set num_rows_disp/num_cols_disp")
    dev = resolve_device(device)
    check_ported(cfg)
    img_l, img_r = _frame_images(sbs, cfg, dev)
    with stage_scope("tx_scale", timer):
        lo_l = tx_scale_bilinear(img_l, cfg.num_rows_disp, cfg.num_cols_disp)
        lo_r = tx_scale_bilinear(img_r, cfg.num_rows_disp, cfg.num_cols_disp)
    dl, dr, _, _ = compute_disparities(lo_l.contiguous(), lo_r.contiguous(),
                                       cfg, timer)
    with stage_scope("tx_scale", timer):
        up = lambda d: tx_disp_scale(d, cfg.num_rows, cfg.num_cols,
                                     1.0 / cfg.disp_scale).contiguous()
        disp_l, disp_r = up(dl), up(dr)
    interlaced = synthesize_interlace(img_l, img_r, disp_l, disp_r, cfg,
                                      timer)
    return disp_l, disp_r, interlaced
