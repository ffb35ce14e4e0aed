"""Whole-frame pipeline: SBS uint8 frame in -> (disp_l, disp_r,
interlaced) out.

Stage order of the band engine (`engine="band"` or `"auto"`), with the
hand-written CUDA kernel of each stage:
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

The XLA engine (`engine="xla"`) is the JAX package's other engine: the
same arms (B1), then a (D, H, W) float32 cost volume, optionally
integer-quantized (`xla_agg_qscale`), float32 prefix-window
aggregation, [scanline optimisation,] first-min WTA, all plain torch;
the same labels (B7) and IRV (B8/B9, fixed rounds or their bit-equal
early stop); the bilateral filter in the XLA tap order at any radius
(plain torch); the fused occlusion stage (B7's hits and B11); then the
feather, bounded backward warps, the merge and `mux_multiview`, plain
torch, as the JAX package computes them outside any Pallas kernel.  Its
float stages follow the arithmetic of the JAX package's jitted CPU
executable (XLA's exp, its blocked cumsum, multiply-adds where its loops
contract them), so a frame equals JAX's.  `engine="auto"` is the band
engine.

`process_frame_lowres` computes the disparities on a downscaled pair and
scales them back up before the synthesis, each rescale of both eyes one
launch (G2, `csrc/scale.cu`).

This module is the one place that maps cfg.engine to a stage's function:
`stereo_core`, `bilateral`, `feather`, `intermediate_views` and the
interlace of `synthesize_interlace`.  The sharded paths (`parallel/`)
call these stages on their shards.

The band engine's stereo core has quantized cost, exact integer
aggregation and a first-min WTA; the kernels' plain versions follow the
JAX package's XLA-engine functions, which its tests hold equal to its
band-engine kernels.

Entry points run on the CUDA device unless the caller passes
`device="cpu"` (the tests do); without a GPU and without that request
they raise.
"""

from __future__ import annotations

import math

import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.ops.band import band_stereo_core_chunked
from stereo_to_multiview_tpu_torch.ops.cost import ci_adcensus
from stereo_to_multiview_tpu_torch.ops.costkern import cost_dtype
from stereo_to_multiview_tpu_torch.ops.cross import (
    cross_aggregate, cross_arms_lr)
from stereo_to_multiview_tpu_torch.ops.dcc import dr_dcc
from stereo_to_multiview_tpu_torch.ops.demux import demux_sbs
from stereo_to_multiview_tpu_torch.ops.dibr import (
    dibr_backward_warp, dibr_feather_mask, dibr_occl_masks, op_invertnormf,
    synth_shifts, warp_merge_interlace, warp_merge_views)
from stereo_to_multiview_tpu_torch.ops.filters import (
    filter_bilateral, filter_bilateral_wide, filter_gaussian_lift,
    filter_median)
from stereo_to_multiview_tpu_torch.ops.hslo import dc_hslo
from stereo_to_multiview_tpu_torch.ops.irv import dr_irv_early_stop
from stereo_to_multiview_tpu_torch.ops.mux import (
    f32, mux_average, mux_merge_ab, mux_multiview)
from stereo_to_multiview_tpu_torch.ops.scale import (
    tx_disp_scale_lr, tx_scale_bilinear_lr)
from stereo_to_multiview_tpu_torch.ops.wta import dc_wta
from stereo_to_multiview_tpu_torch.utils.profiling import stage_scope


def resolve_device(device=None) -> torch.device:
    """The CUDA device unless the caller asks for another; raise when no
    GPU is present and no device was asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def use_xla(cfg: PipelineConfig) -> bool:
    """True for the XLA engine; "auto" and "band" take the band engine
    (the JAX package's resolution on a TPU)."""
    if cfg.engine not in ("auto", "band", "xla"):
        raise ValueError(f"unknown engine {cfg.engine!r}")
    return cfg.engine == "xla"


def check_ported(cfg: PipelineConfig):
    """Raise ValueError, before a frame starts, for a value the engine
    refuses: the band engine's dials out of range, or an
    `xla_agg_qscale` whose prefix sums would not be exact."""
    if use_xla(cfg):
        xla_qscale_check(cfg)
        return
    if cfg.band_digits not in (1, 2, 3):
        raise ValueError("band_digits must be 1, 2 or 3")
    cost_dtype(cfg.band_qscale)


def xla_qscale_check(cfg: PipelineConfig):
    """With xla_agg_qscale > 0 every prefix of the four passes must stay
    below 2^24 (exact in float32) at the configured geometry; raise
    ValueError otherwise."""
    if cfg.xla_agg_qscale <= 0:
        return
    wmax = 2 * cfg.usd + 1
    v = 2.0 * cfg.xla_agg_qscale              # cost <= 2
    hh, ww = cfg.num_rows + 2 * 64, cfg.num_cols + 2 * 64
    for axis_len in (ww, hh, hh, ww):         # H, V, V, H pass prefixes
        if v * axis_len >= 2.0 ** 24:
            raise ValueError("xla_agg_qscale too large for exact integer "
                             "aggregation at this geometry")
        v = v * wmax


def xla_quant_costs(cost_l, cost_r, cfg: PipelineConfig):
    """cfg.xla_agg_qscale > 0: rint(cost * qscale), so the XLA engine's
    float32 aggregation adds integers and is exact (its geometry is
    checked first); qscale 0 returns the costs untouched."""
    if cfg.xla_agg_qscale <= 0:
        return cost_l, cost_r
    xla_qscale_check(cfg)
    q = f32(cfg.xla_agg_qscale)
    return torch.round(cost_l * q), torch.round(cost_r * q)


def xla_stereo_core(img_l, img_r, arms_l, arms_r, cfg: PipelineConfig):
    """The XLA engine's cost init, aggregation, [scanline optimisation]
    and WTA: (disp_l, disp_r) float32, plain torch on every device."""
    costs = list(xla_quant_costs(*ci_adcensus(
        img_l, img_r, cfg.ad_coeff, cfg.census_coeff, cfg.num_disp,
        cfg.zero_disp), cfg))
    disps = []
    for eye, (arms, sign) in enumerate(((arms_l, +1), (arms_r, -1))):
        acost = cross_aggregate(costs[eye], arms, max_arm=cfg.usd)
        costs[eye] = None               # one eye's volumes at a time
        if cfg.use_hslo:
            # quantized costs scale the aggregate's units, and the
            # penalties with them
            kq = cfg.xla_agg_qscale if cfg.xla_agg_qscale > 0 else 1.0
            acost = dc_hslo(acost, mux_average(img_l), mux_average(img_r),
                            cfg.num_disp, cfg.zero_disp, cfg.hslo_T,
                            cfg.hslo_H1 * kq, cfg.hslo_H2 * kq, sign=sign)
        disps.append(dc_wta(acost, cfg.zero_disp))
    return tuple(disps)


def stereo_core(img_l, img_r, arms_l, arms_r, cfg: PipelineConfig):
    """Cost init, aggregation, [scanline optimisation] and WTA on the
    given arms -> (disp_l, disp_r) float32: the band engine's core
    (B2-B6, B13 with use_hslo, over cfg.band_row_chunk row chunks) or the
    XLA engine's (plain torch)."""
    core = xla_stereo_core if use_xla(cfg) else band_stereo_core_chunked
    return core(img_l, img_r, arms_l, arms_r, cfg)


def refine_disparities(disp_l, disp_r, arms_l, arms_r,
                       cfg: PipelineConfig):
    """The stereo core's disparities -> (disp_l, disp_r, out_l, out_r):
    the left-right labels (B7), then IRV on the given arms (B8/B9 a
    round, stopping at the fixpoint); the same on both engines."""
    with stage_scope("dr_dcc"):
        out_l, out_r = dr_dcc(disp_l, disp_r, cfg.dcc_thresh)
    with stage_scope("dr_irv"):
        irv = lambda d, o, a: dr_irv_early_stop(
            d, o, a, cfg.irv_thresh_s, cfg.irv_thresh_h, cfg.num_disp,
            cfg.zero_disp, cfg.usd, cfg.irv_iterations,
            row_chunk=cfg.irv_row_chunk)
        disp_l, out_l = irv(disp_l, out_l, arms_l)
        disp_r, out_r = irv(disp_r, out_r, arms_r)
    return disp_l, disp_r, out_l, out_r


def raw_disparities(img_l, img_r, cfg: PipelineConfig):
    """Stereo matching up to IRV: images -> (disp_l, disp_r) float32
    before the median and bilateral filters, plus the outlier labels
    (u8)."""
    with stage_scope("ca_cross_arms"):
        arms_l, arms_r = cross_arms_lr(img_l, img_r, cfg.ucd, cfg.lcd,
                                       cfg.usd, cfg.lsd)
    with stage_scope("stereo_core"):
        disp_l, disp_r = stereo_core(img_l, img_r, arms_l, arms_r, cfg)
    return refine_disparities(disp_l, disp_r, arms_l, arms_r, cfg)


def bilateral(disp, cfg: PipelineConfig):
    """The bilateral filter of one (H, W) float32 disparity map: B10 on
    the band engine (`filter_bilateral`, which hands radii above 8 to
    the XLA filter); the XLA engine's filter, in its own tap order, at
    every radius."""
    filt = filter_bilateral_wide if use_xla(cfg) else filter_bilateral
    return filt(disp, cfg.bilateral_radius, cfg.bilateral_sigma_color,
                cfg.bilateral_sigma_spatial)


def compute_disparities(img_l, img_r, cfg: PipelineConfig):
    """Stereo matching half of the pipeline: images -> refined (disp_l,
    disp_r) float32 plus the outlier labels."""
    disp_l, disp_r, out_l, out_r = raw_disparities(img_l, img_r, cfg)
    if cfg.use_median:
        with stage_scope("filter_median"):
            disp_l, disp_r = filter_median(disp_l), filter_median(disp_r)
    with stage_scope("filter_bilateral"):
        disp_l, disp_r = bilateral(disp_l, cfg), bilateral(disp_r, cfg)
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


def feather(mask_r, cfg: PipelineConfig):
    """The feathered blend weight of the right mask: G1 on the band
    engine; on the XLA engine the plain torch feather in the JAX
    package's jitted CPU order (`filter_gaussian_lift(...,
    contract=True)`), which G1 is not."""
    if use_xla(cfg):
        return filter_gaussian_lift(op_invertnormf(mask_r),
                                    cfg.feather_radius, cfg.feather_sigma,
                                    contract=True)
    return dibr_feather_mask(mask_r, cfg.feather_radius, cfg.feather_sigma)


def synthesis_masks(disp_l, disp_r, cfg: PipelineConfig):
    """The synthesis' masks from the disparities: (mask_l, mask_r) float32
    {0, 1} (occlusion hits B7 and bleed B11 in one launch) and the
    feathered blend weight (`feather`)."""
    with stage_scope("dibr_occl"):
        mask_l, mask_r = dibr_occl_masks(disp_l, disp_r, cfg.bleed_radius)
    with stage_scope("dibr_feather"):
        feathered = feather(mask_r, cfg)
    return mask_l, mask_r, feathered


def intermediate_views(img_l, img_r, disp_l, disp_r, masks, shifts,
                       cfg: PipelineConfig, out=None) -> torch.Tensor:
    """The views at `shifts`, (len(shifts), H, W, 3) u8: for each shift,
    the left image warped with disp_r at -shift (masked by mask_r) and
    the right one with disp_l at 1 - shift (masked by mask_l), merged
    with the feathered weight; `masks` is (mask_l, mask_r, feathered).
    The band engine runs B12's view stack (every view in one launch);
    the XLA engine its bounded warps (`dibr_backward_warp`) in plain
    torch, each lerp's second term added by a fused multiply-add as in
    the JAX package's jitted frame.  Written into `out`, (len(shifts),
    H, W, 3), when given."""
    if not use_xla(cfg):
        return warp_merge_views(img_l, img_r, disp_l, disp_r, *masks,
                                shifts, out=out)
    if not shifts:
        return img_l.new_empty((0, *img_l.shape)) if out is None else out
    mask_l, mask_r, feathered = masks
    nd_s, zd_s = synth_disp_bounds(cfg)
    views = [
        mux_merge_ab(
            dibr_backward_warp(img_l, mask_r, disp_r, -s, nd_s, zd_s, True),
            dibr_backward_warp(img_r, mask_l, disp_l, 1.0 - s, nd_s, zd_s,
                               True),
            feathered)
        for s in shifts]
    return torch.stack(views) if out is None else torch.stack(views, out=out)


def synthesize_views(img_l, img_r, disp_l, disp_r,
                     cfg: PipelineConfig) -> torch.Tensor:
    """DIBR half: images + disparities -> (V, H, W, 3) u8 view stack.
    View 0 = right source, view V-1 = left source; intermediate view v
    warps L with disp_r at -shift and R with disp_l at 1 - shift,
    shift = 1 - v/(V-1), and merges them with the feathered mask
    (`intermediate_views`).  The stack is allocated once; the two sources
    are copied into it and the intermediate views written into it in
    place."""
    masks = synthesis_masks(disp_l, disp_r, cfg)
    with stage_scope("dibr_dbm"):
        views = torch.empty((cfg.num_views, *img_l.shape), dtype=torch.uint8,
                            device=img_l.device)
        views[0] = img_r
        views[-1] = img_l
        intermediate_views(img_l, img_r, disp_l, disp_r, masks,
                           synth_shifts(cfg.num_views), cfg, out=views[1:-1])
    return views


def synthesize_interlace(img_l, img_r, disp_l, disp_r,
                         cfg: PipelineConfig) -> torch.Tensor:
    """Views synthesis + lenticular interlace: images + disparities ->
    (num_rows_out, num_cols_out, 3) u8, equal to
    `mux_multiview(synthesize_views(...), ...)`.  On the band engine the
    warps, merge and interlace run as one kernel (B12's interlace mode),
    which computes each output subpixel from the one view it selects and
    writes no view stack; any number of views, bleed radius and output
    size.  On the XLA engine it is that composition, in plain torch."""
    if use_xla(cfg):
        views = synthesize_views(img_l, img_r, disp_l, disp_r, cfg)
        with stage_scope("mux_multiview"):
            return mux_multiview(views, cfg.num_rows_out, cfg.num_cols_out,
                                 cfg.angle, contract=True)
    masks = synthesis_masks(disp_l, disp_r, cfg)
    with stage_scope("dibr_dbm"):
        return warp_merge_interlace(img_l, img_r, disp_l, disp_r, *masks,
                                    cfg.num_views, cfg.num_rows_out,
                                    cfg.num_cols_out, cfg.angle)


def _frame_images(sbs, cfg: PipelineConfig, dev):
    """The SBS frame on `dev`, checked and split into (img_l, img_r)."""
    with stage_scope("frame_in"):
        sbs = torch.as_tensor(sbs).to(dev)
        if tuple(sbs.shape) != cfg.sbs_shape or sbs.dtype != torch.uint8:
            raise ValueError(f"expected a {cfg.sbs_shape} uint8 frame, got "
                             f"{tuple(sbs.shape)} {sbs.dtype}")
        return tuple(t.contiguous() for t in demux_sbs(sbs))


def process_frame(sbs, cfg: PipelineConfig, device=None):
    """(H, 2W, 3) uint8 SBS frame (numpy array or tensor) -> (disp_l,
    disp_r, interlaced) tensors on `device`: disparities (H, W) float32,
    interlaced (H_out, W_out, 3) uint8."""
    dev = resolve_device(device)
    check_ported(cfg)
    img_l, img_r = _frame_images(sbs, cfg, dev)
    disp_l, disp_r, _, _ = compute_disparities(img_l, img_r, cfg)
    interlaced = synthesize_interlace(img_l, img_r, disp_l, disp_r, cfg)
    return disp_l, disp_r, interlaced


def process_frame_lowres(sbs, cfg: PipelineConfig, device=None):
    """`process_frame` with the disparities computed at
    (num_rows_disp, num_cols_disp): the pair is downscaled bilinearly,
    the disparities are upscaled to (H, W) and multiplied by
    1 / disp_scale, and the synthesis runs at full resolution (the
    disparity values then span `synth_disp_bounds(cfg)`).  Both rescales
    take both eyes in one launch (G2)."""
    if not cfg.lowres:
        raise ValueError("cfg must set num_rows_disp/num_cols_disp")
    dev = resolve_device(device)
    check_ported(cfg)
    img_l, img_r = _frame_images(sbs, cfg, dev)
    with stage_scope("tx_scale"):
        lo_l, lo_r = tx_scale_bilinear_lr(img_l, img_r, cfg.num_rows_disp,
                                          cfg.num_cols_disp)
    dl, dr, _, _ = compute_disparities(lo_l, lo_r, cfg)
    with stage_scope("tx_scale"):
        disp_l, disp_r = tx_disp_scale_lr(dl.contiguous(), dr.contiguous(),
                                          cfg.num_rows, cfg.num_cols,
                                          1.0 / cfg.disp_scale)
    interlaced = synthesize_interlace(img_l, img_r, disp_l, disp_r, cfg)
    return disp_l, disp_r, interlaced


def make_process_frame(cfg: PipelineConfig, lowres: bool = False,
                       device=None):
    """The JAX package's `make_process_frame`: a function SBS frame ->
    (disp_l, disp_r, interlaced), `process_frame` (or with `lowres`,
    `process_frame_lowres`) at this config and device."""
    entry = process_frame_lowres if lowres else process_frame
    dev = resolve_device(device)
    check_ported(cfg)

    def fn(sbs):
        return entry(sbs, cfg, device=dev)

    return fn
