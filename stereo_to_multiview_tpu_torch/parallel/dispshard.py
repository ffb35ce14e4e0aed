"""Disparity-plane sharding: the D axis of the stereo core across ranks.

The JAX package's parallel/dispshard.py over `torch.distributed`.  Cost
initialization and cross aggregation are independent across disparity
planes, so the D axis shards cleanly: each rank builds and aggregates
its num_disp / n slice of the cost volume, takes each pixel's first
minimum over its planes, and one all-gather of the minima and their
disparities over the `disp` axis gives the global winner, the first
minimum across ranks ordered by d (the reference's tie rule: lower d
wins).

The JAX package cuts each rank's planes from padded images at a traced
offset; here the offset is a number on each rank, so the cost of the
rank's planes is the XLA engine's cost init restricted to them
(`ops.cost.ci_adcensus(planes=...)`), the same float32 values plane by
plane.

With use_hslo, which couples every d of a column, one all-to-all trades
the rank's D-slice of every row slab for all D of its own slab, B13
(`dc_hslo_wta_kern`; the XLA engine's scanline and WTA in torch) runs on
the slab, and an all-gather assembles the rows.
"""

from __future__ import annotations

import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models.pipeline import (
    _frame_images, bilateral, check_ported, refine_disparities,
    resolve_device, synthesize_interlace, use_xla)
from stereo_to_multiview_tpu_torch.ops.band import (
    agg_cost_scale, band_aggregate_q, quantize_cost)
from stereo_to_multiview_tpu_torch.ops.cost import ci_adcensus
from stereo_to_multiview_tpu_torch.ops.cross import (
    cross_aggregate, cross_arms_lr)
from stereo_to_multiview_tpu_torch.ops.hslo import dc_hslo
from stereo_to_multiview_tpu_torch.ops.hslokern import dc_hslo_wta_kern
from stereo_to_multiview_tpu_torch.ops.mux import mux_average
from stereo_to_multiview_tpu_torch.ops.wta import dc_wta
from stereo_to_multiview_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_to_all)

F32 = torch.float32


def _window_cost(img_l, img_r, cfg: PipelineConfig, d0: int, dloc: int):
    """(cost_l, cost_r), each (dloc, H, W) float32: the planes d0 ..
    d0 + dloc - 1 of the XLA engine's cost volumes, bit-equal to those
    planes of `ci_adcensus`."""
    return ci_adcensus(img_l, img_r, cfg.ad_coeff, cfg.census_coeff,
                       cfg.num_disp, cfg.zero_disp,
                       planes=range(d0, d0 + dloc))


def disp_sharded_disparities(mesh: Mesh, cfg: PipelineConfig,
                             disp_axis: str = "disp",
                             with_arms: bool = False, device=None):
    """A function (img_l, img_r) -> (disp_l, disp_r): the AD-census
    stereo core with cost init and aggregation sharded over the mesh's
    `disp_axis` and the WTA as an all-gather of every rank's minima.
    Every rank passes the whole images and gets the whole disparities.

    The aggregation follows cfg.engine: on the band engine each rank
    quantizes its planes and runs the integer band aggregation (B4, B5)
    on them, exact plane by plane, so the result is bit-equal to the
    unsharded band core (first-min ties: ranks are ordered by d); the
    XLA engine keeps its float32 aggregation on unquantized costs, as
    the JAX package's does, bit-equal to its unsharded core there.

    with_arms=True: the function takes (img_l, img_r, arms_l, arms_r), so
    a caller that needs the arms later computes them once."""
    n = mesh.shape[disp_axis]
    if cfg.num_disp % n:
        raise ValueError(f"num_disp {cfg.num_disp} not divisible by "
                         f"disp axis size {n}")
    dloc = cfg.num_disp // n
    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    band = not use_xla(cfg)
    check_ported(cfg)
    dev = resolve_device(device)

    def shard_fn(img_l, img_r, arms_l, arms_r):
        idx = mesh.axis_index(disp_axis)
        d0 = idx * dloc
        costs = _window_cost(img_l, img_r, cfg, d0, dloc)
        if band:
            agg = lambda cost, arms: band_aggregate_q(
                quantize_cost(cost.permute(1, 2, 0), cfg.band_qscale)
                .contiguous(), arms, usd, None, cfg.band_digits,
                cfg.band_qscale)                     # (H, W, dloc) int32
        else:
            agg = lambda cost, arms: cross_aggregate(cost, arms, max_arm=usd)
        acost = [agg(c, a) for c, a in zip(costs, (arms_l, arms_r))]
        del costs
        d_dim, h_dim = (2, 0) if band else (0, 1)

        def wta(vol):
            val, loc = vol.min(dim=d_dim)     # the first minimum
            vals = torch.stack(all_gather(val.contiguous(), mesh, disp_axis))
            locs = torch.stack(all_gather(loc.to(torch.int32) + d0, mesh,
                                          disp_axis))
            # the first minimal rank: ranks are ordered by d
            k = torch.argmin(vals, dim=0)
            disp = torch.gather(locs, 0, k[None])[0]
            return (disp - zd).to(F32)

        if not cfg.use_hslo:
            return tuple(wta(v) for v in acost)

        h, w = img_l.shape[:2]
        if h % n:
            raise ValueError("use_hslo with disparity sharding needs "
                             "num_rows divisible by the mesh")
        kq = (agg_cost_scale(usd, cfg.band_digits, cfg.band_qscale) if band
              else (cfg.xla_agg_qscale if cfg.xla_agg_qscale > 0 else 1.0))
        hloc = h // n
        rows = slice(idx * hloc, (idx + 1) * hloc)
        gl, gr = (mux_average(t)[rows].contiguous() for t in (img_l, img_r))

        def hslo_wta(vol, sign):
            # this rank's D-slice of every slab out, all D of its slab in
            parts = all_to_all(list(vol.split(hloc, dim=h_dim)),
                               mesh, disp_axis)
            full = torch.cat(parts, dim=d_dim)
            if band:
                ga, gb = (gl, gr) if sign > 0 else (gr, gl)
                # (hloc, W, D) int32: the W-major view the JAX entry takes
                slab = dc_hslo_wta_kern(
                    full.transpose(0, 1), ga, gb, nd, zd, cfg.hslo_T,
                    cfg.hslo_H1 * kq, cfg.hslo_H2 * kq, sign=sign)
            else:
                slab = dc_wta(dc_hslo(full, gl, gr, nd, zd, cfg.hslo_T,
                                      cfg.hslo_H1 * kq, cfg.hslo_H2 * kq,
                                      sign=sign), zd)
            return torch.cat(all_gather(slab.contiguous(), mesh, disp_axis))

        return hslo_wta(acost[0], +1), hslo_wta(acost[1], -1)

    def fn(img_l, img_r, *arms):
        img_l, img_r = (torch.as_tensor(t).to(dev).contiguous()
                        for t in (img_l, img_r))
        if with_arms:
            arms = [a.to(dev) for a in arms]
        else:
            arms = cross_arms_lr(img_l, img_r, cfg.ucd, cfg.lcd, usd,
                                 cfg.lsd)
        return shard_fn(img_l, img_r, *arms)

    return fn


def replicated_tail(img_l, img_r, disp_l, disp_r, arms_l, arms_r,
                    cfg: PipelineConfig):
    """Everything after the stereo core, on one rank, as the JAX package's
    disparity-sharded frame runs it: the pipeline's stages on the XLA
    engine and without the median, that is the labels and IRV
    (`refine_disparities`: B7, B8/B9), the XLA bilateral filter and the
    XLA engine's synthesis and interlace.  Returns (disp_l, disp_r,
    interlaced)."""
    cfg = cfg.replace(engine="xla", use_median=False)
    disp_l, disp_r, _, _ = refine_disparities(disp_l, disp_r, arms_l,
                                              arms_r, cfg)
    disp_l, disp_r = bilateral(disp_l, cfg), bilateral(disp_r, cfg)
    return disp_l, disp_r, synthesize_interlace(img_l, img_r, disp_l,
                                                disp_r, cfg)


def disp_sharded_process_frame(mesh: Mesh, cfg: PipelineConfig,
                               disp_axis: str = "disp", device=None):
    """A function of the whole SBS frame (on every rank) -> (disp_l,
    disp_r, interlaced): the stereo core D-sharded
    (`disp_sharded_disparities`), then `replicated_tail` on every rank
    (O(H W) work, where the core is O(H W D)).  On the XLA engine it
    equals the port's `process_frame` (use_median off)."""
    core = disp_sharded_disparities(mesh, cfg, disp_axis, with_arms=True,
                                    device=device)
    dev = resolve_device(device)

    def fn(sbs):
        img_l, img_r = _frame_images(sbs, cfg, dev)
        arms_l, arms_r = cross_arms_lr(img_l, img_r, cfg.ucd, cfg.lcd,
                                       cfg.usd, cfg.lsd)
        disp_l, disp_r = core(img_l, img_r, arms_l, arms_r)
        return replicated_tail(img_l, img_r, disp_l, disp_r, arms_l, arms_r,
                               cfg)

    return fn
