"""PyTorch/CUDA port of the stereo -> multiview engine.

Side-by-side stereo in, AD-census disparity + N-view lenticular-interlaced
frame out, on an NVIDIA H100.  The JAX package `stereo_to_multiview_tpu`
is the reference; this package imports nothing of it (nor JAX) and keeps
its module names, so each counterpart is easy to find:

  config         -- PipelineConfig (same fields), config_from_dict
  ops            -- one function per pipeline stage, on torch tensors
  ops.cross      -- kernel B1 (cross arms; both eyes in one launch,
                    `cross_arms_lr`)
  ops.costkern   -- kernels B2 (cost pair volume or one eye of a row
                    range, the census computed in the kernel; u8, int16
                    or float32), B3 (right-eye shear), B16 (`cost_dm`:
                    both eyes or one of a row range, disparity-major,
                    the census computed in the kernel too; both share
                    csrc/census.cuh) and B17
                    (`shear_right_dm`: the right eye by per-plane
                    shifts), with `ci_adcensus_kern(_stacked)` and
                    `ci_adcensus_kern_xm`
  ops.fastmath   -- the polynomial exp of `fast_exp` and its proof
  ops.band       -- kernels B4/B6 (horizontal passes, WTA, the lossy
                    WTA) and B5 (vertical passes) of the band engine's
                    stereo core, with the dials band_qscale and
                    band_lossy_wta;
                    B18a-c, the disparity-major core
                    (`band_stereo_core_dm`); B15 (float span sums,
                    `band_span_sum_h/_v`, under `dr_irv_band(_lr)`)
  ops.chunks     -- the row chunks of the stereo cores and IRV rounds
  ops.dcc        -- kernel B7 (consistency labels)
  ops.hslokern   -- kernel B13 (scanline optimisation + WTA, both eyes
                    in one launch: `dc_hslo_wta_lr`); ops.hslo holds
                    its plain version
  ops.irv        -- kernels B8/B9 (an IRV round, `need`-gated) and the
                    frontier-gated round loop
  ops.filters    -- kernel B10 (bilateral, radius <= 8), median, bleed
  ops.dibr       -- kernels B7 (hits), B11, G1 (the mask feather), B12
                    (warp + merge + interlace in one kernel,
                    `warp_merge_interlace`, the synthesis of every path;
                    the view stack, `warp_merge_views`, every view in
                    one launch) and B14 (the
                    float warps of every view); the forward warp
  ops.warpkern   -- kernels B19/B20 (the bounded row-major warps,
                    `dibr_warp_views_kern`, `dibr_warp_pair_kern`;
                    every view in one launch)
  ops.mux        -- the interlace's view pattern and `mux_multiview`
  ops.scale      -- the rescales of the lowres path and the interlace
  ops.cost, ops.cross, ops.wta, ops.hslo (`dc_hslo`)
                 -- the XLA engine's (D, H, W) float32 cost,
                    aggregation, WTA and scanline optimisation (plain
                    torch; ops.fastmath holds XLA's CPU exp and the
                    contracted sums its jitted executable computes)
  csrc           -- the CUDA sources of those kernels (sm_90a)
  kernels        -- nvcc build, ctypes loading, launch counters
  models         -- process_frame, process_frame_lowres,
                    synthesize_interlace, synthesize_views (both
                    engines: cfg.engine "band"/"auto" or "xla");
                    models.stream, the stream driver and its sources
  native         -- ctypes binding of native/stm_native.cpp (BMP, decode
                    queue, Y4M), built with the host compiler
  utils          -- BMP reader/writer, Y4M, PNG, dumps, live preview,
                    device report, stage annotation and timing
  apps           -- image_io, video_io: the command-line apps
"""

from stereo_to_multiview_tpu_torch.config import (
    PipelineConfig, config_from_dict)

__all__ = ["PipelineConfig", "config_from_dict"]
