#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from stereo_to_multiview_tpu_torch/csrc (nvcc,
   sm_90a, one process per source, in parallel).
2. Holds every kernel against its plain PyTorch version on the card, at
   the shapes the paths give it (1080p, D=128, usd=34; once more as the
   lowres path stages them: 540x960, D=64, synthesis at 1080p; and at the
   chunk shapes of the 4K preset: 680 and 1152 rows of 3840 columns,
   synthesis of 14 views at 2160x3840): bit equality required.  Times
   kernel, plain version, and one PyTorch library call where one computes
   the same function.  Also holds the early-stop IRV against the fixed
   rounds and the row-chunked IRV against the whole-frame one, bit for
   bit, checks that its loop waits on nothing (`set_sync_debug_mode`)
   and runs G3 for its frontier and no torch max-pool (`torch.profiler`),
   times one round under an empty frontier, G3 (the frontier between
   IRV rounds) against `dilate_frontier` at the 1080p, 540x960 and 4K
   frames, after each round of the 1080p frame and at its edges (1-row,
   1-column and 1x1 frames, widths off 16, usd 0 to 127, no change, every
   pixel, each corner, planes one byte off 16), and the lane-major window
   passes at the band_digits 2 and 1 shifts, and the streamed B5 and B9
   where their streams meet the frame's edges (37 rows, fewer than a ring
   holds; reach 0), B5 also where its staged path gives way to its
   register path (D = 130 and 126, a base one element off 16 bytes,
   reach 108), at reach 64 and on fewer rows than a stage holds, its
   `vv_pass.staged` count and its launch plan in C against
   `band.vv_stages`, B9 where its staged path meets its edges (D=130,
   reach 127, a volume 4 bytes off 16) and where it gives way to its
   register path (D=1023 at reach 50), its `irv_vote.staged` count, and
   the
   streamed B4 and B6 there and where their row streams and vector paths
   end (a width below one segment, D=126 and D=130, prefixes that wrap,
   ties).  The configuration limits once refused on the card: B2 and B3
   at D=126, the warps B12 (both modes), B14 and B19 with 38 views.  The
   synthesis kernel (B12's interlace mode) at each preset's output (the
   1080p and 4K frames, and 1080p views to the HSLO_4K preset's 2160x3840
   output), with two views, on a 37x1001 crop, shrunk to 720x1280 and at
   another angle; the feather G1 at radii 0, 1, 10, 40 and 70 (two
   launches) and on a 37x15 crop.  The occlusion stage (B7's hits and
   B11's bleed of both eyes in one launch) at each preset's synthesis,
   at radii 0, 2, 3 and 10, on 37x1001, 37x15 and 2x1001 crops, on
   writers past the borders, all-zero and negative fractional
   disparities, on planes of 8x23000 (the widest rows B7 stages for the
   labels), 8x25000 (past the width B7 once refused) and 16x200000 at
   r = 5 (above its one-launch radius: two launches; B7 takes the rows
   in four segments); B7's labels and hits on the same planes, and B11's
   u8 entry on values 0, 1 and 2.
   The occlusion kernels are timed from a CUDA graph of their calls
   (device time: they run shorter than their wrappers' host time).  The
   modes of the
   band engine's dials: B2's int16 (band_qscale 510) and float32 pairs
   and both eyes directly in u8, int16 and float32, B3 in int16 and
   float32, B4 on int16 costs at the qscale-510 shifts of band_digits 3,
   2 and 1, B6's lossy WTA (band_lossy_wta) at the shifts of band_digits
   3, 2 and 1 and on inputs that its rounding turns into ties; and where
   their streams end (37 rows, D=126, int16 windows past 2^16).  The
   streamed B8, full and gated, where its row streams end and its byte
   prefixes wrap (37 rows, reach 0, an odd width, D=126, D=130, reach 127
   with windows of 255 in one bin), and with B9 in each round of the early-
   stop IRV on the 1080p frame; B10 at radii 0, 1, 7 and 8, on 37 rows,
   on fractional values past its range-weight table and where |a - s|
   falls on integers and one ulp below them.  B13 on both eyes in one
   launch (against two one-eye launches too), on a 37-row crop, at W =
   1, 15, 17, D = 30, 126, 130 on both signs, on equal costs and on ties,
   at zero penalties and above every cost; B3 streamed at zd = 0 and
   zd = D, W below one ring tile, D = 130 and 132, on the 4K preset's
   third row chunk, in int16 and float32.  B1 on both eyes in one
   launch, also at thresholds that bf16 would round up (5.99, 19.97),
   past 255 and below 0, at usd = lsd and at usd above a 37-row crop's
   height; B2 with the census computed in the kernel, on the whole frame,
   at D=130 and on the 4K preset's third row chunk of the whole frame
   (rows 1012-1691, whose census reads rows outside the chunk).  The
   entry points beside process_frame run on the 1080p
   frame's own stages, each as a path with its launch counts checked:
   `dr_irv_band_lr` (B15, 5 fixed rounds) equal to the fixed-round
   `dr_irv` (B8/B9); `dibr_warp_views_kern` (B19) equal to
   `dibr_warp_pair_kern` (B20) view by view and to B14; and
   `ci_adcensus_kern(shift_extract=True)` (B16's one-eye modes, B17)
   equal to shift_extract=False, u8 and float32 (B16 twice: the left eye,
   then both border strips in one launch); and
   `ci_adcensus_kern_xm` (B2's pair and B3, or B2 once an eye) with the
   shear equal to without, u8, int16 and float32; `synthesize_views`
   (B12's view stack), whose stack interlaced by the torch
   `mux_multiview` equals `synthesize_interlace`, `warp_views` (B14),
   and B7's hits then B11's u8 entry on each eye, equal to the fused
   occlusion stage.
   The forward warp (`dibr_dfm`, plain torch) is timed at 1080p and held
   card vs CPU.  B15 at its edges, along x and y: max_arm 0 and 64, lines
   shorter than one window, D = 1, 30 and 130, every nsplit, inclusive
   and half-open windows, integer volumes (its prefix blocks) up to and
   one past their bound, and a volume of +-inf, NaN, -0.0 and cancelling
   magnitudes (bit for bit, a zero's sign included); B18b at reach 0 and
   64, on 37 rows, at D = 30 and on inputs whose rescaled pass-2 sums
   pass the int16 ceiling; B18a and B18c at reach 0 and 64, on 37 rows,
   at W = 1, 15, 17 and 1001, at D = 30 on unaligned and aligned rows and
   at D = 261, on a volume whose base is one element off 16 bytes, and
   B18c on window sums past 2^21 and on tied planes.  B16, which computes
   the census of its row range itself, on the first and last 540-row
   chunks of the 1080p frame and the 4K frame's third chunk, at W = 1,
   15, 17 and 1001, D = 30, D = 256 at zd = 128 and zd = 0, in float32 on
   a chunk, and its two right-eye strips in one launch at M = 1 and 64.
   B12's view stack (every view in one launch) with 3, 16 and 38 views,
   at 4K with 14, on 37x1001, 37x1 and 37x17 crops, on masks and a
   feather outside [0, 1], and into a view stack whose middle views are
   not 16-byte aligned; `synthesize_views` with 40 views (B12 once) and
   with 2 (no B12).  B19 (every view in one launch, its count held at one
   for 38 views) on the 4K frame with 14 views, on 37x1001, 37x1, 37x15
   and 37x17 crops and on disparities of +-64 whose samples clamp at both
   ends of a row, and B20 at the shifts 0 and 1, each bit for bit (its
   zeros +0.0) and timed from a CUDA graph beside its CUDA-event time;
   B17 u8 on rows of 4-byte words (200x1004) and of bytes (W = 1, 15,
   17), at zd = 0 and zd = D, on one plane and on a 4K chunk's shape
   (128x680x3840).
3. Drives the paths on SBS frames built from tests/data/bud_{2,3}.bmp:
   `process_frame` at HD1080_D128 (the main path), at
   HD1080_D128_HSLO_4K (scanline optimisation, median, 1080p views
   interlaced to 4K), at HD1080_D128 with band_digits 2 and 1, with
   band_qscale=510 and with band_lossy_wta, and at UHD4K_16V (2160x3840,
   16 views, row-chunked stereo core and IRV);
   `process_frame_lowres` at HD1080_LOWRES; and the disparity-major
   stereo core `band_stereo_core_dm` at 1080p/D=128, whole-frame and in
   540-row chunks, and at 2160x3840 in 540-row chunks (its kernels held
   against their plain versions on a 680x3840 chunk first), which must
   equal the lane-major core at band_digits=2 in every pixel of both
   eyes.  For each, launch counts are zeroed just before one run and read
   just after: every kernel of the path must have launched, and the
   kernels the path replaces must not, and every B5 and B9 launch must
   have taken its staged path (`vv_pass.staged`, `irv_vote.staged`); the
   path's interlaced frame
   must equal the plain chain (plain masks, feather, view stack and
   `mux_multiview`) computed on the card from its disparities; then a
   few runs are timed with CUDA events.
4. Checks the outputs: shapes, dtypes, finite disparities in range, and
   small frames (plain, HSLO + median + resampled, lowres, bilateral
   radius 10, num_disp 30, 40 views, band_qscale 510 and 64,
   band_lossy_wta at band_digits 3 and 1, HSLO at band_qscale 510, and
   the disparity-major core) run on the card against the same frames run
   on the CPU.
5. The runtime: the stream driver (`models.stream.stream`) over 8
   distinct 1080p SBS frames (shifted crops of the bud pair) written as
   BMP files and as one Y4M file, read by FrameSource, the native decode
   queue and Y4MSource, at depth 2 and 1 with readback full and sync, 30
   frames each (its launch counts held on the first run; every frame's
   outputs bit-equal to process_frame on the same frame, on the decoded
   frame for Y4M), and at UHD4K_16V at depth 2, both readbacks, 10
   frames; fps and ms beside process_frame's own ms.  The video app
   (--frames 12 --depth 2 --readback sync) on the frame directory and
   the image app (--npy) on the 1080p pair, each through its main():
   return code 0 and the JAX apps' file names.  The XLA engine
   (engine="xla") at HD1080_D128 as a path (launch set, three timed
   frames, peak memory, the share of disparities equal to the band
   engine's), and three 96x160 frames of it card vs CPU (exact at
   xla_agg_qscale 8).
6. Sharding (`stereo_to_multiview_tpu_torch/parallel/`): B1's halo-shard
   mode against its plain version on extended row shards (the top, a
   middle and the bottom shard with its 3 * usd halo of the 1080p frame
   at 2 and 4 shards, a shard of the 4K frame, usd 34 and 64); then, in
   four gloo ranks that time-share the card (parallel.launch), the halo
   path at HD1080_D128 over 2 and 4 ranks, UHD4K_16V over 2 ranks and on
   a (2, 2) row x view mesh (its interlace also equal to the row-only
   mesh's), HD1080_D128_HSLO_4K without the median (a resampled output)
   over 2 ranks, the disparity planes at HD1080_D128 (core and frame)
   and with use_hslo over 4 ranks, and the XLA engine's row strategy and
   halo path at 96x64; last, NCCL as a world of one.  Each path's launch
   counts are zeroed in every rank just before its counted frame and
   read just after (its kernels launched, the kernels it replaces not),
   its assembled outputs must equal the unsharded ones (`process_frame`,
   the unsharded band core, or the core and `replicated_tail`) bit for
   bit, and its ms a frame, ms in exchanges, peak memory per rank and
   the collectives staged through host memory are printed: ranks
   time-sharing one card measure contention, not scaling.

`python3 chip_smoke.py --frames N [--package-root DIR]` instead times only
the four preset paths (HD1080_D128, HSLO_4K, LOWRES, UHD4K_16V) and the
two dial paths (where that package has the dials), N frames each, on the
package under DIR: the way to compare two commits' frame and stage times
within one call.  `--stream-checks [--package-root DIR]` only holds the
staged kernels B1 and B2 (at their edges too), the streamed kernels B3,
B4, B5, B6, B8, B9, B10 and B13 (and the kernels that feed them; B3,
B8, B9, B10 and B13 at their edges and B8 and B9 in each IRV round
too), then the dials' modes of B2-B4 and B6, against their plain
versions, on the package under DIR: the way to show that a deliberately
broken copy of one fails, and to time two commits' kernels in turns.
`--synth-checks [--package-root DIR]` does the same for the synthesis
kernels: the occlusion stage (fused, and B7's hits and B11 unfused), the
feather G1 and B12 (its view stack and its interlace mode) at their
edges, the row-major warps B19 and B20 (at their edges, as a path, and
B19 on the 4K frame), and each preset path's interlaced frame against the
plain chain.  `--band-checks [--package-root DIR]` does the same for B15
(its path shapes and edges, `dr_irv_band_lr` as a path) and the
disparity-major core (B16, B18a-c at 1080p, a 680-row chunk, 200x1001
and a 4K chunk, B16's one-eye modes and edges, B18a-c's edges,
`band_stereo_core_dm` as paths, B17 at its edges,
`ci_adcensus_kern(shift_extract=True)` as a path), then prints
`ci_adcensus_kern` (u8, float32) and `band_stereo_core_dm` (1080p whole
and in 540-row chunks, 4K) split by CUDA events into the torch census (a
package whose B16 takes census codes), B16, B18a-c, the chunks' glue and
the relayout copies.
`--vpass-checks [--package-root DIR]` does the same for B5 alone: at the
presets' shapes (the 1080p frame, a 680x3840 chunk of the 4K preset,
the lowres preset's 540x960) and its edges, timed: the way to time two
commits' B5 in turns.
`--irv-checks [--package-root DIR]` does the same for B9 and G3 alone:
B9 full and gated on the 1080p frame, a 1152x3840 IRV chunk of the 4K
preset and the lowres preset's 540x960, then at its edges (37 rows, reach
0 and 127, D=130, a volume 4 bytes off 16, and the register path at
D=1023 and reach 50), G3 at 1080p, 540x960 and its edges, timed: the way
to time two commits' B9 in turns (a package without G3 skips it).
`--runtime-checks` runs phase 5 alone, `--shard-checks` phase 6 alone.

Prints the card's name and power limit, per-stage and per-kernel times,
a `{"kernels": [...]}` line, and last `{"ok": true, "device": {...}}`.
Exits non-zero, printing no result, without a CUDA device or when any
phase fails.  Detailed results also go to out/chip_smoke.json.
"""

import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12      # float32 outside the tensor cores; the
                            # kernels' integer ALU work is counted at it
# float32 operations that may not contract into a multiply-add (B10):
# 128 a clock on each of the 132 SMs at the 1.98 GHz boost clock
PEAK_FP32_NOFMA_PER_S = 128 * 132 * 1.98e9

# kernel name -> (wrapper, source, replaced TPU kernel, the path whose
# launch count the kernels line reports)
_SRC = "stereo_to_multiview_tpu_torch/csrc/"
_TPU = "stereo_to_multiview_tpu/ops/"
MAIN, HSLO4K, LOWRES = "HD1080_D128", "HD1080_D128_HSLO_4K", "HD1080_LOWRES"
DIGITS2, DIGITS1 = "HD1080_D128 band_digits=2", "HD1080_D128 band_digits=1"
UHD4K = "UHD4K_16V"
DM, DM_CHUNKED, DM_4K = (
    "band_stereo_core_dm HD1080_D128",
    "band_stereo_core_dm HD1080_D128 band_row_chunk=540",
    "band_stereo_core_dm UHD4K_16V")
KERNELS = {
    "B1 cross_arms": ("cross_arms_eyes", _SRC + "arms.cu",
                      _TPU + "postkern.py:80", MAIN),
    "B2 cost_pair": ("cost_pair", _SRC + "cost.cu",
                     _TPU + "costkern.py:279", MAIN),
    "B3 shear_right": ("shear_right", _SRC + "shear.cu",
                       _TPU + "costkern.py:342", MAIN),
    "B4 h_pass_sum (pass 1)": ("h_pass_sum", _SRC + "hpass.cu",
                               _TPU + "band.py:150", MAIN),
    "B5 vv_pass (passes 2+3)": ("vv_pass", _SRC + "vpass.cu",
                                _TPU + "band.py:330", MAIN),
    "B6 h_pass_wta (pass 4 + WTA)": ("h_pass_wta", _SRC + "hpass.cu",
                                     _TPU + "band.py:150", MAIN),
    "B6 h_pass_sum (pass 4, no WTA)": ("h_pass_sum", _SRC + "hpass.cu",
                                       _TPU + "band.py:150", HSLO4K),
    "B7 dr_dcc (labels)": ("dr_dcc", _SRC + "occl.cu",
                           _TPU + "postkern.py:255", MAIN),
    "B7 dibr_occl (hits)": ("dibr_occl", _SRC + "occl.cu",
                            _TPU + "postkern.py:255", MAIN),
    "B7 dibr_occl (hits, on dr_dcc's inputs)": (
        "dibr_occl", _SRC + "occl.cu", _TPU + "postkern.py:255", MAIN),
    "B8 irv_rowspan": ("irv_rowspan", _SRC + "irv.cu",
                       _TPU + "irvkern.py:60", MAIN),
    "B8 irv_rowspan (need)": ("irv_rowspan", _SRC + "irv.cu",
                              _TPU + "irvkern.py:60", MAIN),
    "B9 irv_vote": ("irv_vote", _SRC + "irv.cu", _TPU + "irvkern.py:121",
                    MAIN),
    "B9 irv_vote (need)": ("irv_vote", _SRC + "irv.cu",
                           _TPU + "irvkern.py:121", MAIN),
    "B10 filter_bilateral": ("filter_bilateral", _SRC + "bilateral.cu",
                             _TPU + "postkern.py:48", MAIN),
    "B11 dibr_bleed_mask": ("dibr_bleed_mask", _SRC + "occl.cu",
                            _TPU + "postkern.py:442", MAIN),
    "B7+B11 dibr_occl_masks": ("dibr_occl_masks", _SRC + "occl.cu",
                               _TPU + "postkern.py:255 and :442", MAIN),
    "B12 warp_merge_views": ("warp_merge_views", _SRC + "warp.cu",
                             _TPU + "warpkern.py:340", MAIN),
    "B13 dc_hslo_wta": ("dc_hslo_wta_eyes", _SRC + "hslo.cu",
                        _TPU + "hslokern.py:55", HSLO4K),
    "B13 dc_hslo_wta (right eye, strong penalties)": (
        "dc_hslo_wta_eyes", _SRC + "hslo.cu", _TPU + "hslokern.py:55",
        HSLO4K),
    "B14 warp_views": ("warp_views", _SRC + "warp.cu",
                       _TPU + "warpkern.py:290", HSLO4K),
    "B12 warp_merge_interlace": ("warp_merge_interlace", _SRC + "warp.cu",
                                 _TPU + "warpkern.py:340", MAIN),
    "G1 dibr_feather": ("dibr_feather_mask", _SRC + "feather.cu",
                        _TPU + "filters.py:35", MAIN),
}
# G2, the lowres path's rescales (XLA glue given a kernel): both eyes
# down to 540x960 and both disparities back up to 1080p, each in one
# launch; then at a non-integer ratio, at a 1-row and a 1-column output
# and between 2160x3840 and 1080x1920
G2D = "G2 tx_scale_bilinear_lr (both eyes, 1080p to 540x960)"
G2U = "G2 tx_disp_scale_lr (both eyes, 540x960 to 1080p)"
KERNELS[G2D] = ("tx_scale_bilinear_lr", _SRC + "scale.cu",
                _TPU + "scale.py:76", LOWRES)
KERNELS[G2U] = ("tx_disp_scale_lr", _SRC + "scale.cu", _TPU + "scale.py:91",
                LOWRES)
# suffix -> (the input: the 1080p pair or its 2160x3840 tiling, the output
# rows and columns)
G2D_EDGES = {" (1080p to 400x750: non-integer ratio)": ("1080p", 400, 750),
             " (1080p to 1x960: one row)": ("1080p", 1, 960),
             " (1080p to 540x1: one column)": ("1080p", 540, 1),
             " (2160x3840 to 1080x1920)": ("2160x3840", 1080, 1920)}
# suffix -> (the input: the 540x960 disparities or their 1080p upscale,
# the output rows and columns)
G2U_EDGES = {" (540x960 to 1000x1700: non-integer ratio)": ("low", 1000,
                                                            1700),
             " (540x960 to 1x1920: one row)": ("low", 1, 1920),
             " (540x960 to 1080x1: one column)": ("low", 1080, 1),
             " (1080x1920 to 2160x3840)": ("1080p", 2160, 3840)}
for _suffix in G2D_EDGES:
    KERNELS[G2D[:G2D.index(" (")] + _suffix] = KERNELS[G2D]
for _suffix in G2U_EDGES:
    KERNELS[G2U[:G2U.index(" (")] + _suffix] = KERNELS[G2U]
# the third path gives B1-B10 other shapes (540x960, D=64, zero_disp=32)
# and the synthesis kernels upscaled disparities of twice the range: each
# is held against its plain version there too, under its own entry
AT_LOWRES = " (HD1080_LOWRES shapes)"
KERNELS.update({
    name + AT_LOWRES: (wrapper, source, replaces, LOWRES)
    for name, (wrapper, source, replaces, path) in list(KERNELS.items())
    if path == MAIN})
# ... and at the chunk shapes of the 4K preset
AT_4K = " (UHD4K_16V chunk shapes)"
KERNELS.update({
    name + AT_4K: (wrapper, source, replaces, UHD4K)
    for name, (wrapper, source, replaces, path) in list(KERNELS.items())
    if path == MAIN})
# the lane-major window passes at the shifts of band_digits 2 and 1
for _digits, _path in ((2, DIGITS2), (1, DIGITS1)):
    for _name in ("B4 h_pass_sum (pass 1)", "B5 vv_pass (passes 2+3)",
                  "B6 h_pass_wta (pass 4 + WTA)"):
        _w, _s, _r, _ = KERNELS[_name]
        KERNELS[f"{_name[:-1]}, band_digits={_digits} shifts)"] = (
            _w, _s, _r, _path)
# the streamed vertical passes and vote where the streams meet the
# frame's edges: fewer rows than a ring holds, and reach 0
AT_SHORT = " (37x1001, H < 2*usd + 2)"
AT_REACH0 = " (200x1001, reach 0)"
for _suffix in (AT_SHORT, AT_REACH0):
    for _name in ("B5 vv_pass (passes 2+3)", "B9 irv_vote",
                  "B9 irv_vote (need)"):
        KERNELS[_name + _suffix] = KERNELS[_name]
# B9 where its staged path meets its edges: two groups of bins a lane
# (D=130: the staged kernel built for two), reach 127 (one block an SM, three
# columns a strip), and full only, the whole frame's spans in a volume
# whose base lies 4 bytes past a 16-byte bound (the strip's first bytes
# copied by hand); and where it gives way to its register path (D=1023 at
# reach 50: the rings leave no room for two stages)
AT_V_D130 = " (37x1001, D=130)"
AT_V_REACH127 = " (200x1001, reach 127)"
AT_V_OFF = " (base 4 bytes off 16)"
AT_V_REG = " (200x301, D=1023, reach 50: register path)"
VOTE_EDGES = (AT_V_D130, AT_V_REACH127, AT_V_OFF, AT_V_REG)
for _suffix in VOTE_EDGES:
    for _name in ("B9 irv_vote",) + (("B9 irv_vote (need)",)
                                     if _suffix != AT_V_OFF else ()):
        KERNELS[_name + _suffix] = KERNELS[_name]
# B5 where its staged path (input rows by tensor copies into a ring of
# stages) gives way to its register path (D % 4 != 0, a base off 16
# bytes, a reach past what a slot ring holds) and where a stage is only
# partly filled (fewer rows than a stage holds), and at a reach the
# presets do not take (64: one block an SM)
AT_VP_D130 = " (37x1001, D=130: register path)"
AT_VP_D126 = " (200x1001, D=126: register path)"
AT_VP_OFF = " (200x1001, base one element off 16 bytes: register path)"
AT_VP_REACH64 = " (200x1001, reach 64)"
AT_VP_REACH108 = " (200x1001, reach 108: register path)"
AT_VP_FEW = " (9x1001, H < a stage's 16 rows)"
VP_EDGES = (AT_VP_D130, AT_VP_D126, AT_VP_OFF, AT_VP_REACH64, AT_VP_REACH108,
            AT_VP_FEW)
for _suffix in VP_EDGES:
    KERNELS["B5 vv_pass (passes 2+3)" + _suffix] = KERNELS[
        "B5 vv_pass (passes 2+3)"]
# the streamed horizontal passes where their row streams meet the frame's
# edges and their vector paths end: the crops above (1001 columns, no
# multiple of a segment), a width below one segment, the left-eye view of
# a crop's own pair volume, a D that is no multiple of 4 (scalar loads
# and stores), a D above 128 (two chunks of d a lane), costs that carry
# the u16 prefixes past 2^16, and sums full of ties
HPASS = ("B4 h_pass_sum (pass 1)", "B6 h_pass_wta (pass 4 + WTA)",
         "B6 h_pass_sum (pass 4, no WTA)")
AT_NARROW = " (37x200, W < one segment)"
AT_VIEW = " (200x1001, the pair's left-eye view)"
AT_D126 = " (200x1001, D=126: scalar path)"
AT_D130 = " (37x1001, D=130: two chunks of d)"
AT_WRAP = " (200x1001, costs 240..255: u16 prefixes wrap)"
AT_TIES = " (200x1001, sums full of ties)"
for _suffix, _names in ((AT_SHORT, HPASS), (AT_REACH0, HPASS),
                        (AT_NARROW, HPASS), (AT_VIEW, HPASS[:1]),
                        (AT_D126, HPASS), (AT_D130, HPASS[:2]),
                        (AT_WRAP, HPASS[:1]), (AT_TIES, HPASS[1:2])):
    for _name in _names:
        KERNELS[_name + _suffix] = KERNELS[_name]
# the configuration limits the wrappers once refused: B2 and B3 at a D
# that is no multiple of 4, the warps of 38 intermediate views (more than
# one kernel argument block holds)
AT_VIEWS38 = " (200x1001, 38 views)"
for _suffix, _names in ((AT_D126, ("B2 cost_pair", "B3 shear_right")),
                        (AT_VIEWS38, ("B12 warp_merge_views",
                                      "B14 warp_views"))):
    for _name in _names:
        KERNELS[_name + _suffix] = KERNELS[_name]
# B12's interlace mode, the synthesis of every process_frame path: at the
# 4K output of HSLO_4K (1080p views resampled to 2160x3840), with 38
# views, two views (no merge), on a 37x1001 crop (rows of 3003 bytes: no
# multiple of 16), shrunk to 720x1280, at another angle, and on masks and
# a feather outside [0, 1] (the merges its conversion-free path does not
# take, and u8 products that wrap); the feather
# G1 at radii 0 and 1 beside the presets' 10, on a 37x15 crop (narrower
# and shorter than 2r + 1), and at r = 40 and 70 (above one launch's
# radius of 10: the two-launch passes)
B12I = "B12 warp_merge_interlace"
B12I_HSLO = " (HD1080_D128_HSLO_4K: 1080p to 2160x3840)"
B12I_EDGES = (" (num_views 2: no merge)", " (37x1001 crop, 8 views)",
              " (1080p shrunk to 720x1280)", " (angle 30)",
              " (37x1001, masks and feather outside [0, 1]: the exact path)")
KERNELS[B12I + B12I_HSLO] = (*KERNELS[B12I][:3], HSLO4K)
for _suffix in (AT_VIEWS38, *B12I_EDGES):
    KERNELS[B12I + _suffix] = KERNELS[B12I]
G1_EDGES = {" (r=0)": 0, " (r=1)": 1, " (37x15 crop, r=10)": 10,
            " (200x1001, r=40: two launches)": 40,
            " (200x1001, r=70: two launches)": 70}
for _suffix in G1_EDGES:
    KERNELS["G1 dibr_feather" + _suffix] = KERNELS["G1 dibr_feather"]
# B12's view stack (one launch for every view, rows staged, 16-byte
# stores) where its segments, view loop and stores meet their edges: one
# and 14 intermediate views on the 1080p frame, a 37x1001 crop (rows of
# 3003 bytes: no multiple of 16), W = 1 and 17, masks and a feather
# outside [0, 1] (the exact merge), the crop's views written in place
# into a view stack, whose middle views start 7 bytes past a 16-byte
# boundary, and rows of 40320 pixels (two rows of 121 KB: the gathers read
# device memory)
B12V = "B12 warp_merge_views"
B12V_EDGES = (" (num_views 3: one view)", " (num_views 16: 14 views)",
              " (37x1001 crop, 6 views)", " (37x1, W=1)", " (37x17, W=17)",
              " (37x1001, masks and feather outside [0, 1]: the exact path)",
              " (37x1001, into a view stack: base not 16-byte aligned)",
              " (2x40320: rows wider than shared memory stages)")
for _suffix in B12V_EDGES:
    KERNELS[B12V + _suffix] = KERNELS[B12V]
# the JAX-named entries that no process_frame path calls since the
# synthesis became one kernel, each run as a path of its own on the
# 1080p frame's stages: `synthesize_views` (B12's view stack) and
# `warp_views` (B14)
SYNTH_VIEWS = "synthesize_views HD1080_D128"
SYNTH_VIEWS_40 = "synthesize_views HD1080_D128 num_views=40"
SYNTH_VIEWS_2 = "synthesize_views HD1080_D128 num_views=2"
WARP_VIEWS = "warp_views HD1080_D128"
for _name in [n for n in KERNELS if n.startswith("B12 warp_merge_views")]:
    KERNELS[_name] = (*KERNELS[_name][:3], SYNTH_VIEWS)
for _name in [n for n in KERNELS if n.startswith("B14 warp_views")]:
    KERNELS[_name] = (*KERNELS[_name][:3], WARP_VIEWS)
# the occlusion stage of every path is one launch (B7's hits and B11's
# bleed fused); B7's hits mode and B11's u8 entry run as a path of their
# own beside it (the JAX `dcc_occl_kern` and `filter_bleed_mask_kern`)
OCCL_UNFUSED = "dibr_occl + dibr_bleed_mask HD1080_D128"
for _name in [n for n in KERNELS
              if n.startswith(("B7 dibr_occl", "B11 dibr_bleed_mask"))]:
    KERNELS[_name] = (*KERNELS[_name][:3], OCCL_UNFUSED)
# ... and where their rows, bands and stores meet their edges: a crop of
# odd width, W = 15 (below a 16-byte store), H = 2 (below a band), the
# radii 0, 2, 3 and 10 beside the presets' 1, writers past both borders,
# all-zero disparities, negative fractional ones, the widest rows B7
# stages for the labels' gather (shared memory past 48 KB), a plane past
# the width the old B7 refused (24,576 columns; the gather from device
# memory), and one of 200,000 columns at a radius above the fused
# kernel's r_max there (B7's hits into u8 planes, then B11 on them: two
# launches; B7 takes each row in four segments)
B7B11 = "B7+B11 dibr_occl_masks"
OCCL_CROPS = {" (37x1001 crop)": (37, 1001), " (37x15, W=15)": (37, 15),
              " (2x1001, H=2)": (2, 1001)}
OCCL_RADII = {f" (r={_r})": _r for _r in (0, 2, 3, 10)}
OCCL_DISPS = (" (200x1001, every writer past a border)",
              " (200x1001, all-zero disparities)",
              " (200x1001, negative fractional disparities)")
# (the fused entry's suffix, B7's, rows, columns, radius)
OCCL_WIDE = (
    (" (8x23000: the widest rows staged for the labels)",) * 2
    + (8, 23000, 1),
    (" (8x25000: past the old width limit)",) * 2 + (8, 25000, 1),
    (" (16x200000, r=5: above r_max, two launches)",
     " (16x200000: rows in four segments)", 16, 200000, 5))
for _suffix in (*OCCL_CROPS, *OCCL_RADII, *OCCL_DISPS,
                *(w[0] for w in OCCL_WIDE)):
    KERNELS[B7B11 + _suffix] = KERNELS[B7B11]
for _suffix in (*OCCL_CROPS, *OCCL_DISPS, *(w[1] for w in OCCL_WIDE)):
    KERNELS["B7 dr_dcc (labels)" + _suffix] = KERNELS["B7 dr_dcc (labels)"]
    KERNELS["B7 dibr_occl (hits)" + _suffix] = KERNELS["B7 dibr_occl (hits)"]
B11_EDGES = (" (37x15 crop, values 0, 1, 2)", " (r=3, values 0, 1, 2)")
for _suffix in B11_EDGES:
    KERNELS["B11 dibr_bleed_mask" + _suffix] = KERNELS["B11 dibr_bleed_mask"]
# B1 on both eyes where its threshold compare and its staged cross meet
# their edges: fractional thresholds that bf16 would round up (the JAX
# Pallas kernel's difference from the reference), thresholds past 255 (no
# step fails) and below 0 (every step fails), usd = lsd (no second tier),
# and usd above a crop's height (the walks stop at both borders)
B1_EDGES = {
    " (ucd 5.99, lcd 19.97: thresholds bf16 rounds up)": (5.99, 19.97, None),
    " (ucd 255, lcd 300: no step fails)": (255.0, 300.0, None),
    " (ucd -1, lcd -0.5: every step fails)": (-1.0, -0.5, None),
    " (usd = lsd = 34)": (None, None, 34),
}
B1_SHORT = " (37x1001, usd 40 above the height)"
for _suffix in (*B1_EDGES, B1_SHORT):
    KERNELS["B1 cross_arms" + _suffix] = KERNELS["B1 cross_arms"]
# B2 on row ranges of a frame, whose census must clamp at the frame's
# edges only: the third row chunk of the 4K preset's stereo core (rows
# 1012-1691 of 2160, as band_stereo_core_chunked stages it); and B2 at a
# D above 128 (9 groups of 16 disparities), and one eye at D=126 (the
# scalar stores, both signs)
B2_CHUNK4K = " (UHD4K_16V frame rows 1012-1691: the third chunk)"
B2_D130 = " (37x1001, D=130)"
KERNELS["B2 cost_pair" + B2_CHUNK4K] = (*KERNELS["B2 cost_pair"][:3], UHD4K)
KERNELS["B2 cost_pair" + B2_D130] = KERNELS["B2 cost_pair"]
# B13 where its segments, ring and lanes meet their edges: both eyes in
# one launch (as the HSLO path calls it) against the plain version and two
# one-eye launches; a 37x1001 crop of the frame's own pass-4 volume, and
# widths of one column, below two segments and one column past them; D=30
# (one d a lane), D=126 (no multiple of 4: scalar copies) and D=130 (eight
# d a lane) on both signs; a volume of equal costs (the first-min rule on
# ties everywhere) and one of 0/7 costs (ties after the scan); penalties
# of zero and above every cost
B13_LR = " (both eyes, one launch)"
B13_EDGES = (" (37x1001 crop)", " (37x1, W=1)", " (37x15, W=15)",
             " (37x17, W=17)", " (200x1001, D=30, right eye)",
             " (200x1001, D=126, right eye)", " (37x1001, D=130)",
             " (37x1001, D=130, right eye)", " (200x1001, equal costs)",
             " (200x1001, 0/7 costs: ties)",
             " (200x1001, zero penalties)",
             " (200x1001, penalties above every cost)")
for _suffix in (B13_LR, *B13_EDGES):
    KERNELS["B13 dc_hslo_wta" + _suffix] = KERNELS["B13 dc_hslo_wta"]
# B3 where its streamed ring meets its edges: zd = 0 and zd = D (the ring
# reaches to one side only), W below one ring tile, D=130 (scalar path,
# two chunks) and D=132 (streamed, a second chunk of 4 d), the 4K preset's
# third row chunk, and int16 and float32 at zd = 0 and W below one tile
B3_EDGES = (" (200x1001, zd=0)", " (200x1001, zd=D)", " (37x20, W < one tile)",
            " (37x1001, D=130: scalar path)",
            " (37x1001, D=132: a second chunk of 4 d)",
            " (int16, 200x1001, zd=0)", " (int16, 37x20, W < one tile)",
            " (float32, 200x1001, zd=D)", " (float32, 37x20, W < one tile)")
for _suffix in B3_EDGES:
    KERNELS["B3 shear_right" + _suffix] = KERNELS["B3 shear_right"]
KERNELS["B3 shear_right" + B2_CHUNK4K] = (*KERNELS["B3 shear_right"][:3],
                                          UHD4K)
# the disparity-major core, whole-frame and at a 540-row chunk's extent
AT_CHUNK = " (680-row chunk)"
DM_KERNELS = {
    "B16 cost_dm (stacked u8)": ("cost_dm", _SRC + "cost_dm.cu",
                                 _TPU + "costkern.py:57", DM),
    "B16 ci_adcensus_kern (row-major pair u8)": (
        "cost_dm", _SRC + "cost_dm.cu", _TPU + "costkern.py:57", DM),
    "B16 ci_adcensus_kern (row-major pair float32)": (
        "cost_dm", _SRC + "cost_dm.cu", _TPU + "costkern.py:57", DM),
    "B18a pass1_dm": ("pass1_dm", _SRC + "band_dm.cu", _TPU + "band.py:832",
                      DM),
    "B18b vv_dm (passes 2+3)": ("vv_dm", _SRC + "vvdm.cu",
                                _TPU + "band.py:853", DM),
    "B18c pass4_wta_dm": ("pass4_wta_dm", _SRC + "band_dm.cu",
                          _TPU + "band.py:909", DM),
    "B18c pass4_wta_dm (tied planes)": (
        "pass4_wta_dm", _SRC + "band_dm.cu", _TPU + "band.py:909", DM),
}
KERNELS.update(DM_KERNELS)
# ... on a width that is no multiple of 4, where rows are not aligned for
# the horizontal passes' vector loads and stores, and on a 680-row chunk
# of the 4K preset (3840 columns)
AT_ODD = " (200x1001, unaligned rows)"
for _suffix, _path in ((AT_CHUNK, DM_CHUNKED), (AT_ODD, DM), (AT_4K, DM_4K)):
    KERNELS.update({
        name + _suffix: (wrapper, source, replaces, _path)
        for name, (wrapper, source, replaces, path) in DM_KERNELS.items()
        if name in ("B16 cost_dm (stacked u8)", "B18a pass1_dm",
                    "B18b vv_dm (passes 2+3)", "B18c pass4_wta_dm")})
# B16, which computes the census of its row range itself, where its
# staged rows, lanes, rings and stores meet their edges: the last 540-row
# chunk of the 1080p frame and the 4K frame's third chunk (census rows
# outside the range, clamped at the frame's edges only), 37 rows at W =
# 1, 15 and 17 (one partial group of 16 columns), D = 30 (one partial
# group of 32 planes), D = 256 at zd = 128 (the widest reach both ways),
# zd = 0 (a reach to one side), float32 on a chunk, and the right-eye
# strips at M = 1 (one column a side: scalar stores)
B16 = "B16 cost_dm (stacked u8)"
B16_EDGES = (" (1080p frame rows 400-1079: the last 540-row chunk)",
             " (37x1, W=1)", " (37x15, W=15)", " (37x17, W=17)",
             " (200x1001, D=30)", " (200x1001, D=256, zd=128)",
             " (200x1001, zd=0)", " (float32, 680-row chunk)")
for _suffix in B16_EDGES:
    KERNELS[B16 + _suffix] = KERNELS[B16]
KERNELS[B16 + B2_CHUNK4K] = (*KERNELS[B16][:3], DM_4K)
B16_STRIPS = "B16 cost_dm (right-eye strips u8, one launch)"
B16_M1 = " (1080p, M=1: one column a side)"
# B18b where its streams, rings and batches meet their edges: reach 0
# (rings of two slots) and 64, 37 rows (fewer than a ring holds), D = 30
# (plane groups that do not fill a block), and inputs whose rescaled
# pass-2 sums reach and pass the int16 ceiling (they wrap, as the plain
# version's cast does); arms drawn past [0, reach] to test the clamp
VDM_EDGES = (" (200x1001, reach 0)", " (200x1001, reach 64)", " (37x1001)",
             " (200x1001, D=30)",
             " (200x1001, pass-2 sums at the int16 ceiling)")
for _suffix in VDM_EDGES:
    KERNELS["B18b vv_dm (passes 2+3)" + _suffix] = KERNELS[
        "B18b vv_dm (passes 2+3)"]
# B18a and B18c where their segments, lanes and loads meet their edges:
# reach 0 and 64 (a left halo of 0 and 64 columns), 37 rows, W = 1, 15 and
# 17 (fewer columns than a segment) and 1001 (rows not aligned for 16-byte
# loads), D = 30 (plane groups that do not fill a block) on unaligned and
# on aligned rows, D = 261 (B18a: a last step of one plane; B18c: 64-bit
# keys), a volume whose base is one element off 16 bytes, arms drawn from
# -2 to 5 past the reach to test the clamp; for B18c also inputs of
# 30000..32767 under arms of 64 (window sums past 2^21) and tied planes
HDM_EDGES = (" (200x1001, reach 0)", " (200x1001, reach 64)", " (37x1001)",
             " (37x1, W=1)", " (37x15, W=15)", " (37x17, W=17)",
             " (200x1001, D=30)", " (200x1920, D=30)", " (37x1001, D=261)",
             " (200x1920, base one element off)")
HDM_C_EDGES = (" (200x1001, sums past 2^21)", " (200x1920, sums past 2^21)",
               " (200x1001, tied planes)")
for _suffix in HDM_EDGES:
    for _name in ("B18a pass1_dm", "B18c pass4_wta_dm"):
        KERNELS[_name + _suffix] = KERNELS[_name]
for _suffix in HDM_C_EDGES:
    KERNELS["B18c pass4_wta_dm" + _suffix] = KERNELS["B18c pass4_wta_dm"]
# the entry points the JAX package's tests and scripts drive beside
# process_frame: B15 under dr_irv_band_lr, B16's one-eye modes and B17
# under ci_adcensus_kern(shift_extract=True), B19/B20 under the row-major
# bounded warps
IRV_BAND = "dr_irv_band_lr HD1080_D128"
SHIFT_X = "ci_adcensus_kern shift_extract HD1080_D128"
SHIFT_X_F32 = SHIFT_X + " float32"
WARP_RM = "dibr_warp_views_kern HD1080_D128"
# band_span_sum_h/_v called directly on a float volume of one eye, as the
# JAX package's tests and scripts call them: one path for each nsplit
SPAN_FLOAT = {n: f"band_span_sum float nsplit={n} HD1080_D128"
              for n in (3, 2)}
SPAN_KERNELS = {
    f"B15 band_span_sum_{a} ({what})": (
        f"band_span_sum_{a}", _SRC + "span.cu", _TPU + "band.py:150", path)
    for what, path in (("stacked one-hot, nsplit=1, inclusive", IRV_BAND),
                       ("float, nsplit=3", SPAN_FLOAT[3]),
                       ("float, nsplit=2", SPAN_FLOAT[2])) for a in "hv"}
SHIFT_KERNELS = {
    "B16 cost_dm (left eye u8)": ("cost_dm", _SRC + "cost_dm.cu",
                                  _TPU + "costkern.py:57", SHIFT_X),
    "B16 cost_dm (right-eye strip u8)": ("cost_dm", _SRC + "cost_dm.cu",
                                         _TPU + "costkern.py:57", SHIFT_X),
    "B16 cost_dm (left eye float32)": ("cost_dm", _SRC + "cost_dm.cu",
                                       _TPU + "costkern.py:57", SHIFT_X_F32),
    "B17 shear_right_dm (u8)": ("shear_right_dm", _SRC + "shear_dm.cu",
                                _TPU + "costkern.py:147", SHIFT_X),
    "B17 shear_right_dm (float32)": ("shear_right_dm", _SRC + "shear_dm.cu",
                                     _TPU + "costkern.py:147", SHIFT_X_F32),
}
SHIFT_KERNELS[B16_STRIPS] = (
    "cost_dm", _SRC + "cost_dm.cu", _TPU + "costkern.py:57", SHIFT_X)
KERNELS.update(SPAN_KERNELS)
KERNELS.update(SHIFT_KERNELS)
KERNELS[B16_STRIPS + B16_M1] = KERNELS[B16_STRIPS]
for _name in ("B15 band_span_sum_h (float, nsplit=3)",
              "B15 band_span_sum_v (float, nsplit=3)", *SHIFT_KERNELS):
    KERNELS[_name + AT_ODD] = KERNELS[_name]
# B15 where its tiles, windows and lanes meet their edges, each along x and
# y: max_arm 0 and 64, lines shorter than one window (on integers, the
# prefix blocks, and on a float crop, the term-by-term walk), D = 1, 30
# and 130
# (no multiple of a block's 32 d), every nsplit, inclusive and half-open
# windows, integer volumes (the blocks that take prefix differences) up to
# and one past their bound, and a volume of +-inf, NaN, -0.0 and
# cancelling magnitudes (1e8, 1, -1e8), where the order of the adds shows
# (each held bit for bit, the sign of a zero included)
SPAN_EDGES = {
    " (200x1001, max_arm=0, inclusive, nsplit=3)": 3,
    " (200x1001, max_arm=64, nsplit=2)": 2,
    " (37x100, max_arm=64: lines shorter than a window, integers, "
    "inclusive, nsplit=1)": 1,
    " (37x100, max_arm=64: lines shorter than a window, float, "
    "nsplit=2)": 2,
    " (200x1001, D=1, inclusive, nsplit=1)": 1,
    " (200x1001, D=30, nsplit=2)": 2,
    " (200x1001, D=130, integers to 2^15 and some 32769, inclusive, "
    "nsplit=3)": 3,
    **{f" (200x1001, +-inf, NaN, -0.0, 1e8 / 1 / -1e8, nsplit={_n})": _n
       for _n in (1, 2, 3)},
}
SPAN_BASE = {1: "stacked one-hot, nsplit=1, inclusive", 2: "float, nsplit=2",
             3: "float, nsplit=3"}
for _suffix, _n in SPAN_EDGES.items():
    for _a in "hv":
        KERNELS[f"B15 band_span_sum_{_a}" + _suffix] = KERNELS[
            f"B15 band_span_sum_{_a} ({SPAN_BASE[_n]})"]
KERNELS.update({
    "B19 dibr_warp_views_kern": ("dibr_warp_views_kern", _SRC + "warp.cu",
                                 _TPU + "warpkern.py:94", WARP_RM),
    "B19 dibr_warp_views_kern (disparities outside [-64, 64])": (
        "dibr_warp_views_kern", _SRC + "warp.cu", _TPU + "warpkern.py:94",
        WARP_RM),
    "B20 dibr_warp_pair_kern": ("dibr_warp_pair_kern", _SRC + "warp.cu",
                                _TPU + "warpkern.py:66", WARP_RM),
})
KERNELS["B19 dibr_warp_views_kern" + AT_VIEWS38] = KERNELS[
    "B19 dibr_warp_views_kern"]
# B19 (one launch for every view, rows staged, 16-byte stores) where its
# segments, view loop and stores meet their edges: the 4K frame with 14
# views, a 37x1001 crop (no row 16-byte aligned at a segment's start but
# every fourth), W = 1, 15 and 17, and disparities of +-64 that clamp c
# at both ends of a row; B20 at the shifts 0 and 1 (a warp of shift 0,
# bounds (0, 0))
B19 = "B19 dibr_warp_views_kern"
B19_4K = " (2160x3840, 14 views)"
B19_EDGES = (" (37x1001 crop)", " (37x1, W=1)", " (37x15, W=15)",
             " (37x17, W=17)",
             " (200x1001, disparities +-64 that clamp c at both row ends)")
B20_SHIFTS = {" (shift 0)": 0.0, " (shift 1)": 1.0}
for _suffix in (B19_4K, *B19_EDGES):
    KERNELS[B19 + _suffix] = KERNELS[B19]
for _suffix in B20_SHIFTS:
    KERNELS["B20 dibr_warp_pair_kern" + _suffix] = KERNELS[
        "B20 dibr_warp_pair_kern"]
# B17 u8 where its paths meet their edges: rows of 4-byte words (W =
# 1004, the 4-byte path), of bytes (W = 1, 15, 17), the shifts of one sign
# (zd = 0: every s >= 0; zd = D: every s < 0), one plane, and the 4K
# preset's chunk shape
B17U8 = "B17 shear_right_dm (u8)"
B17_EDGES = (" (200x1004: 4-byte words)", " (37x1, W=1)", " (37x15, W=15)",
             " (37x17, W=17)", " (zd=0)", " (zd=D)", " (D=1)",
             " (128x680x3840, a 4K chunk's shape)")
for _suffix in B17_EDGES:
    KERNELS[B17U8 + _suffix] = KERNELS[B17U8]
# the band engine's dials: band_qscale (int16 costs above 127.5) and
# band_lossy_wta (pass 4's inputs rounded to bf16), each as a path of
# process_frame, and the band engine's cost entry `ci_adcensus_kern_xm`
# in each cost mode, with shear (B2's pair volume, B3) and without (B2
# once an eye, directly)
QSCALE510 = "HD1080_D128 band_qscale=510"
LOSSY = "HD1080_D128 band_lossy_wta"
DIAL_MODES = (("u8", 127.0, True), ("int16", 510.0, True),
              ("float32", 127.0, False))
XM_PAIR = {m: f"ci_adcensus_kern_xm HD1080_D128 {m}" for m, _, _ in DIAL_MODES}
XM_EYES = {m: f"ci_adcensus_kern_xm shear=False HD1080_D128 {m}"
           for m, _, _ in DIAL_MODES}
B2_SRC = ("cost_pair", _SRC + "cost.cu", _TPU + "costkern.py:279")
B3_SRC = ("shear_right", _SRC + "shear.cu", _TPU + "costkern.py:342")
B4I = "B4 h_pass_sum (pass 1, int16 costs)"
B6L = "B6 h_pass_wta (pass 4 + lossy WTA)"
B4I_SRC = ("h_pass_sum", _SRC + "hpass.cu", _TPU + "band.py:150")
B6L_SRC = ("h_pass_wta", _SRC + "hpass.cu", _TPU + "band.py:150")
DIAL_PAIRS = {"int16, qscale 510": QSCALE510, "float32": XM_PAIR["float32"]}
for _label, _path in DIAL_PAIRS.items():
    KERNELS[f"B2 cost_pair (pair, {_label})"] = (*B2_SRC, _path)
    KERNELS[f"B3 shear_right ({_label})"] = (*B3_SRC, _path)
for _mode, _, _ in DIAL_MODES:
    for _side in ("left", "right"):
        KERNELS[f"B2 cost_pair ({_side} eye {_mode}, direct)"] = (
            *B2_SRC, XM_EYES[_mode])
for _digits in (3, 2, 1):
    KERNELS[f"{B4I[:-1]}, qscale=510 band_digits={_digits} shifts)"] = (
        *B4I_SRC, QSCALE510)
    KERNELS[f"{B6L[:-1]}, band_digits={_digits} shifts)"] = (*B6L_SRC, LOSSY)
# ... and where their streams and vector paths end: a 37-row crop, D=126
# (scalar loads and stores), int16 costs whose windows pass 2^16, and
# inputs that the bf16 rounding turns into ties
AT_I16MAX = " (200x1001, int16 costs 32000..32767: windows past 2^16)"
for _suffix in (AT_SHORT, AT_D126):
    KERNELS[B4I + _suffix] = (*B4I_SRC, QSCALE510)
    KERNELS[B6L + _suffix] = (*B6L_SRC, LOSSY)
for _label, _path in DIAL_PAIRS.items():
    KERNELS[f"B2 cost_pair (pair, {_label})" + AT_D126] = (*B2_SRC, _path)
    KERNELS[f"B3 shear_right ({_label})" + AT_D126] = (*B3_SRC, _path)
for _side in ("left", "right"):
    KERNELS[f"B2 cost_pair ({_side} eye u8, direct)" + AT_D126] = (
        *B2_SRC, XM_EYES["u8"])
KERNELS[B4I + AT_I16MAX] = (*B4I_SRC, QSCALE510)
KERNELS[B6L + AT_TIES] = (*B6L_SRC, LOSSY)
# B8 where its row streams end and its byte prefixes wrap, full and gated:
# the 37-row and reach-0 crops above, an odd W, D=126 (B + 1 = 127: the
# pixels of the volume lie at every alignment), reach 127 with every
# reliable pixel in one bin (windows of 255: the byte prefixes wrap) and
# D=130 (more than 128 bins: the kernel with two groups a lane)
RS_ODD = " (200x1001, odd W)"
RS_D126 = " (200x1000, D=126: B + 1 = 127)"
RS_WRAP = " (200x1001, reach 127: windows of 255 in one bin)"
RS_D130 = " (37x1001, D=130: two groups a lane)"
for _suffix in (AT_SHORT, AT_REACH0, RS_ODD, RS_D126, RS_WRAP, RS_D130):
    for _name in ("B8 irv_rowspan", "B8 irv_rowspan (need)"):
        KERNELS[_name + _suffix] = KERNELS[_name]
# B8 and B9 in every round of the pipeline's early-stop loop on the 1080p
# frame (HD1080_D128's irv_iterations; the bud frame runs all five):
# round 1 full, each later round under its own frontier
IRV_ROUNDS = 5


def irv_round_suffix(k: int) -> str:
    return f" (round {k} of dr_irv_early_stop)"


for _k in range(1, IRV_ROUNDS + 1):
    for _name in (("B8 irv_rowspan", "B9 irv_vote") if _k == 1 else
                  ("B8 irv_rowspan (need)", "B9 irv_vote (need)")):
        KERNELS[_name + irv_round_suffix(_k)] = KERNELS[_name]
# G3, the frontier between IRV rounds (XLA glue given a kernel): on the
# left eye's labels before and after round 1 at the main and lowres
# paths' shapes and on the 4K preset's whole frame (its frontier is
# frame-wide), after each of rounds 1-4 of the early-stop loop on the
# 1080p frame, and at its edges: frames of 1 x 1, 1 x 45 and 45 x 1
# pixels, 37x1001 (byte loads) and 200x1008 (16-byte loads, partial
# tiles) at usd 0, 1, 7, 8, 34 and 127, each on no change, every pixel
# changed, one change at each corner and sparse changes; and planes one
# byte off 16 (byte loads on a 16-byte row)
G3 = "G3 irv_frontier"
_G3_SRC = ("irv_frontier", _SRC + "irv.cu", _TPU + "band.py:1238")
KERNELS[G3] = (*_G3_SRC, MAIN)
KERNELS[G3 + AT_LOWRES] = (*_G3_SRC, LOWRES)
G3_4K = " (UHD4K_16V frame, 2160x3840)"
KERNELS[G3 + G3_4K] = (*_G3_SRC, UHD4K)
for _k in range(1, IRV_ROUNDS):
    KERNELS[G3 + irv_round_suffix(_k)] = KERNELS[G3]
G3_EDGES = {f" ({_h}x{_w}, usd {_usd})": (_h, _w, _usd)
            for _h, _w in ((1, 1), (1, 45), (45, 1), (37, 1001), (200, 1008))
            for _usd in (0, 1, 7, 8, 34, 127)}
G3_OFF16 = " (200x1008, usd 34, planes one byte off 16)"
for _suffix in (*G3_EDGES, G3_OFF16):
    KERNELS[G3 + _suffix] = KERNELS[G3]
# B10 at the radii 0, 1 and 8 beside the main path's 7, on a 37-row crop,
# on fractional values over +-1000 (range-weight indices past the table:
# the direct expression) and where |a - s| falls on integers and one ulp
# below them (where the floor changes)
B10_EDGES = {f" (r={_r})": _r for _r in (0, 1, 8)}
B10_CROP = " (37x1001)"
B10_FRAC = " (200x1001, fractional values in [-1000, 1000))"
B10_ULP = " (200x1001, |a - s| on and one ulp below integers)"
for _suffix in (*B10_EDGES, B10_CROP, B10_FRAC, B10_ULP):
    KERNELS["B10 filter_bilateral" + _suffix] = KERNELS["B10 filter_bilateral"]
# the wrappers each path must not launch (its route replaces them); every
# other wrapper must launch at least once on it
DM_WRAPPERS = {"cost_dm", "pass1_dm", "vv_dm", "pass4_wta_dm"}
LANE_CORE_WRAPPERS = {"cost_pair", "shear_right", "h_pass_sum", "vv_pass",
                      "h_pass_wta"}
SIDE_WRAPPERS = {"band_span_sum_h", "band_span_sum_v", "shear_right_dm",
                 "dibr_warp_views_kern", "dibr_warp_pair_kern"}
# (B13's wrapper is `dc_hslo_wta_eyes`; `dc_hslo_wta` is its name in an
# older checkout's package, which `--frames` may time)
HSLO_WRAPPERS = {"dc_hslo_wta_eyes", "dc_hslo_wta"}
# the synthesis is one kernel (B12's interlace mode) on every path: the
# view-stack and warp-volume kernels run on none; nor do B7's hits mode
# and B11's u8 entry, which the fused occlusion stage replaces
VIEW_WRAPPERS = {"warp_merge_views", "warp_views"}
UNFUSED_OCCL = {"dibr_occl", "dibr_bleed_mask"}
SYNTH_SIDE = VIEW_WRAPPERS | UNFUSED_OCCL
# the rescales (G2) run on the lowres path alone
G2_WRAPPERS = {"tx_scale_bilinear_lr", "tx_disp_scale_lr"}
NOT_ON_PATH = {
    MAIN: (SYNTH_SIDE | HSLO_WRAPPERS | DM_WRAPPERS | SIDE_WRAPPERS
           | G2_WRAPPERS),
    HSLO4K: ({"h_pass_wta"} | SYNTH_SIDE | DM_WRAPPERS | SIDE_WRAPPERS
             | G2_WRAPPERS),
    LOWRES: SYNTH_SIDE | HSLO_WRAPPERS | DM_WRAPPERS | SIDE_WRAPPERS,
}
for _path in (DIGITS2, DIGITS1, UHD4K, QSCALE510, LOSSY):
    NOT_ON_PATH[_path] = NOT_ON_PATH[MAIN]
# `h_pass_sum` counts two entry points of hpass.cu: pass 1 (u8, both eyes)
# on every path, and pass 4 without the WTA (int32, both eyes) where the
# scanline optimisation runs.  The exact count shows that both launched.
# `vv_pass` launches its kernel once a call: once an eye and row chunk.
# B1 launches once a frame for both eyes, B2 once a row chunk with the
# whole frame's images (it computes the census: no torch census runs),
# B13 once a row chunk for both eyes; B7's labels, the occlusion stage
# (both eyes' hits and bleed masks), the feather and the synthesis
# kernel once a frame.
EXACT_LAUNCHES = {
    MAIN: {"h_pass_sum": 2, "vv_pass": 2},
    HSLO4K: {"h_pass_sum": 4, "vv_pass": 2, "dc_hslo_wta_eyes": 1},
    LOWRES: {"h_pass_sum": 2, "vv_pass": 2, "tx_scale_bilinear_lr": 1,
             "tx_disp_scale_lr": 1},
    DIGITS2: {"h_pass_sum": 2, "vv_pass": 2},
    DIGITS1: {"h_pass_sum": 2, "vv_pass": 2},
    UHD4K: {"h_pass_sum": 8, "vv_pass": 8,      # 4 row chunks x 2 eyes
            "cost_pair": 4},
    QSCALE510: {"h_pass_sum": 2, "vv_pass": 2},
    LOSSY: {"h_pass_sum": 2, "vv_pass": 2},
}
for _path, _counts in EXACT_LAUNCHES.items():
    # every IRV round is queued, settled or not: 5 an eye (a row chunk)
    _counts["irv_rowspan"] = _counts["irv_vote"] = (
        20 if _path == UHD4K else 10)
    _counts["cross_arms_eyes"] = 1
    _counts.setdefault("cost_pair", 1)
    _counts["warp_merge_interlace"] = 1
    _counts["dibr_feather_mask"] = 1
    _counts["dr_dcc"] = 1
    _counts["dibr_occl_masks"] = 1
    # G3 after each round but the last, an eye (frame-wide at 4K too)
    _counts["irv_frontier"] = 8
# every B5 launch of every preset and dial path takes the staged path
# (`vv_pass.staged`): D = 128 or 64, reach 34, buffers of torch.empty
EXACT_STAGED = {_path: _counts["vv_pass"]
                for _path, _counts in EXACT_LAUNCHES.items()}
# the XLA engine (engine="xla"): B1's arms, B7's labels, B8/B9 and G3 in
# the IRV rounds and the fused occlusion stage; the band core (B2-B6,
# B13), the band bilateral B10, the feather G1 and B12 do not launch (its
# cost, aggregation, WTA, XLA-order bilateral, feather, bounded warps and
# interlace are plain torch, as the JAX package computes them outside any
# Pallas kernel)
XLA = "HD1080_D128 engine=xla"
NOT_ON_PATH[XLA] = (LANE_CORE_WRAPPERS | HSLO_WRAPPERS | DM_WRAPPERS
                    | SIDE_WRAPPERS | SYNTH_SIDE | G2_WRAPPERS
                    | {"filter_bilateral", "dibr_feather_mask",
                       "warp_merge_interlace"})
EXACT_LAUNCHES[XLA] = {"cross_arms_eyes": 1, "dr_dcc": 1,
                       "dibr_occl_masks": 1, "irv_rowspan": 10,
                       "irv_vote": 10, "irv_frontier": 8}

# ---- phase 6, sharding over torch.distributed -------------------------
# Ranks that time-share the one card over gloo (the launch module, one
# process each), and NCCL as a world of one.  Every sharded path runs in
# the ranks; its launch counts are zeroed just before its counted frame
# and read just after, in every rank of its mesh.
SHARD_RANKS = 4
HALO2 = "halo_process_frame HD1080_D128 2 ranks"
HALO4 = "halo_process_frame HD1080_D128 4 ranks"
HALO4K_ROW = "halo_process_frame UHD4K_16V 2 ranks"
HALO4K_2D = "halo_process_frame UHD4K_16V (2, 2) row x view"
HALO_HSLO = "halo_process_frame HD1080_D128_HSLO_4K use_median=False 2 ranks"
DISP4 = "disp_sharded_disparities HD1080_D128 4 ranks"
DISP4_FRAME = "disp_sharded_process_frame HD1080_D128 4 ranks"
DISP4_HSLO = "disp_sharded_disparities HD1080_D128_HSLO_4K 4 ranks"
XLA_HALO = "halo_process_frame engine=xla 96x64 4 ranks"
XLA_SHARDED = "sharded_process_frame 96x64 4 ranks"
NCCL1 = "halo_process_frame HD1080_D128 NCCL world of one"
# what each sharded path must launch (every wrapper listed at least once
# in every rank) and must not
_HALO_BAND = {"cross_arms_eyes", "cost_pair", "shear_right", "h_pass_sum",
              "vv_pass", "h_pass_wta", "dr_dcc", "irv_rowspan", "irv_vote",
              "filter_bilateral", "dibr_occl", "dibr_bleed_mask",
              "dibr_feather_mask", "warp_merge_views"}
_HALO_NOT = {"dibr_occl_masks", "warp_merge_interlace", "warp_views"}
_DISP_CORE = {"cross_arms_eyes", "h_pass_sum", "vv_pass"}
SHARD_LAUNCHES = {
    HALO2: (_HALO_BAND, _HALO_NOT),
    HALO4: (_HALO_BAND, _HALO_NOT),
    HALO4K_ROW: (_HALO_BAND, _HALO_NOT),
    HALO4K_2D: (_HALO_BAND - {"warp_merge_views"},
                _HALO_NOT | {"warp_merge_views"}),
    HALO_HSLO: (_HALO_BAND - {"h_pass_wta"} | {"dc_hslo_wta_eyes"},
                _HALO_NOT | {"h_pass_wta"}),
    DISP4: (_DISP_CORE, {"cost_pair", "h_pass_wta"}),
    DISP4_FRAME: (_DISP_CORE | {"dr_dcc", "irv_rowspan", "irv_vote",
                                "dibr_occl_masks"},
                  {"cost_pair", "h_pass_wta", "filter_bilateral"}),
    DISP4_HSLO: (_DISP_CORE | {"dc_hslo_wta_eyes"},
                 {"cost_pair", "h_pass_wta"}),
    XLA_HALO: ({"cross_arms_eyes", "dr_dcc", "irv_rowspan", "irv_vote",
                "dibr_occl", "dibr_bleed_mask"},
               {"cost_pair", "filter_bilateral", "dibr_feather_mask",
                "warp_merge_views", "warp_views"}),
    NCCL1: (_HALO_BAND, _HALO_NOT),
}
SHARD_LAUNCHES[XLA_SHARDED] = SHARD_LAUNCHES[XLA_HALO]
# B1's halo-shard mode: extended row shards (the shard's rows and the
# image halo of 3 * usd rows, edge rows replicated outside the frame) of
# the 1080p frame at 2 and 4 row shards, of the 4K frame, at usd 34 and
# 64; its launches are the 2-rank 1080p halo path's
B1_HALO = {
    f" (halo-shard mode: {pos} of {n}, 1080p, usd {usd})": (n, i, usd, MAIN)
    for n, shards in ((2, (("top", 0), ("bottom", 1))),
                      (4, (("top", 0), ("middle", 1), ("bottom", 3))))
    for pos, i in shards for usd in (34,)}
B1_HALO.update({
    " (halo-shard mode: middle of 4, UHD4K_16V, usd 34)": (4, 1, 34, UHD4K),
    " (halo-shard mode: top of 4, 1080p, usd 64)": (4, 0, 64, MAIN),
    " (halo-shard mode: middle of 4, 1080p, usd 64)": (4, 1, 64, MAIN)})
for _suffix in B1_HALO:
    _w, _s, _r, _ = KERNELS["B1 cross_arms"]
    KERNELS["B1 cross_arms" + _suffix] = (_w, _s, _r, HALO2)


class SmokeFailure(Exception):
    pass


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi gave no output")


def up3(img):
    """Host-side bilinear 3x upscale of an (H, W, 3) u8 image."""
    import numpy as np
    h, w = img.shape[:2]
    out = img.astype(np.float32)
    for ax, n in ((0, h), (1, w)):
        s = np.minimum(np.arange(3 * n, dtype=np.float32) / 3.0,
                       np.float32(n - 1))
        i0 = np.floor(s).astype(np.int64)
        i1 = np.minimum(i0 + 1, n - 1)
        f = (s - i0)[(slice(None), None, None) if ax == 0
                     else (None, slice(None), None)]
        out = (np.take(out, i0, axis=ax) * (1.0 - f)
               + np.take(out, i1, axis=ax) * f)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def stereo_sbs(rows: int, cols: int):
    """SBS frame from the bundled bud stereo pair (bud_2 = left, bud_3 =
    right, 384x640), upscaled 3x (bilinear) and tiled/cropped to (rows,
    2*cols, 3).  The bundled fish_1/fish_2 are one and the same image: as
    a pair they have zero disparity and no outlier anywhere."""
    import numpy as np
    from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

    def fit(name):
        img = up3(read_bmp(os.path.join(HERE, "tests", "data", name)))
        reps = (-(-rows // img.shape[0]), -(-cols // img.shape[1]), 1)
        return np.tile(img, reps)[:rows, :cols]

    return np.concatenate([fit("bud_2.bmp"), fit("bud_3.bmp")], axis=1)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, reps: int) -> float:
    """Device ms a call of `fn`, its `reps` calls captured in one CUDA
    graph and replayed: no host time between the launches, for kernels
    shorter than their wrapper's host overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, ops_rate: float = PEAK_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelChecks:
    """Phase 2: each kernel against its plain version on the same inputs,
    bit equality required; times kernel (with `graph`, replayed from a
    CUDA graph: device time only), plain version and, where one exists,
    one PyTorch library call computing the same function."""

    def __init__(self, reps: int):
        self.reps = reps
        self.results = {}
        self.irv = {}
        self.irv_shares = {}
        self.irv_rounds = {}
        self.suffix = ""    # appended to every recorded name
        self.raw = None     # (disp_l, disp_r, labels) of check_disp_kernels

    def record(self, name, got, ref, kern, plain, nbytes, ops, library=None,
               plain_once=False, ops_rate=PEAK_OPS_PER_S, graph=False,
               bits=False, events=False):
        """With `bits`, float32 outputs must agree in every bit (the sign
        of a zero too) but a NaN's payload: NaN where the plain version
        has NaN.  With `graph` and `events`, the calls' CUDA-event time
        (the wrapper's host time included) beside their device time, as
        `event_ms`."""
        import torch
        name += self.suffix
        torch.cuda.synchronize()
        pairs = (list(zip(got, ref)) if isinstance(got, tuple)
                 else [(got, ref)])
        err = 0.0
        for i, (g, r) in enumerate(pairs):
            if g.shape != r.shape or g.dtype != r.dtype:
                raise SmokeFailure(f"{name}: kernel output {i} is "
                                   f"{tuple(g.shape)} {g.dtype}, plain "
                                   f"{tuple(r.shape)} {r.dtype}")
            if bits:
                nan = torch.isnan(r)
                differ = ((g.view(torch.int32) != r.view(torch.int32))
                          & ~(nan & torch.isnan(g)))
                if bool(differ.any()):
                    first = [int(j) for j in differ.nonzero()[0]]
                    raise SmokeFailure(
                        f"{name}: kernel output {i} != plain version in "
                        f"{int(differ.sum())} elements' bits, first at "
                        f"{first} ({float(g[tuple(first)])} against "
                        f"{float(r[tuple(first)])})")
                continue
            e = float((g.to(torch.float64) - r.to(torch.float64))
                      .abs().max())
            if e != 0.0:
                bad = int((g != r).sum())
                first = [int(j) for j in (g != r).nonzero()[0]]
                raise SmokeFailure(f"{name}: kernel output {i} != plain "
                                   f"version (max_abs_err {e}, {bad} "
                                   f"elements, first at {first})")
            err = max(err, e)
        b_ms, b_by = bound(nbytes, ops, ops_rate)
        reps = self.reps
        r = self.results[name] = dict(
            max_abs_err=err,
            ms=time_graph_ms(kern, reps) if graph else time_ms(kern, reps),
            plain_ms=(time_ms(plain, 1, warmup=0) if plain_once
                      else time_ms(plain, max(1, reps // 4))), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None if library is None else time_ms(library, reps))
        if graph and events:
            r["event_ms"] = time_ms(kern, reps)
            print(f"kernel {name}: {r['ms']:.4f} ms device time (CUDA "
                  f"graph), {r['event_ms']:.4f} ms by CUDA events",
                  flush=True)
        print(f"kernel {name}: equal to plain; {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by "
              f"{b_by}, library {r['library_ms']})", flush=True)


def record_arms(chk, name, img_l, img_r, arm_args, halo=None):
    """One B1 entry: both eyes in one launch (`cross_arms_lr`) against the
    plain version of each; `halo` = (row_offset, global_h) of the
    halo-shard mode.  Bound: each walked step takes two 3-channel
    max-abs-diffs and the tests (~14 integer operations), and a walk ends
    at its arm's end or one past it.  Returns the kernel's arms."""
    from stereo_to_multiview_tpu_torch.ops import cross
    h, w = img_l.shape[:2]
    arm_args = (*arm_args, *(halo or ()))
    got = cross.cross_arms_lr(img_l, img_r, *arm_args)
    plain = lambda: tuple(cross.cross_arms_plain(t, *arm_args)
                          for t in (img_l, img_r))
    chk.record(name, got, plain(),
               lambda: cross.cross_arms_lr(img_l, img_r, *arm_args), plain,
               nbytes=2 * (h * w * 3 + 4 * h * w * 4),
               ops=14 * (float(got[0].sum()) + float(got[1].sum())
                         + 8 * h * w))
    return got


def check_arms_edges(chk, img_l, img_r, cfg):
    """B1 (both eyes) at the edges of its threshold compare and of its
    staged cross, on a frame (`B1_EDGES`) and on a 37x1001 crop of its
    middle rows at usd 40."""
    import torch
    for suffix, (ucd, lcd, usd) in B1_EDGES.items():
        args = (cfg.ucd if ucd is None else ucd,
                cfg.lcd if lcd is None else lcd,
                cfg.usd if usd is None else usd,
                cfg.lsd if usd is None else usd)
        arms = record_arms(chk, "B1 cross_arms" + suffix, img_l, img_r, args)
        print(f"  B1{suffix}: mean arm {float(arms[0].float().mean()):.2f}",
              flush=True)
        del arms
    y0 = img_l.shape[0] // 2
    crop = [t[y0:y0 + 37, :1001].contiguous() for t in (img_l, img_r)]
    arms = record_arms(chk, "B1 cross_arms" + B1_SHORT, *crop,
                       (cfg.ucd, cfg.lcd, 40, cfg.lsd))
    print(f"  B1{B1_SHORT}: longest DOWN arm {int(arms[0][1].max())} of 36",
          flush=True)
    del arms
    torch.cuda.empty_cache()


def check_core_kernels(chk, img_l, img_r, cfg, hslo=True):
    """B1-B6 on the left eye of a path's whole-frame stereo core and, with
    `hslo`, the scanline-optimisation route (pass 4 as a volume, B13 on
    both eyes); returns both eyes' arms."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import (
        band, costkern, cross, hslokern)
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN
    from stereo_to_multiview_tpu_torch.ops.mux import mux_average

    h, w = img_l.shape[:2]
    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    arms, arms_r = record_arms(chk, "B1 cross_arms", img_l, img_r,
                               (cfg.ucd, cfg.lcd, usd, cfg.lsd))
    hw, hwd = h * w, h * w * nd

    m = costkern.pair_margin(nd, zd)
    s1, s2, s3 = band.agg_rescale_shifts(usd, cfg.band_digits)
    pair = record_cost(chk, "B2 cost_pair", cost_args(img_l, img_r, cfg))

    cost_r = record_shear(chk, "B3 shear_right", pair, zd, library=True)
    if not hslo:
        del cost_r

    a1 = record_hpass(chk, "B4 h_pass_sum (pass 1)", pair[:, m:m + w], arms,
                      usd, s1)
    del pair

    ud = (arms[UP], arms[DOWN])
    a2 = band.vv_pass(a1, *ud, s2, s3, usd)
    chk.record("B5 vv_pass (passes 2+3)", a2,
               band.vv_pass_plain(a1, *ud, s2, s3, usd),
               lambda: band.vv_pass(a1, *ud, s2, s3, usd),
               lambda: band.vv_pass_plain(a1, *ud, s2, s3, usd),
               nbytes=hwd * 4 + 2 * hw * 4 + hwd * 4, ops=2 * 4 * hwd)
    del a1

    record_hpass(chk, "B6 h_pass_wta (pass 4 + WTA)", a2, arms, usd, zd=zd)
    if not hslo:
        return arms, arms_r

    # the scanline-optimisation route: pass 4 as a volume, then B13
    a4 = record_hpass(chk, "B6 h_pass_sum (pass 4, no WTA)", a2, arms, usd)
    del a2
    kappa = band.agg_cost_scale(usd, cfg.band_digits, cfg.band_qscale)
    hargs = (a4, mux_average(img_l), mux_average(img_r), nd, zd, cfg.hslo_T,
             cfg.hslo_H1 * kappa, cfg.hslo_H2 * kappa, +1)
    sdisp = hslokern.dc_hslo_wta(*hargs)
    # bound: the volume and the grays read once, the disparities written
    # once; two directions of ~12 float32 operations per (x, d).  The
    # kernel itself moves four volumes (the int32 one twice, the float32
    # scratch out and in) along 2 * W dependent steps per row.
    chk.record("B13 dc_hslo_wta", sdisp, hslokern.dc_hslo_wta_plain(*hargs),
               lambda: hslokern.dc_hslo_wta(*hargs),
               lambda: hslokern.dc_hslo_wta_plain(*hargs),
               nbytes=hwd * 4 + 2 * hw + hw * 4, ops=2 * 12 * hwd,
               plain_once=True)
    moved = 2.25 * hwd * 4
    wta = (torch.argmin(a4, dim=2) - zd).to(torch.float32)
    print(f"  B13 moves 2.25 volumes ({moved / 1e9:.2f} GB, "
          f"{moved / PEAK_BYTES_PER_S * 1e3:.3f} ms at the peak rate) and "
          f"takes ~2.9 x {w} dependent steps per row; at the "
          f"configuration's penalties the optimisation changes "
          f"{float((sdisp != wta).float().mean()):.4f} of the left eye's "
          f"WTA disparities", flush=True)
    del sdisp, wta

    # The configuration's penalties are small beside this frame's sums, so
    # few argmins move and a wrong tier, neighbour or edge would hardly
    # show.  Once more on the right eye (sign -1, the grays swapped) with
    # penalties of the costs' own size: P2 = a quarter of the median
    # distance from a pixel's mean sum to its least, P1 = P2 / 3.
    b4 = band.band_aggregate_q(cost_r, arms_r, usd, None, cfg.band_digits,
                               cfg.band_qscale)
    del cost_r
    sample = b4[::8, ::8].to(torch.float32)
    h2 = max(1.0, float((sample.mean(dim=2) - sample.amin(dim=2)).median())
             / 4.0)
    del sample
    rargs = (b4, mux_average(img_r), mux_average(img_l), nd, zd, cfg.hslo_T,
             h2 / 3.0, h2, -1)
    rdisp = hslokern.dc_hslo_wta(*rargs)
    chk.record("B13 dc_hslo_wta (right eye, strong penalties)", rdisp,
               hslokern.dc_hslo_wta_plain(*rargs),
               lambda: hslokern.dc_hslo_wta(*rargs),
               lambda: hslokern.dc_hslo_wta_plain(*rargs),
               nbytes=hwd * 4 + 2 * hw + hw * 4, ops=2 * 12 * hwd,
               plain_once=True)
    wta = (torch.argmin(b4, dim=2) - zd).to(torch.float32)
    moved = float((rdisp != wta).float().mean())
    print(f"  B13 right eye, P1 {h2 / 3.0:.1f}, P2 {h2:.1f}: the "
          f"optimisation changes {moved:.4f} of the WTA disparities",
          flush=True)
    if moved < 0.02:
        raise SmokeFailure("B13: the strong penalties move too few "
                           "disparities to test the recurrence")
    del wta, rdisp
    record_hslo_lr(chk, a4, b4, img_l, img_r, hargs[3:-1])
    return arms, arms_r


def record_hslo_lr(chk, a4, b4, img_l, img_r, args):
    """B13 on both eyes in one launch (`dc_hslo_wta_lr`, as the HSLO path
    calls it) against the plain version of each eye, and against two
    one-eye launches; `args` = (D, zd, T, H1, H2).  A package without
    the two-eye entry (an older checkout under --package-root) skips
    it."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import hslokern
    from stereo_to_multiview_tpu_torch.ops.mux import mux_average
    if not hasattr(hslokern, "dc_hslo_wta_lr"):
        print("  B13: no two-eye entry in this package", flush=True)
        return
    gl, gr = mux_average(img_l), mux_average(img_r)
    largs = (a4, b4, gl, gr, *args)
    got = hslokern.dc_hslo_wta_lr(*largs)
    plain = lambda: (hslokern.dc_hslo_wta_plain(a4, gl, gr, *args, +1),
                     hslokern.dc_hslo_wta_plain(b4, gr, gl, *args, -1))
    one = lambda: (hslokern.dc_hslo_wta(a4, gl, gr, *args, +1),
                   hslokern.dc_hslo_wta(b4, gr, gl, *args, -1))
    if not all(bool(torch.equal(g, o)) for g, o in zip(got, one())):
        raise SmokeFailure("B13: the two-eye launch differs from two "
                           "one-eye launches")
    h, w, nd = a4.shape
    hw = h * w
    chk.record("B13 dc_hslo_wta" + B13_LR, got, plain(),
               lambda: hslokern.dc_hslo_wta_lr(*largs), plain,
               nbytes=2 * (hw * nd * 4 + 2 * hw + hw * 4),
               ops=2 * 2 * 12 * hw * nd, plain_once=True)
    print(f"  B13 two one-eye launches: {time_ms(one, chk.reps):.4f} ms",
          flush=True)


def vote_cells(need, outliers):
    """(ceil(H / IRV_TILE), W) bool: the vote tiles (IRV_TILE rows of
    one column) that hold an outlier at a need pixel; the gated B9 streams
    only spans within reach of these, and the gated B8 computes them."""
    import torch.nn.functional as F
    from stereo_to_multiview_tpu_torch.ops.irv import TILE as IRV_TILE
    h, w = need.shape
    voting = need.to(bool) & (outliers != 0)
    nt = -(-h // IRV_TILE)
    return F.pad(voting, (0, 0, 0, nt * IRV_TILE - h)).reshape(
        nt, IRV_TILE, w).any(dim=1)


def rowspan_live(need, outliers, usd: int):
    """(H, W) bool: the row spans the gated B8 must compute, which are the
    rows the gated B9 streams.  For each vote tile of `vote_cells` (IRV_TILE
    rows of one column) with first and last voting rows f and l, the rows
    [f - usd, l + usd] of its column, clipped to the frame.  The kernel
    may write more (the 16-byte stores that also hold a byte of such a
    span); the smoke holds this mirror from both sides: the live spans
    must equal the plain version's, and a vote fed 255 in every other span
    must equal the plain vote."""
    import torch
    import torch.nn.functional as F
    from stereo_to_multiview_tpu_torch.ops.irv import TILE as IRV_TILE
    h, w = need.shape
    nt = -(-h // IRV_TILE)
    voting = F.pad(need.to(bool) & (outliers != 0),
                   (0, 0, 0, nt * IRV_TILE - h)).reshape(nt, IRV_TILE, w)
    cell = voting.any(dim=1).to(torch.int32)               # (nt, W)
    rows = torch.arange(IRV_TILE, device=need.device)[None, :, None]
    first = torch.where(voting, rows, IRV_TILE).amin(dim=1)
    last = torch.where(voting, rows, -1).amax(dim=1)
    base = torch.arange(nt, device=need.device)[:, None] * IRV_TILE
    lo = (base + first - usd).clamp(0, h).to(torch.int64)
    hi = (base + last + usd + 1).clamp(0, h).to(torch.int64)
    edges = torch.zeros((h + 1, w), dtype=torch.int32, device=need.device)
    edges.scatter_add_(0, lo, cell)
    edges.scatter_add_(0, hi, -cell)
    return torch.cumsum(edges, dim=0)[:h] > 0


def vote_span_rows(need, outliers, up, down, usd: int):
    """(H, W) bool: the span rows that the votes of a gated round read, at
    pixel grain: for each outlier at a need pixel, the rows [y - UP, y +
    DOWN] (arms clamped to [0, usd], clipped to the frame) of its own
    column.  The bounds of the gated B8 and B9 count these spans, a
    yardstick that does not move with the kernels' tiles and halos."""
    import torch
    h, w = need.shape
    voter = (need.to(bool) & (outliers != 0)).to(torch.int32)
    ys = torch.arange(h, device=need.device)[:, None]
    lo = (ys - up.clamp(0, usd)).clamp(min=0).to(torch.int64)
    hi = (ys + down.clamp(0, usd) + 1).clamp(max=h).to(torch.int64)
    edges = torch.zeros((h + 1, w), dtype=torch.int32, device=need.device)
    edges.scatter_add_(0, lo, voter)
    edges.scatter_add_(0, hi, -voter)
    return torch.cumsum(edges, dim=0)[:h] > 0


def record_full_rowspan(chk, d, o, lr, nd: int, zd: int, usd: int):
    """B8 without `need` (every span) against its plain version; returns
    the kernel's spans."""
    from stereo_to_multiview_tpu_torch.ops import irv
    cnt = irv.irv_rowspan(d, o, *lr, nd, zd, usd)
    chk.record("B8 irv_rowspan", cnt,
               irv.irv_rowspan_plain(d, o, *lr, nd, zd, usd),
               lambda: irv.irv_rowspan(d, o, *lr, nd, zd, usd),
               lambda: irv.irv_rowspan_plain(d, o, *lr, nd, zd, usd),
               nbytes=d.numel() * (4 + 1 + 8) + cnt.numel(),
               ops=4 * cnt.numel())
    return cnt


def record_full_vote(chk, cnt, d, o, ud, vote, usd: int):
    """B9 without `need` (every outlier votes); its bound counts the spans
    within reach of an outlier (`vote_span_rows`), the planes and the
    outputs."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv
    hw = d.numel()
    read = float(vote_span_rows(torch.ones_like(o, dtype=torch.bool), o,
                                *ud, usd).float().mean())
    chk.record("B9 irv_vote", irv.irv_vote(cnt, d, o, *ud, *vote),
               irv.irv_vote_plain(cnt, d, o, *ud, *vote),
               lambda: irv.irv_vote(cnt, d, o, *ud, *vote),
               lambda: irv.irv_vote_plain(cnt, d, o, *ud, *vote),
               nbytes=read * cnt.numel() + hw * (4 + 1 + 8) + hw * (4 + 1),
               ops=4 * read * cnt.numel())


def record_gated_irv(chk, d1, o1, need, arms, cfg, usd, b8=True, b9=True):
    """The gated B8 (if `b8`) and B9 (if `b9`) of one round under `need`,
    B9 fed 255 in every span the gated B8 may skip; their bounds count the
    spans the votes read (`vote_span_rows`).  Returns (live share of the
    row spans, share of the vote tiles, share of the spans the votes
    read)."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    h, w = d1.shape
    hw, nd, zd = h * w, cfg.num_disp, cfg.zero_disp
    lr, ud = (arms[LEFT], arms[RIGHT]), (arms[UP], arms[DOWN])
    vote = (cfg.irv_thresh_s, cfg.irv_thresh_h, zd, usd)
    live = rowspan_live(need, o1, usd)[:, :, None]
    live_share = float(live.float().mean())
    cell_share = float(vote_cells(need, o1).float().mean())
    read_share = float(vote_span_rows(need, o1, *ud, usd).float().mean())
    n_cnt = hw * (nd + 1)
    cnt_n = irv.irv_rowspan(d1, o1, *lr, nd, zd, usd, need)
    cnt_p = irv.irv_rowspan_plain(d1, o1, *lr, nd, zd, usd)
    if b8:
        chk.record("B8 irv_rowspan (need)", torch.where(live, cnt_n, 0),
                   torch.where(live, cnt_p, 0),
                   lambda: irv.irv_rowspan(d1, o1, *lr, nd, zd, usd, need),
                   lambda: irv.irv_rowspan_plain(d1, o1, *lr, nd, zd, usd),
                   nbytes=hw * (4 + 1 + 8 + 1) + read_share * n_cnt,
                   ops=4 * read_share * n_cnt)
    if not b9:
        return live_share, cell_share, read_share
    # the skipped spans are undefined: give the gated vote 255 (a count no
    # span of a reach below 127 reaches) in each, so that reading one would
    # show
    cnt_n = torch.where(live, cnt_n, 255)
    chk.record("B9 irv_vote (need)",
               irv.irv_vote(cnt_n, d1, o1, *ud, *vote, need),
               irv.irv_vote_plain(cnt_p, d1, o1, *ud, *vote, need),
               lambda: irv.irv_vote(cnt_n, d1, o1, *ud, *vote, need),
               lambda: irv.irv_vote_plain(cnt_p, d1, o1, *ud, *vote, need),
               nbytes=(read_share * n_cnt + hw * (4 + 1 + 8 + 1)
                       + hw * (4 + 1)),
               ops=4 * read_share * n_cnt)
    return live_share, cell_share, read_share


def check_irv(chk, dl, dr, labels, arms_l, arms_r, cfg):
    """B8 and B9 on the left eye's round 1, once more under a real
    second-round `need`, and the pipeline's early-stop loop against the
    fixed rounds; returns both eyes' disparities after IRV."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    h, w = dl.shape
    hw, nd, zd, usd = h * w, cfg.num_disp, cfg.zero_disp, cfg.usd
    ol = labels[0]
    lr, ud = (arms_l[LEFT], arms_l[RIGHT]), (arms_l[UP], arms_l[DOWN])
    cnt = record_full_rowspan(chk, dl, ol, lr, nd, zd, usd)

    vote = (cfg.irv_thresh_s, cfg.irv_thresh_h, zd, usd)
    record_full_vote(chk, cnt, dl, ol, ud, vote, usd)

    # round 2 under the real frontier of round 1's changes
    d1, o1 = irv.irv_vote(cnt, dl, ol, *ud, *vote)
    del cnt
    if chk.suffix in ("", AT_LOWRES):   # the 4K frontier is frame-wide
        record_frontier(chk, G3, [(ol, o1)], usd)
    changed = o1 != ol
    if bool(changed.any()):
        print("  IRV round 2: the frontier of round 1's changes", flush=True)
    else:
        # round 1 changed no label on this frame: the frontier a change
        # would leave, around a sparse subset of the real outliers
        ys = torch.arange(h, device=dl.device)[:, None]
        xs = torch.arange(w, device=dl.device)[None, :]
        changed = (ol != 0) & (ys % 97 == 0) & (xs % 89 == 0)
        print(f"  IRV round 2: round 1 changed no label; the frontier is "
              f"built around {int(changed.sum())} of the frame's outliers",
              flush=True)
    need = irv.dilate_frontier(changed, usd)
    del changed
    live_share, cell_share, read_share = record_gated_irv(
        chk, d1, o1, need, arms_l, cfg, usd)
    # the tile-and-halo count that the bounds of PRs 2-4 used
    tile_share = cell_share * (1 + 2 * usd / irv.TILE)
    print(f"  IRV round 2: need covers {float(need.float().mean()):.4f} of "
          f"the pixels, {cell_share:.4f} of the vote tiles and "
          f"{live_share:.4f} of the row spans are live; the votes read "
          f"{read_share:.4f} of the spans (tile count with halo "
          f"{tile_share:.4f})", flush=True)
    chk.irv_shares[chk.suffix.strip() or MAIN] = dict(
        need=float(need.float().mean()), live_rowspans=live_share,
        vote_tiles=cell_share, votes_read=read_share,
        tile_halo_count=tile_share)
    del need, d1, o1

    # the pipeline's early-stop IRV against the fixed rounds
    irv_args = (cfg.irv_thresh_s, cfg.irv_thresh_h, nd, zd, usd,
                cfg.irv_iterations)
    rounds = []
    fixed_l = irv.dr_irv(dl, ol, arms_l, *irv_args)
    fixed_r = irv.dr_irv(dr, labels[1], arms_r, *irv_args)
    early_l = irv.dr_irv_early_stop(dl, ol, arms_l, *irv_args, rounds)
    early_r = irv.dr_irv_early_stop(dr, labels[1], arms_r, *irv_args, rounds)
    for name, a, b in (("left", fixed_l, early_l), ("right", fixed_r,
                                                    early_r)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise SmokeFailure(f"early-stop IRV differs from the fixed "
                               f"rounds ({name} eye)")
    # each round streamed over two row chunks (halo usd) against the
    # whole-frame rounds
    row_chunk = -(-h // 2)
    for name, d, o, a, fixed in (("left", dl, ol, arms_l, fixed_l),
                                 ("right", dr, labels[1], arms_r, fixed_r)):
        got = irv.dr_irv_early_stop(d, o, a, *irv_args, row_chunk=row_chunk)
        if not (torch.equal(got[0], fixed[0])
                and torch.equal(got[1], fixed[1])):
            raise SmokeFailure(f"IRV over {row_chunk}-row chunks differs "
                               f"from the whole-frame rounds ({name} eye)")
    # the loop queues every round: no host read, whole-frame or chunked
    torch.cuda.set_sync_debug_mode("error")
    try:
        irv.dr_irv_early_stop(dl, ol, arms_l, *irv_args)
        irv.dr_irv_early_stop(dl, ol, arms_l, *irv_args, row_chunk=row_chunk)
    except RuntimeError as e:
        raise SmokeFailure(f"early-stop IRV waits on the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not chk.suffix and hasattr(irv, "irv_frontier"):
        print(f"early-stop IRV: device operations "
              f"{check_loop_kernels(dl, ol, arms_l, irv_args)}", flush=True)
    chunked_ms = time_ms(lambda: irv.dr_irv_early_stop(
        dl, ol, arms_l, *irv_args, row_chunk=row_chunk), 3)
    fixed_ms = time_ms(lambda: irv.dr_irv(dl, ol, arms_l, *irv_args), 3)
    early_ms = time_ms(
        lambda: irv.dr_irv_early_stop(dl, ol, arms_l, *irv_args), 3)
    empty_ms, empty_queued_ms = time_empty_round(fixed_l, arms_l, cfg)
    past = [cfg.irv_iterations - r for r in rounds]
    chk.irv[chk.suffix.strip() or MAIN] = dict(
        rounds_left=rounds[0], rounds_right=rounds[1],
        of=cfg.irv_iterations, past_fixpoint_left=past[0],
        past_fixpoint_right=past[1], fixed_ms_left=fixed_ms,
        early_stop_ms_left=early_ms, empty_round_ms=empty_ms,
        empty_round_queued_ms=empty_queued_ms, row_chunk=row_chunk,
        chunked_ms_left=chunked_ms)
    print(f"early-stop IRV: equal to the {cfg.irv_iterations} fixed rounds "
          f"bit for bit, no host read; rounds up to the fixpoint (tally): "
          f"left {rounds[0]}, right {rounds[1]}; rounds queued past it: "
          f"left {past[0]}, right {past[1]}; left eye {early_ms:.3f} ms "
          f"against {fixed_ms:.3f} ms fixed; over {row_chunk}-row chunks: "
          f"equal bit for bit, left eye {chunked_ms:.3f} ms; an "
          f"empty-frontier round on {h}x{w}: {empty_ms:.4f} ms device "
          f"(CUDA graph), {empty_queued_ms:.4f} ms queued (CUDA events)",
          flush=True)
    return fixed_l[0], fixed_r[0]


def frontier_of(before, after, usd: int):
    """The next round's `need` as the package's early-stop loop makes it:
    G3 (`irv_frontier`) where the package has it (an older checkout's,
    checked with --package-root, may not), else `dilate_frontier`."""
    from stereo_to_multiview_tpu_torch.ops import irv
    if hasattr(irv, "irv_frontier"):
        return irv.irv_frontier(before, after, usd)
    return irv.dilate_frontier(after != before, usd)


def record_frontier(chk, name, pairs, usd: int):
    """One G3 entry: `irv_frontier` on each (before, after) pair of label
    planes against `dilate_frontier(after != before)` on the card, bit
    for bit; timed on the first pair from a CUDA graph (device time)
    beside its CUDA-event time.  Bound: both planes read and the need
    plane written once.  Records nothing for a package without G3."""
    from stereo_to_multiview_tpu_torch.ops import irv
    if not hasattr(irv, "irv_frontier"):
        return
    b0, a0 = pairs[0]
    chk.record(name, tuple(irv.irv_frontier(b, a, usd) for b, a in pairs),
               tuple(irv.dilate_frontier(a != b, usd) for b, a in pairs),
               lambda: irv.irv_frontier(b0, a0, usd),
               lambda: irv.dilate_frontier(a0 != b0, usd),
               nbytes=3 * b0.numel(), ops=0, graph=True, events=True)


def check_frontier_edges(chk, dev):
    """G3 at its edges (`G3_EDGES`, `G3_OFF16`): label planes drawn from a
    seed, each entry on sparse changes (the timed pair), no change, every
    pixel changed and one change at each corner."""
    import torch
    gen = torch.Generator().manual_seed(3)

    def pairs(h, w):
        before = torch.randint(0, 2, (h, w), generator=gen,
                               dtype=torch.uint8)
        sparse = torch.rand((h, w), generator=gen) < 0.002
        sparse[h // 2, w // 2] = True
        changes = [sparse, torch.zeros_like(sparse),
                   torch.ones_like(sparse)]
        for y, x in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)):
            corner = torch.zeros_like(sparse)
            corner[y, x] = True
            changes.append(corner)
        return [(before.to(dev), torch.where(c, before ^ 1, before).to(dev))
                for c in changes]

    def off16(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
        return out.view(t.shape).copy_(t)

    for suffix, (h, w, usd) in G3_EDGES.items():
        record_frontier(chk, G3 + suffix, pairs(h, w), usd)
    record_frontier(chk, G3 + G3_OFF16,
                    [(off16(b), off16(a)) for b, a in pairs(200, 1008)], 34)


def record_frontier_4k(chk, img_l, img_r, arms_l, arms_r, cfg):
    """G3 on the 4K preset's whole frame, as its early-stop loop runs it
    (rounds over row chunks, the frontier frame-wide): the left eye's
    labels before and after round 1."""
    from stereo_to_multiview_tpu_torch.ops import dcc, irv
    from stereo_to_multiview_tpu_torch.ops.band import (
        band_stereo_core_chunked)
    dl, dr = band_stereo_core_chunked(img_l, img_r, arms_l, arms_r, cfg)
    ol = dcc.dr_dcc(dl, dr, cfg.dcc_thresh)[0]
    del dr
    o1 = irv.irv_round_chunked(dl, ol, arms_l, cfg.irv_thresh_s,
                               cfg.irv_thresh_h, cfg.num_disp, cfg.zero_disp,
                               cfg.usd, row_chunk=cfg.irv_row_chunk)[1]
    record_frontier(chk, G3 + G3_4K, [(ol, o1)], cfg.usd)


def check_loop_kernels(d, o, arms, irv_args):
    """The device kernels of one early-stop IRV call (`torch.profiler`):
    G3 for every frontier, no torch max-pool (the frontier's former
    chain).  Returns their names."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        irv.dr_irv_early_stop(d, o, arms, *irv_args)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    if not any("irv_frontier_kernel" in n for n in names):
        raise SmokeFailure(f"early-stop IRV: no G3 launch among its device "
                           f"operations {names}")
    if any("max_pool" in n for n in names):
        raise SmokeFailure(f"early-stop IRV: a max-pool ran on the device: "
                           f"{names}")
    return names


def time_empty_round(state, arms, cfg, reps: int = 10):
    """One round as the early-stop loop queues it past its fixpoint: the
    frontier of a round that changed no label (G3 on equal planes)
    and the round under it (B8 and B9 with an empty `need`), on the
    state the fixed rounds leave.  Returns its device ms (a CUDA graph of
    `reps` rounds) and its ms queued from the host (CUDA events around
    `reps` rounds).  The round must pass its state through."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv

    d, o = state
    args = (cfg.irv_thresh_s, cfg.irv_thresh_h, cfg.num_disp,
            cfg.zero_disp, cfg.usd)

    def empty_round():
        need = frontier_of(o, o, cfg.usd)
        return irv.irv_round(d, o, arms, *args, need)

    got = empty_round()
    if not (torch.equal(got[0], d) and torch.equal(got[1], o)):
        raise SmokeFailure("IRV: a round under an empty frontier changed "
                           "its state")
    return time_graph_ms(empty_round, reps), time_ms(empty_round, reps)


def check_vstream_edges(chk, dl, ol, arms, cfg, b9=True):
    """B5 and B9 (full and gated) where their column streams meet the
    frame's edges: on a 37-row crop of the frame's middle rows (fewer rows
    than a ring of 2 * usd + 2: the rings prime against windows clipped at
    both ends, and the arms reach past the crop) and on a 200-row crop at
    reach 0 (no lag, empty B5 windows).  B5 takes a pass-1-sized random
    volume, B9 (with `b9`) the crop's raw disparities, labels and arms."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, irv
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    nd, zd = cfg.num_disp, cfg.zero_disp
    s2, s3 = band.agg_rescale_shifts(cfg.usd)[1:]
    gen = torch.Generator(device=arms.device).manual_seed(5)
    y0 = arms.shape[1] // 2
    for suffix, rows, usd in ((AT_SHORT, 37, cfg.usd), (AT_REACH0, 200, 0)):
        chk.suffix = suffix
        rs, cs = slice(y0, y0 + rows), slice(0, 1001)
        a = arms[:, rs, cs].contiguous()
        h, w = a.shape[1:]
        hw, hwd = h * w, h * w * nd
        vol = torch.randint(0, 17_600, (h, w, nd), generator=gen,
                            device=arms.device, dtype=torch.int32)
        ud = (a[UP], a[DOWN])
        chk.record("B5 vv_pass (passes 2+3)",
                   band.vv_pass(vol, *ud, s2, s3, usd),
                   band.vv_pass_plain(vol, *ud, s2, s3, usd),
                   lambda: band.vv_pass(vol, *ud, s2, s3, usd),
                   lambda: band.vv_pass_plain(vol, *ud, s2, s3, usd),
                   nbytes=hwd * 4 + 2 * hw * 4 + hwd * 4, ops=2 * 4 * hwd)
        del vol
        if not b9:
            continue
        d, o = dl[rs, cs].contiguous(), ol[rs, cs].contiguous()
        cnt = irv.irv_rowspan(d, o, a[LEFT], a[RIGHT], nd, zd, usd)
        vote = (cfg.irv_thresh_s, cfg.irv_thresh_h, zd, usd)
        record_full_vote(chk, cnt, d, o, ud, vote, usd)
        del cnt
        # a frontier around a sparse subset of the crop's outliers
        ys = torch.arange(h, device=d.device)[:, None]
        xs = torch.arange(w, device=d.device)[None, :]
        need = irv.dilate_frontier((o != 0) & (ys % 11 == 0)
                                   & (xs % 53 == 0), usd)
        shares = record_gated_irv(chk, d, o, need, a, cfg, usd, b8=False)
        print(f"  {suffix.strip()}: the gated vote reads {shares[2]:.4f} "
              f"of the spans", flush=True)
    chk.suffix = ""


def check_vpass_plan():
    """B5's launch plan in C (`stm_vv_stages`) against its mirror
    `band.vv_stages`, by which `vv_pass.staged` counts, over D, reach and
    alignment; skipped for a package without them."""
    from stereo_to_multiview_tpu_torch import kernels
    from stereo_to_multiview_tpu_torch.ops import band
    lib = kernels.lib("vpass")
    if not hasattr(band, "vv_stages") or not hasattr(lib, "stm_vv_stages"):
        print("  B5 plan: the package has no staged path", flush=True)
        return
    bad = [(nd, reach, al, lib.stm_vv_stages(nd, reach, al),
            band.vv_stages(nd, reach, bool(al)))
           for nd in (1, 4, 30, 32, 64, 96, 126, 128, 130, 132, 256, 1024)
           for reach in (0, 1, 17, 34, 64, 104, 105, 108, 112, 113, 200)
           for al in (0, 1)
           if lib.stm_vv_stages(nd, reach, al)
           != band.vv_stages(nd, reach, bool(al))]
    if bad:
        raise SmokeFailure(f"B5 plan: stm_vv_stages != band.vv_stages at "
                           f"(D, reach, aligned, C, mirror) {bad[:5]}")
    print("  B5 plan: stm_vv_stages == band.vv_stages at 264 "
          "(D, reach, aligned)", flush=True)


def check_vpass_edges(chk, arms, cfg):
    """B5 (`VP_EDGES`) where its staged path gives way to its register
    path and where a stage is partly filled, each on a crop of the frame's
    middle rows with random volumes and, at reach 64 and 108, random arms
    beyond [0, reach]; `vv_pass.staged` must count the staged launches
    alone (`band.vv_stages`).  Then the plan of every (D, reach)."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN

    check_vpass_plan()
    s2, s3 = band.agg_rescale_shifts(cfg.usd)[1:]
    dev = arms.device
    gen = torch.Generator(device=dev).manual_seed(7)
    y0 = arms.shape[1] // 2
    for suffix, rows, nd, usd, offset in (
            (AT_VP_D130, 37, 130, cfg.usd, 0),
            (AT_VP_D126, 200, 126, cfg.usd, 0),
            (AT_VP_OFF, 200, cfg.num_disp, cfg.usd, 1),
            (AT_VP_REACH64, 200, cfg.num_disp, 64, 0),
            (AT_VP_REACH108, 200, cfg.num_disp, 108, 0),
            (AT_VP_FEW, 9, cfg.num_disp, cfg.usd, 0)):
        chk.suffix = suffix
        w = 1001
        n = rows * w * nd
        flat = torch.randint(0, 17_600, (n + offset,), generator=gen,
                             device=dev, dtype=torch.int32)
        vol = flat[offset:].view(rows, w, nd)
        if usd > cfg.usd:
            ud = tuple(torch.randint(-2, usd + 3, (rows, w), generator=gen,
                                     device=dev, dtype=torch.int32)
                       for _ in range(2))
        else:
            ud = tuple(arms[k, y0:y0 + rows, :w].contiguous()
                       for k in (UP, DOWN))
        before = getattr(band.vv_pass, "staged", None)
        got = band.vv_pass(vol, *ud, s2, s3, usd)
        if before is not None:
            want = band.vv_stages(nd, usd, nd % 4 == 0
                                  and vol.data_ptr() % 16 == 0) > 0
            if band.vv_pass.staged - before != int(want):
                raise SmokeFailure(f"B5{suffix}: vv_pass.staged counted "
                                   f"{band.vv_pass.staged - before}, "
                                   f"expected {int(want)}")
        hw, hwd = rows * w, rows * w * nd
        chk.record("B5 vv_pass (passes 2+3)", got,
                   band.vv_pass_plain(vol, *ud, s2, s3, usd),
                   lambda: band.vv_pass(vol, *ud, s2, s3, usd),
                   lambda: band.vv_pass_plain(vol, *ud, s2, s3, usd),
                   nbytes=hwd * 4 + 2 * hw * 4 + hwd * 4, ops=2 * 4 * hwd)
        del flat, vol, got
    chk.suffix = ""


def vpass_checks(root: str) -> int:
    """`--vpass-checks [--package-root DIR]`: B5 alone, on the package
    under DIR, against `vv_pass_plain` bit for bit and timed: at the
    shapes of the presets' calls (the 1080p frame, a 680x3840 row chunk of
    the 4K preset, the lowres preset's 540x960 at D=64), with the 1080p
    frame's, the 4K frame's and the scaled frame's arms and random volumes
    of pass 1's range, then at its edges (`check_vstream_edges`' crops,
    `check_vpass_edges`).  The way to time two commits' B5 in turns.
    Exit 1 if one fails."""
    import torch
    sys.path.insert(0, root)
    from stereo_to_multiview_tpu_torch import config, kernels
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops import band, cross
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN
    from stereo_to_multiview_tpu_torch.ops.scale import tx_scale_bilinear

    print(f"gpu: {gpu_line()}", flush=True)
    print_ptxas(kernels.build_kernels())
    dev = torch.device("cuda")
    chk = KernelChecks(reps=20)
    gen = torch.Generator(device=dev).manual_seed(3)
    cfg, cfg4k, lcfg = (config.HD1080_D128, config.UHD4K_16V,
                        config.HD1080_LOWRES)

    def eyes(c):
        sbs = torch.from_numpy(stereo_sbs(c.num_rows, c.num_cols)).to(dev)
        return [t.contiguous() for t in pipeline.demux_sbs(sbs)]

    def one(suffix, img, c):
        chk.suffix = suffix
        arms = cross.cross_arms(img, c.ucd, c.lcd, c.usd, c.lsd)
        h, w = img.shape[:2]
        nd = c.num_disp
        vol = torch.randint(0, 17_600, (h, w, nd), generator=gen,
                            device=dev, dtype=torch.int32)
        s2, s3 = band.agg_rescale_shifts(c.usd, c.band_digits)[1:]
        ud = (arms[UP], arms[DOWN])
        hw, hwd = h * w, h * w * nd
        chk.record("B5 vv_pass (passes 2+3)",
                   band.vv_pass(vol, *ud, s2, s3, c.usd),
                   band.vv_pass_plain(vol, *ud, s2, s3, c.usd),
                   lambda: band.vv_pass(vol, *ud, s2, s3, c.usd),
                   lambda: band.vv_pass_plain(vol, *ud, s2, s3, c.usd),
                   nbytes=hwd * 4 + 2 * hw * 4 + hwd * 4, ops=2 * 4 * hwd)
        chk.suffix = ""
        return arms

    try:
        img_l, _ = eyes(cfg)
        arms = one("", img_l, cfg)
        rows = band.chunk_bounds(cfg4k.num_rows, cfg4k.band_row_chunk,
                                 2 * cfg4k.usd)[0]
        one(AT_4K, eyes(cfg4k)[0][:rows].contiguous(), cfg4k)
        one(AT_LOWRES, tx_scale_bilinear(img_l, lcfg.num_rows_disp,
                                         lcfg.num_cols_disp).contiguous(),
            lcfg)
        torch.cuda.empty_cache()
        check_vstream_edges(chk, None, None, arms, cfg, b9=False)
        if hasattr(band.vv_pass, "staged"):
            check_vpass_edges(chk, arms, cfg)
        print(f"B5: vv_pass.staged {getattr(band.vv_pass, 'staged', None)} "
              f"of {band.vv_pass.launches} launches", flush=True)
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


def check_vote_edges(chk, dl, ol, arms, cfg, suffixes=VOTE_EDGES):
    """B9, full and gated, where its staged path meets its edges (the
    `suffixes`: VOTE_EDGES, and with --irv-checks AT_SHORT and AT_REACH0
    too): crops of the frame's middle rows with their raw disparities,
    labels and arms (random arms in [-2, reach + 2] above the preset's
    reach; at D=130 the disparities reach bins 2 .. 129), and, full only,
    the whole frame's spans copied to a volume 4 bytes past a 16-byte
    bound.  `irv_vote.staged` must count every launch but those of
    AT_V_REG (the register path)."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    h, w = dl.shape
    y0 = h // 2
    gen = torch.Generator(device=dl.device).manual_seed(11)
    # (first row, rows, columns, num_disp and zero_disp or None, reach)
    cases = {AT_SHORT: (y0, 37, 1001, None, cfg.usd),
             AT_REACH0: (y0, 200, 1001, None, 0),
             AT_V_D130: (y0, 37, 1001, (130, 66), cfg.usd),
             AT_V_REACH127: (y0, 200, 1001, None, 127),
             AT_V_OFF: (0, h, w, None, cfg.usd),
             AT_V_REG: (y0, 200, 301, (1023, 64), 50)}
    for suffix in suffixes:
        r0, rows, cols, bins, usd = cases[suffix]
        chk.suffix = suffix
        c = cfg.replace(num_disp=bins[0], zero_disp=bins[1]) if bins else cfg
        rs, cs = slice(r0, r0 + rows), slice(0, cols)
        d, o = dl[rs, cs].contiguous(), ol[rs, cs].contiguous()
        a = arms[:, rs, cs].contiguous()
        if usd > cfg.usd:
            a = torch.randint(-2, usd + 3, a.shape, generator=gen,
                              device=d.device, dtype=torch.int32)
        cnt = irv.irv_rowspan(d, o, a[LEFT], a[RIGHT], c.num_disp,
                              c.zero_disp, usd)
        if suffix == AT_V_OFF:
            flat = torch.empty(cnt.numel() + 32, dtype=torch.uint8,
                               device=d.device)
            skip = (4 - flat.data_ptr()) % 16
            cnt = flat[skip:skip + cnt.numel()].view(cnt.shape).copy_(cnt)
            if cnt.data_ptr() % 16 != 4:
                raise SmokeFailure("B9: the volume is not 4 bytes off 16")
        launches = irv.irv_vote.launches
        staged = getattr(irv.irv_vote, "staged", None)
        vote = (c.irv_thresh_s, c.irv_thresh_h, c.zero_disp, usd)
        record_full_vote(chk, cnt, d, o, (a[UP], a[DOWN]), vote, usd)
        del cnt
        if suffix != AT_V_OFF:
            # a frontier around a sparse subset of the crop's outliers
            ys = torch.arange(rows, device=d.device)[:, None]
            xs = torch.arange(cols, device=d.device)[None, :]
            need = irv.dilate_frontier((o != 0) & (ys % 11 == 0)
                                       & (xs % 53 == 0), usd)
            shares = record_gated_irv(chk, d, o, need, a, c, usd, b8=False)
            print(f"  {suffix.strip()}: the gated vote reads "
                  f"{shares[2]:.4f} of the spans", flush=True)
        if staged is not None:
            want = (irv.irv_vote.launches - launches) * int(
                suffix != AT_V_REG)
            if irv.irv_vote.staged - staged != want:
                raise SmokeFailure(f"B9{suffix}: irv_vote.staged counted "
                                   f"{irv.irv_vote.staged - staged}, "
                                   f"expected {want}")
    chk.suffix = ""


def record_vote_rounds(chk, img_l, img_r, cfg):
    """B9 on the left eye of a frame at cfg (its raw disparities and labels
    from the kernels): round 1, where every outlier votes, and round 2
    under the frontier of round 1's changes (or, where it changed no
    label, one around a sparse subset of the outliers).  Returns the eye's
    raw disparities, labels and arms."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import cross, dcc, irv
    from stereo_to_multiview_tpu_torch.ops.band import (
        band_stereo_core_chunked)
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    arm_args = (cfg.ucd, cfg.lcd, cfg.usd, cfg.lsd)
    arms_l, arms_r = (cross.cross_arms(t, *arm_args) for t in (img_l, img_r))
    dl, dr = band_stereo_core_chunked(img_l, img_r, arms_l, arms_r, cfg)
    ol = dcc.dr_dcc(dl, dr, cfg.dcc_thresh)[0]
    del dr, arms_r
    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    ud = (arms_l[UP], arms_l[DOWN])
    vote = (cfg.irv_thresh_s, cfg.irv_thresh_h, zd, usd)
    cnt = irv.irv_rowspan(dl, ol, arms_l[LEFT], arms_l[RIGHT], nd, zd, usd)
    record_full_vote(chk, cnt, dl, ol, ud, vote, usd)
    d1, o1 = irv.irv_vote(cnt, dl, ol, *ud, *vote)
    del cnt
    if chk.suffix in ("", AT_LOWRES):
        record_frontier(chk, G3, [(ol, o1)], usd)
    changed = o1 != ol
    if not bool(changed.any()):
        ys = torch.arange(dl.shape[0], device=dl.device)[:, None]
        xs = torch.arange(dl.shape[1], device=dl.device)[None, :]
        changed = (ol != 0) & (ys % 97 == 0) & (xs % 89 == 0)
    need = irv.dilate_frontier(changed, usd)
    shares = record_gated_irv(chk, d1, o1, need, arms_l, cfg, usd, b8=False)
    print(f"  B9{chk.suffix}: round 2's need covers "
          f"{float(need.float().mean()):.4f} of the pixels; the votes read "
          f"{shares[2]:.4f} of the spans", flush=True)
    return dl, ol, arms_l


def irv_checks(root: str) -> int:
    """`--irv-checks [--package-root DIR]`: B9 and G3 alone, on the
    package under DIR, against `irv_vote_plain` and `dilate_frontier` bit
    for bit and timed: B9 full and gated (round 2 of the frame) on the
    1080p frame, on the 4K preset's first 1152x3840 IRV chunk and at the
    lowres preset's 540x960, D=64, then at its edges (`check_vote_edges`
    with AT_SHORT and AT_REACH0: 37 rows, reach 0, D=130, reach 127, a
    volume 4 bytes off 16, and the register path at D=1023, reach 50); G3
    on round 1's labels at 1080p and 540x960 and at its edges
    (`check_frontier_edges`; skipped on a package without it).  The way
    to time two commits' B9 in turns.  Exit 1 if one fails."""
    import torch
    sys.path.insert(0, root)
    from stereo_to_multiview_tpu_torch import config, kernels
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops import band, irv
    from stereo_to_multiview_tpu_torch.ops.scale import tx_scale_bilinear

    print(f"gpu: {gpu_line()}", flush=True)
    print_ptxas(kernels.build_kernels())
    dev = torch.device("cuda")
    chk = KernelChecks(reps=20)
    cfg, cfg4k, lcfg = (config.HD1080_D128, config.UHD4K_16V,
                        config.HD1080_LOWRES)

    def eyes(c):
        sbs = torch.from_numpy(stereo_sbs(c.num_rows, c.num_cols)).to(dev)
        return [t.contiguous() for t in pipeline.demux_sbs(sbs)]

    try:
        img_l, img_r = eyes(cfg)
        dl, ol, arms = record_vote_rounds(chk, img_l, img_r, cfg)
        rows = band.chunk_bounds(cfg4k.num_rows, cfg4k.irv_row_chunk,
                                 cfg4k.usd)[0]
        chk.suffix = AT_4K
        record_vote_rounds(chk, *(t[:rows].contiguous()
                                  for t in eyes(cfg4k)), cfg4k)
        chk.suffix = AT_LOWRES
        record_vote_rounds(chk, *(tx_scale_bilinear(
            t, lcfg.num_rows_disp, lcfg.num_cols_disp).contiguous()
            for t in (img_l, img_r)), lcfg)
        chk.suffix = ""
        torch.cuda.empty_cache()
        check_vote_edges(chk, dl, ol, arms, cfg,
                         (AT_SHORT, AT_REACH0) + VOTE_EDGES)
        check_frontier_edges(chk, dev)
        print(f"B9: irv_vote.staged {getattr(irv.irv_vote, 'staged', None)} "
              f"of {irv.irv_vote.launches} launches", flush=True)
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


def check_irv_rounds(chk, dl, ol, arms, cfg):
    """B8 and B9 in every round of the pipeline's early-stop loop on the
    left eye's raw disparities and labels: round 1 full, each later round
    under the frontier of the round before (`dr_irv_early_stop`'s own
    `need`, from G3, which is held against `dilate_frontier` after each
    round).  The rounds' outcome must equal `dr_irv_early_stop`.  Returns
    the shares of each gated round."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    lr, ud = (arms[LEFT], arms[RIGHT]), (arms[UP], arms[DOWN])
    vote = (cfg.irv_thresh_s, cfg.irv_thresh_h, zd, usd)
    d, o, need, done, shares = dl, ol, None, 0, {}
    while done < cfg.irv_iterations:
        chk.suffix = irv_round_suffix(done + 1)
        if need is None:
            cnt = record_full_rowspan(chk, d, o, lr, nd, zd, usd)
            record_full_vote(chk, cnt, d, o, ud, vote, usd)
            del cnt
        else:
            live, cells, read = record_gated_irv(chk, d, o, need, arms, cfg,
                                                 usd)
            shares[done + 1] = dict(need=float(need.float().mean()),
                                    live_rowspans=live, vote_tiles=cells,
                                    votes_read=read)
            print(f"  IRV round {done + 1}: need covers "
                  f"{shares[done + 1]['need']:.4f} of the pixels; the votes "
                  f"read {read:.4f} of the spans, the gated B8 computes at "
                  f"least {live:.4f}", flush=True)
        d1, o1 = irv.irv_round(d, o, arms, *vote[:2], nd, zd, usd, need)
        done += 1
        more = done < cfg.irv_iterations and bool((o1 != o).any())
        if more:
            chk.suffix = irv_round_suffix(done)
            record_frontier(chk, G3, [(o, o1)], usd)
            need = frontier_of(o, o1, usd)
        d, o = d1, o1
        if not more:
            break
    chk.suffix = ""
    if done != IRV_ROUNDS:
        raise SmokeFailure(f"IRV rounds: the frame ran {done} rounds, the "
                           f"kernel table lists {IRV_ROUNDS}")
    rounds = []
    ref = irv.dr_irv_early_stop(dl, ol, arms, cfg.irv_thresh_s,
                                cfg.irv_thresh_h, nd, zd, usd,
                                cfg.irv_iterations, rounds)
    if not (torch.equal(ref[0], d) and torch.equal(ref[1], o)):
        raise SmokeFailure("IRV rounds: the recorded rounds differ from "
                           "dr_irv_early_stop")
    print(f"IRV rounds: {done} rounds on the left eye, equal to "
          f"dr_irv_early_stop; B8 and B9 each launch once a round and eye, "
          f"G3 once after each round but the last", flush=True)
    return shares


def check_rowspan_edges(chk, dl, ol, arms, cfg):
    """B8, full and gated, where its row streams end and its byte prefixes
    wrap: a 37-row crop and a reach-0 crop of the frame's middle rows, a
    200x1001 crop (odd W), D=126 on a 200x1000 crop (B + 1 = 127: every
    alignment of a pixel in the volume), and reach 127 on a frame of one
    disparity with sparse outliers and arms of 127 (windows of 255
    reliable pixels of one bin: the byte prefixes wrap), and D=130 on a
    37x1001 crop (two groups of bins a lane)."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import irv
    from stereo_to_multiview_tpu_torch.ops.cross import LEFT, RIGHT

    y0 = dl.shape[0] // 2
    # (suffix, rows, columns, num_disp and zero_disp or None, reach); at
    # D=130 the frame's disparities in [-64, 64) reach bins 2 .. 129
    cases = ((AT_SHORT, 37, 1001, None, cfg.usd),
             (AT_REACH0, 200, 1001, None, 0), (RS_ODD, 200, 1001, None, cfg.usd),
             (RS_D126, 200, 1000, (126, 63), cfg.usd),
             (RS_WRAP, 200, 1001, None, 127), (RS_D130, 37, 1001, (130, 66), cfg.usd))
    for suffix, rows, cols, bins, usd in cases:
        chk.suffix = suffix
        c = cfg.replace(num_disp=bins[0], zero_disp=bins[1]) if bins else cfg
        rs, cs = slice(y0, y0 + rows), slice(0, cols)
        d, o = dl[rs, cs].contiguous(), ol[rs, cs].contiguous()
        a = arms[:, rs, cs].contiguous()
        ys = torch.arange(rows, device=d.device)[:, None]
        xs = torch.arange(cols, device=d.device)[None, :]
        if suffix == RS_WRAP:
            d = torch.full_like(d, 5.0)
            o = ((ys % 7 == 0) & (xs % 13 == 0)).to(torch.uint8)
            a = torch.full_like(a, 127)
        cnt = record_full_rowspan(chk, d, o, (a[LEFT], a[RIGHT]),
                                  c.num_disp, c.zero_disp, usd)
        top = int(cnt.max())
        del cnt
        if suffix == RS_WRAP and top != 255:
            raise SmokeFailure(f"B8{suffix}: the largest window holds {top}, "
                               f"not 255")
        # a frontier around a sparse subset of the crop's outliers
        need = irv.dilate_frontier((o != 0) & (ys % 11 == 0)
                                   & (xs % 53 == 0), usd)
        shares = record_gated_irv(chk, d, o, need, a, c, usd, b9=False)
        print(f"  {suffix.strip()}: largest window {top}; the gated B8 "
              f"computes at least {shares[0]:.4f} of the spans", flush=True)
    chk.suffix = ""


def record_bilateral(chk, name, img, radius: int, cfg):
    """B10 against its plain version; the bound counts five float32
    operations a tap (the difference, the add that floors it, the weight
    times the sample, two sums) at the rate of operations that do not
    contract into a multiply-add.  The weight itself, the spatial tap
    times the range weight of an integer t, is a table of the tap and t
    built once a launch, so it costs no operation a pixel.  Returns the
    kernel's output."""
    from stereo_to_multiview_tpu_torch.ops import filters
    blf = (radius, cfg.bilateral_sigma_color, cfg.bilateral_sigma_spatial)
    out = filters.filter_bilateral(img, *blf)
    chk.record(name, out, filters.filter_bilateral_plain(img, *blf),
               lambda: filters.filter_bilateral(img, *blf),
               lambda: filters.filter_bilateral_plain(img, *blf),
               nbytes=2 * img.numel() * 4,
               ops=5 * (2 * radius + 1) ** 2 * img.numel(),
               ops_rate=PEAK_FP32_NOFMA_PER_S)
    return out


def check_bilateral_edges(chk, disp, cfg):
    """B10 beside the main path's radius: radii 0, 1 and 8 on the frame's
    disparities after IRV, the default radius on a 37x1001 crop, on
    fractional values over [-1000, 1000) (range-weight indices past the
    table: the direct expression) and on a map whose |a - s| falls on
    integers and one ulp below them, up to 128 (where each block takes
    the table without the check)."""
    import torch
    for suffix, r in B10_EDGES.items():
        record_bilateral(chk, "B10 filter_bilateral" + suffix, disp, r, cfg)
    y0 = disp.shape[0] // 2
    r = cfg.bilateral_radius
    record_bilateral(chk, "B10 filter_bilateral" + B10_CROP,
                     disp[y0:y0 + 37, :1001].contiguous(), r, cfg)
    gen = torch.Generator(device=disp.device).manual_seed(10)
    frac = torch.rand((200, 1001), generator=gen, device=disp.device) \
        * 2000.0 - 1000.0
    record_bilateral(chk, "B10 filter_bilateral" + B10_FRAC, frac, r, cfg)
    n = torch.randint(1, 128, (200, 1001), generator=gen,
                      device=disp.device).to(torch.float32)
    below = torch.nextafter(n, torch.zeros_like(n))
    v = torch.where(torch.rand(n.shape, generator=gen, device=n.device)
                    < 0.5, n, below)
    ys = torch.arange(200, device=n.device)[:, None]
    xs = torch.arange(1001, device=n.device)[None, :]
    ulp = torch.where((ys + xs) % 2 == 0, torch.zeros_like(v), v)
    record_bilateral(chk, "B10 filter_bilateral" + B10_ULP, ulp, r, cfg)


def record_hpass(chk, name, vol, arms, usd, shift=0, zd=None, lossy=False):
    """One entry of hpass.cu held against its plain version: pass 1 (u8
    or int16) or pass 4 without the WTA (int32) with `shift`, or pass 4 +
    WTA with `zd` (each input rounded to bf16 first with `lossy`).
    Returns the kernel's output."""
    from stereo_to_multiview_tpu_torch.ops import band
    from stereo_to_multiview_tpu_torch.ops.cross import LEFT, RIGHT
    h, w, nd = vol.shape
    hw, hwd = h * w, h * w * nd
    lr = (arms[LEFT], arms[RIGHT])
    if zd is None:
        kern = lambda: band.h_pass_sum(vol, *lr, shift, usd)
        plain = lambda: band.h_pass_sum_plain(vol, *lr, shift, usd)
        nbytes = hwd * vol.element_size() + 2 * hw * 4 + hwd * 4
    else:
        kern = lambda: band.h_pass_wta(vol, *lr, zd, usd, lossy)
        plain = lambda: band.h_pass_wta_plain(vol, *lr, zd, usd, lossy)
        nbytes = hwd * 4 + 2 * hw * 4 + hw * 4
    out = kern()
    chk.record(name, out, plain(), kern, plain, nbytes=nbytes, ops=3 * hwd)
    return out


def cost_args(img_l, img_r, cfg):
    """The arguments of `cost_pair` for a pair of images under `cfg`:
    images, coefficients, D and zero_disp."""
    return (img_l, img_r, cfg.ad_coeff, cfg.census_coeff, cfg.num_disp,
            cfg.zero_disp)


def record_cost(chk, name, cargs, qscale=127.0, quant=True, eye="pair",
                rows=None):
    """One B2 entry: `cost_pair` in one of its modes, over the frame rows
    `rows` (every row by default), against its plain version (the
    host-built table of the same dtype).  Returns the kernel's volume."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import costkern
    img_l, img_r, ad, cen, nd, zd = cargs
    table = costkern.device_cost_table(ad, cen, img_l.device, qscale, quant)
    pargs = (img_l, img_r, table, nd, zd, eye, rows)
    kw = dict(qscale=qscale, quant=quant, eye=eye, rows=rows)
    out = costkern.cost_pair(*cargs, **kw)
    h, w = img_l.shape[:2]
    start, count = (0, h) if rows is None else rows
    read = min(h, start + count + 3) - max(0, start - 3)
    # bytes: the images' rows within the census' reach read once, the two
    # float32 term tables, the volume written once; ~10 integer operations
    # an element and two 48-compare census codes a pixel
    tab_bytes = (costkern.AD_VALUES + costkern.HAM_VALUES) * 4
    chk.record(name, out, costkern.cost_pair_plain(*pargs),
               lambda: costkern.cost_pair(*cargs, **kw),
               lambda: costkern.cost_pair_plain(*pargs),
               nbytes=2 * read * w * 3 + tab_bytes
               + out.numel() * out.element_size(),
               ops=10 * out.numel() + 2 * 48 * count * w)
    return out


def record_shear(chk, name, pair, zd, library=False):
    """One B3 entry: `shear_right` against its plain version; with
    `library`, one `torch.gather` of the same elements timed beside it.
    Returns the kernel's volume."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import costkern
    h, wp, nd = pair.shape
    m = costkern.pair_margin(nd, zd)
    w = wp - 2 * m
    out = costkern.shear_right(pair, zd)
    lib = None
    if library:
        x = torch.arange(w, device=pair.device)[:, None]
        d = torch.arange(nd, device=pair.device)[None, :]
        idx = (x + m - (d - zd)).expand(h, w, nd)
        lib = lambda: torch.gather(pair, 1, idx)
    chk.record(name, out, costkern.shear_right_plain(pair, zd),
               lambda: costkern.shear_right(pair, zd),
               lambda: costkern.shear_right_plain(pair, zd),
               nbytes=(pair.numel() + out.numel()) * pair.element_size(),
               ops=0, library=lib)
    return out


def check_hstream_edges(chk, img_l, img_r, cfg):
    """B4 and B6 (WTA and sum-only) where their row streams meet the
    frame's edges and their vector paths end, on crops of the frame's
    middle rows: 37x1001 and 200x1001 at reach 0 (1001 columns: the last
    segment is shorter), 37x200 (one segment narrower than its maximum),
    the left-eye view of a 200x1001 crop's pair volume (strided, vector
    path); the crop's own pair at D=126 (scalar loads and stores; B2 and
    B3 there too); then random volumes at D=130 (two chunks of d a lane),
    u8 costs in 240..255 (the u16 prefix halves wrap within a segment)
    and int32 sums full of ties (0/1 inputs)."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern, cross
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN

    dev = img_l.device
    y0 = img_l.shape[0] // 2
    arm_args = (cfg.ucd, cfg.lcd, cfg.usd, cfg.lsd)
    s2, s3 = band.agg_rescale_shifts(cfg.usd)[1:]
    b4, b6, b6s = HPASS

    def crop(rows, cols):
        l, r = (t[y0:y0 + rows, :cols].contiguous() for t in (img_l, img_r))
        return l, r, cross.cross_arms(l, *arm_args)

    def passes(suffix, rows, cols, usd, nd, zd, wanted=HPASS, b23=False):
        chk.suffix = suffix
        l, r, arms = crop(rows, cols)
        cargs = cost_args(l, r, cfg.replace(num_disp=nd, zero_disp=zd))
        if b23:
            pair = record_cost(chk, "B2 cost_pair", cargs)
            record_shear(chk, "B3 shear_right", pair, zd)
            for eye, side in (("l", "left"), ("r", "right")):
                record_cost(chk, f"B2 cost_pair ({side} eye u8, direct)",
                            cargs, eye=eye)
        else:
            pair = costkern.cost_pair(*cargs)
        m = costkern.pair_margin(nd, zd)
        a1 = record_hpass(chk, b4, pair[:, m:m + cols], arms, usd)
        if len(wanted) > 1:
            a2 = band.vv_pass(a1, arms[UP], arms[DOWN], s2, s3, usd)
            record_hpass(chk, b6, a2, arms, usd, zd=zd)
            record_hpass(chk, b6s, a2, arms, usd)
        chk.suffix = ""

    nd, zd = cfg.num_disp, cfg.zero_disp
    passes(AT_SHORT, 37, 1001, cfg.usd, nd, zd)
    passes(AT_REACH0, 200, 1001, 0, nd, zd)
    passes(AT_NARROW, 37, 200, cfg.usd, nd, zd)
    passes(AT_VIEW, 200, 1001, cfg.usd, nd, zd, wanted=(b4,))
    passes(AT_D126, 200, 1001, cfg.usd, 126, 63, b23=True)

    gen = torch.Generator(device=dev).manual_seed(6)
    _, _, arms = crop(200, 1001)
    _, _, arms37 = crop(37, 1001)

    def rand(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    chk.suffix = AT_D130
    record_hpass(chk, b4, rand((37, 1001, 130), 0, 256, torch.uint8),
                 arms37, cfg.usd)
    record_hpass(chk, b6, rand((37, 1001, 130), 0, 17_600, torch.int32),
                 arms37, cfg.usd, zd=65)
    chk.suffix = AT_WRAP
    record_hpass(chk, b4, rand((200, 1001, nd), 240, 256, torch.uint8), arms,
                 cfg.usd)
    chk.suffix = AT_TIES
    ties = rand((200, 1001, nd), 0, 2, torch.int32)
    disp = record_hpass(chk, b6, ties, arms, cfg.usd, zd=zd)
    sums = band.h_pass_sum_plain(ties, arms[2], arms[3], 0, cfg.usd)
    last = nd - 1 - torch.argmin(sums.flip(2), dim=2)
    tied = float((last - zd != disp).float().mean())
    print(f"  ties: the last minimum differs from the first at {tied:.4f} "
          f"of the pixels", flush=True)
    if tied < 0.01:
        raise SmokeFailure("B6 ties: too few ties to test the first-min "
                           "rule")
    chk.suffix = ""


def check_cost_d130(chk, img_l, img_r, cfg):
    """B2's pair at D=130 (nine groups of 16 disparities, the scalar
    stores) on a 37x1001 crop of the frame's middle rows."""
    y0 = img_l.shape[0] // 2
    l, r = (t[y0:y0 + 37, :1001].contiguous() for t in (img_l, img_r))
    record_cost(chk, "B2 cost_pair" + B2_D130,
                cost_args(l, r, cfg.replace(num_disp=130, zero_disp=65)))


def check_cost_chunk(chk, img_l, img_r, cfg):
    """B2 on the third row chunk of the 4K preset's stereo core, given the
    whole frame's images: the census of its first and last rows reads
    rows outside the chunk, which a kernel that clamped at the chunk's
    edges would get wrong."""
    from stereo_to_multiview_tpu_torch.ops import band
    ext, bounds = band.chunk_bounds(cfg.num_rows, cfg.band_row_chunk,
                                    2 * cfg.usd)
    start = bounds[2][0]
    if (start, ext) != (1012, 680):
        raise SmokeFailure(f"the 4K preset's third chunk is rows "
                           f"[{start}, {start + ext}), not [1012, 1692)")
    pair = record_cost(chk, "B2 cost_pair" + B2_CHUNK4K,
                       cost_args(img_l, img_r, cfg), rows=(start, ext))
    record_shear(chk, "B3 shear_right" + B2_CHUNK4K, pair, cfg.zero_disp)


def check_shear_edges(chk, img_l, img_r, cfg):
    """B3 (`B3_EDGES`) on the pair volumes of crops of the frame's middle
    rows: zd = 0 and zd = D, W below one ring tile, D=130 and D=132, and
    int16 (qscale 510) and float32 pairs."""
    from stereo_to_multiview_tpu_torch.ops import costkern
    y0 = img_l.shape[0] // 2
    nd = cfg.num_disp
    for suffix, rows, cols, d, zd, qscale, quant in (
            (B3_EDGES[0], 200, 1001, nd, 0, 127.0, True),
            (B3_EDGES[1], 200, 1001, nd, nd, 127.0, True),
            (B3_EDGES[2], 37, 20, nd, cfg.zero_disp, 127.0, True),
            (B3_EDGES[3], 37, 1001, 130, 65, 127.0, True),
            (B3_EDGES[4], 37, 1001, 132, 66, 127.0, True),
            (B3_EDGES[5], 200, 1001, nd, 0, 510.0, True),
            (B3_EDGES[6], 37, 20, nd, cfg.zero_disp, 510.0, True),
            (B3_EDGES[7], 200, 1001, nd, nd, 127.0, False),
            (B3_EDGES[8], 37, 20, nd, cfg.zero_disp, 127.0, False)):
        l, r = (t[y0:y0 + rows, :cols].contiguous() for t in (img_l, img_r))
        pair = costkern.cost_pair(l, r, cfg.ad_coeff, cfg.census_coeff, d,
                                  zd, qscale=qscale, quant=quant)
        record_shear(chk, "B3 shear_right" + suffix, pair, zd)


def check_hslo_edges(chk, img_l, img_r, cfg):
    """B13 (`B13_EDGES`) on the pass-4 volumes of crops of the frame's
    middle rows (random volumes at D=30, 126 and 130, where the frame's
    costs have no such D), at strong penalties (P2 a quarter of the
    crop's median distance from a pixel's mean sum to its least, P1 = P2
    / 3) unless the entry sets them."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern, cross
    from stereo_to_multiview_tpu_torch.ops import hslo, hslokern
    from stereo_to_multiview_tpu_torch.ops.mux import mux_average

    dev = img_l.device
    y0 = img_l.shape[0] // 2
    usd, nd, zd, T = cfg.usd, cfg.num_disp, cfg.zero_disp, cfg.hslo_T
    gen = torch.Generator(device=dev).manual_seed(13)

    def crop(rows, cols):
        l, r = (t[y0:y0 + rows, :cols].contiguous() for t in (img_l, img_r))
        return l, r, mux_average(l), mux_average(r)

    def volume(l, r):
        """The left eye's pass-4 volume of a crop's own pair."""
        m = costkern.pair_margin(nd, zd)
        pair = costkern.cost_pair(*cost_args(l, r, cfg))
        arms = cross.cross_arms(l, cfg.ucd, cfg.lcd, usd, cfg.lsd)
        return band.band_aggregate_q(pair[:, m:m + l.shape[1]], arms, usd,
                                     None, cfg.band_digits, cfg.band_qscale)

    def strong(vol):
        f = vol.to(torch.float32)
        h2 = max(1.0, float((f.mean(dim=2) - f.amin(dim=2)).median()) / 4.0)
        return h2 / 3.0, h2

    def rand(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def record(suffix, vol, ga, gb, d, z, pen, sign):
        args = (vol, ga, gb, d, z, T, *pen, sign)
        out = hslokern.dc_hslo_wta(*args)
        h, w = ga.shape
        chk.record("B13 dc_hslo_wta" + suffix, out,
                   hslokern.dc_hslo_wta_plain(*args),
                   lambda: hslokern.dc_hslo_wta(*args),
                   lambda: hslokern.dc_hslo_wta_plain(*args),
                   nbytes=h * w * d * 4 + 2 * h * w + h * w * 4,
                   ops=2 * 12 * h * w * d, plain_once=True)
        return out

    l, r, gl, gr = crop(37, 1001)
    vol = volume(l, r)
    pen = strong(vol)
    record(B13_EDGES[0], vol, gl, gr, nd, zd, pen, +1)
    for suffix, cols in zip(B13_EDGES[1:4], (1, 15, 17)):
        record(suffix, vol[:, :cols].contiguous(), gl[:, :cols].contiguous(),
               gr[:, :cols].contiguous(), nd, zd, pen, +1)
    l, r, gl, gr = crop(200, 1001)
    for suffix, d, sign in ((B13_EDGES[4], 30, -1), (B13_EDGES[5], 126, -1)):
        v = rand((200, 1001, d), 17_600)
        record(suffix, v, gr, gl, d, d // 2, strong(v), sign)
    gl37, gr37 = gl[:37].contiguous(), gr[:37].contiguous()
    for suffix, sign in ((B13_EDGES[6], +1), (B13_EDGES[7], -1)):
        v = rand((37, 1001, 130), 17_600)
        ga, gb = (gl37, gr37) if sign > 0 else (gr37, gl37)
        record(suffix, v, ga, gb, 130, 65, strong(v), sign)
    vol = volume(l, r)
    out = record(B13_EDGES[8], torch.full_like(vol, 1000), gl, gr, nd, zd,
                 strong(vol), +1)
    if not bool((out == -zd).all()):
        raise SmokeFailure("B13 equal costs: not the first disparity")
    ties = rand(vol.shape, 2) * 7
    record(B13_EDGES[9], ties, gl, gr, nd, zd, (1.0, 3.0), +1)
    a = hslo.dc_hslo_hwd(ties, gl, gr, nd, zd, T, 1.0, 3.0, +1)
    last = nd - 1 - torch.argmin(a.flip(2), dim=2)
    tied = float((last != torch.argmin(a, dim=2)).float().mean())
    print(f"  B13 ties: the last minimum differs from the first at "
          f"{tied:.4f} of the pixels", flush=True)
    if tied < 0.01:
        raise SmokeFailure("B13 ties: too few ties to test the first-min "
                           "rule")
    del a, ties
    record(B13_EDGES[10], vol, gl, gr, nd, zd, (0.0, 0.0), +1)
    big = float(vol.max()) * 4.0 + 1.0
    record(B13_EDGES[11], vol, gl, gr, nd, zd, (big, big), +1)
    torch.cuda.empty_cache()


def record_dcc(chk, name, dl, dr, thresh=None):
    """One B7 entry: the labels (`dr_dcc`) with a threshold, else the
    occlusion hits (`dibr_occl`), timed from a CUDA graph (the occlusion
    kernels run shorter than their wrappers' host time).  Bound: both
    disparity planes read and both u8 planes written once, or ~10
    operations a pixel and eye for the labels (4 for the hits).  Returns
    the kernel's output."""
    from stereo_to_multiview_tpu_torch.ops import dcc, dibr
    hw = dl.numel()
    if thresh is None:
        kern = lambda: dibr.dibr_occl(dl, dr)
        plain = lambda: dibr.dibr_occl_plain(dl, dr)
    else:
        kern = lambda: dcc.dr_dcc(dl, dr, thresh)
        plain = lambda: dcc.dr_dcc_plain(dl, dr, thresh)
    got = kern()
    chk.record(name, got, plain(), kern, plain, nbytes=2 * hw * 4 + 2 * hw,
               ops=2 * hw * (4 if thresh is None else 10), graph=True)
    return got


def bleed_ops(hw: int, radius: int) -> int:
    """Integer operations of one eye's bleed: a row and a column sum of
    2r + 1 terms and two more (the compare, the select) a pixel."""
    return hw * (2 * (2 * radius + 1) + 2)


def record_bleed(chk, name, occl, radius: int):
    """One entry of B11's u8 entry.  Bound: the plane read and the mask
    written once, or `bleed_ops`.  Returns the mask."""
    from stereo_to_multiview_tpu_torch.ops import dibr
    hw = occl.numel()
    got = dibr.dibr_bleed_mask(occl, radius)
    chk.record(name, got, dibr.dibr_bleed_mask_plain(occl, radius),
               lambda: dibr.dibr_bleed_mask(occl, radius),
               lambda: dibr.dibr_bleed_mask_plain(occl, radius),
               nbytes=hw + hw * 4, ops=bleed_ops(hw, radius), graph=True)
    return got


def record_occl_masks(chk, name, dl, dr, radius: int):
    """One entry of the fused occlusion stage (B7's hits and B11's bleed
    of both eyes).  Bound: both disparity planes read and both masks
    written once, or each eye's scatter (two operations a pixel) and
    `bleed_ops`.  Returns (mask_l, mask_r)."""
    from stereo_to_multiview_tpu_torch.ops import dibr
    hw = dl.numel()
    got = dibr.dibr_occl_masks(dl, dr, radius)
    chk.record(name, got, dibr.dibr_occl_masks_plain(dl, dr, radius),
               lambda: dibr.dibr_occl_masks(dl, dr, radius),
               lambda: dibr.dibr_occl_masks_plain(dl, dr, radius),
               nbytes=4 * hw * 4, ops=2 * (2 * hw + bleed_ops(hw, radius)),
               graph=True)
    return got


def has_fused_occl() -> bool:
    """Whether the package under test fuses the occlusion stage (an older
    checkout's, timed with --package-root, may not)."""
    from stereo_to_multiview_tpu_torch.ops import dibr
    return hasattr(dibr, "dibr_occl_masks")


def check_many_views(chk, img_l, img_r, bl, br, cfg):
    """B12 (both modes), B14 and B19 with 38 intermediate views
    (num_views=40, more than one kernel argument block of 32 views
    holds; B19 one launch for all of them), on a 200x1001 crop of a
    frame's images and final disparities."""
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
    from stereo_to_multiview_tpu_torch.ops import dibr, warpkern

    y0 = img_l.shape[0] // 2
    l, r, dl, dr = (t[y0:y0 + 200, :1001].contiguous()
                    for t in (img_l, img_r, bl, br))
    hw = 200 * 1001
    shifts = _synth_shifts(40)
    occl = dibr.dibr_occl(dl, dr)
    mask_l, mask_r = (dibr.dibr_bleed_mask(o, cfg.bleed_radius) for o in occl)
    feathered = dibr.dibr_feather_mask(mask_r, cfg.feather_radius,
                                       cfg.feather_sigma)
    chk.suffix = AT_VIEWS38
    wargs = (l, r, dl, dr, mask_l, mask_r, feathered, shifts)
    views = dibr.warp_merge_views(*wargs)
    chk.record("B12 warp_merge_views", views,
               dibr.warp_merge_views_plain(*wargs),
               lambda: dibr.warp_merge_views(*wargs),
               lambda: dibr.warp_merge_views_plain(*wargs),
               nbytes=2 * hw * 3 + 5 * hw * 4 + views.numel(),
               ops=views.numel() * 20)
    record_interlace(chk, B12I, wargs[:7], 40, 200, 1001, cfg.angle)
    uargs = (l, r, dl, dr, shifts)
    vab = dibr.warp_views(*uargs)
    chk.record("B14 warp_views", vab, dibr.warp_views_plain(*uargs),
               lambda: dibr.warp_views(*uargs),
               lambda: dibr.warp_views_plain(*uargs),
               nbytes=2 * hw * 3 + 2 * hw * 4 + 2 * vab[0].numel() * 4,
               ops=2 * vab[0].numel() * 8)
    bargs = (l, r, dl, dr, shifts, cfg.num_disp, cfg.zero_disp)
    # every view in one launch
    reset_counts()
    warpkern.dibr_warp_views_kern(*bargs)
    read_counts(WARP_RM + " num_views=40", {"dibr_warp_views_kern": 1})
    record_b19(chk, B19, *bargs)
    chk.suffix = ""


def check_disp_kernels(chk, img_l, img_r, arms_l, arms_r, cfg):
    """B7 (labels), B8, B9 and B10 on the inputs a path gives them: the
    stage outputs of one frame computed with the kernels; on the main
    path's own frame (no suffix) also B8 and B9 in every IRV round and
    B10 at the edges.  Returns both eyes' filtered disparities."""
    from stereo_to_multiview_tpu_torch.ops import filters
    from stereo_to_multiview_tpu_torch.ops.band import (
        band_stereo_core_chunked)

    dl, dr = band_stereo_core_chunked(img_l, img_r, arms_l, arms_r, cfg)
    labels = record_dcc(chk, "B7 dr_dcc (labels)", dl, dr, cfg.dcc_thresh)
    chk.raw = (dl, dr, labels)
    record_dcc(chk, "B7 dibr_occl (hits, on dr_dcc's inputs)", dl, dr)

    dl_irv, dr = check_irv(chk, dl, dr, labels, arms_l, arms_r, cfg)
    if not chk.suffix:             # the main path's own frame
        chk.irv_rounds = check_irv_rounds(chk, dl, labels[0], arms_l, cfg)
    r = cfg.bilateral_radius
    bl = record_bilateral(chk, "B10 filter_bilateral", dl_irv, r, cfg)
    if not chk.suffix:
        check_bilateral_edges(chk, dl_irv, cfg)
    return bl, filters.filter_bilateral(dr, r, cfg.bilateral_sigma_color,
                                        cfg.bilateral_sigma_spatial)


# float32 operations of B12's merge: each (input point, intermediate
# view) needs the two warps' coordinates and weights (2 x 14), each
# (input point, view, channel) their 2-tap lerps (2 x 3), mask products
# (2) and the merge (3)
POINT_VIEW_OPS, POINT_CHANNEL_OPS = 28, 11


def record_feather(chk, name, mask_r, radius: int, sigma: float):
    """One G1 entry.  Bound: the mask read and the feather written once,
    or the 2 x (2r + 1) taps' product and sum a pixel at the float32 rate
    without contraction (every operation rounded on its own).  Returns
    the feathered mask."""
    from stereo_to_multiview_tpu_torch.ops import dibr
    hw = mask_r.numel()
    got = dibr.dibr_feather_mask(mask_r, radius, sigma)
    chk.record(name, got, dibr.dibr_feather_mask_plain(mask_r, radius, sigma),
               lambda: dibr.dibr_feather_mask(mask_r, radius, sigma),
               lambda: dibr.dibr_feather_mask_plain(mask_r, radius, sigma),
               nbytes=2 * hw * 4, ops=2 * (2 * radius + 1) * 2 * hw,
               ops_rate=PEAK_FP32_NOFMA_PER_S)
    return got


# float32 operations an output subpixel of a rescale: three lerps of four
# (1 - w, two products, the sum)
G2_OPS = 12


def g2_input_pixels(h: int, w: int, rows: int, cols: int) -> int:
    """Input pixels a rescale of (h, w) to (rows, cols) reads: the rows
    and columns its taps name (both taps of every output, as the plain
    version gathers them; every pixel at 2:1, two rows for one output
    row)."""
    from stereo_to_multiview_tpu_torch.ops.scale import lerp_taps

    def named(n_out, n_in):
        i0, i1, _ = lerp_taps(n_out, n_in, "cpu")
        return len(set(i0.tolist()) | set(i1.tolist()))

    if (h, w) == (rows, cols):
        return h * w
    return named(rows, h) * named(cols, w)


def record_tx_scale(chk, name, img_l, img_r, rows: int, cols: int):
    """One G2 downscale entry: both eyes' (H, W, 3) u8 images to (rows,
    cols) in one launch against the plain rescale of each.  Bound: the
    input pixels the taps name read and each output written once.
    Returns the kernel's images."""
    from stereo_to_multiview_tpu_torch.ops import scale
    h, w, c = img_l.shape
    got = scale.tx_scale_bilinear_lr(img_l, img_r, rows, cols)
    plain = lambda: tuple(scale.tx_scale_bilinear(t, rows, cols)
                          for t in (img_l, img_r))
    chk.record(name, got, plain(),
               lambda: scale.tx_scale_bilinear_lr(img_l, img_r, rows, cols),
               plain, nbytes=2 * c * (g2_input_pixels(h, w, rows, cols)
                                      + rows * cols),
               ops=2 * c * rows * cols * G2_OPS, graph=True, events=True)
    return got


def record_disp_scale(chk, name, disp_l, disp_r, rows: int, cols: int,
                      disp_scale: float):
    """One G2 upscale entry: both eyes' (H, W) float32 disparities to
    (rows, cols) times disp_scale in one launch against the plain rescale
    of each, in every bit.  Bound: the input pixels the taps name read
    and each output written once (the lerps and the product: G2_OPS + 1
    operations an output).  Returns the kernel's disparities."""
    from stereo_to_multiview_tpu_torch.ops import scale
    h, w = disp_l.shape
    args = (rows, cols, disp_scale)
    got = scale.tx_disp_scale_lr(disp_l, disp_r, *args)
    plain = lambda: tuple(scale.tx_disp_scale(d, *args)
                          for d in (disp_l, disp_r))
    chk.record(name, got, plain(),
               lambda: scale.tx_disp_scale_lr(disp_l, disp_r, *args), plain,
               nbytes=2 * 4 * (g2_input_pixels(h, w, rows, cols)
                               + rows * cols),
               ops=2 * rows * cols * (G2_OPS + 1), graph=True,
               events=True, bits=True)
    return got


def check_scale_edges(chk, img_l, img_r, dl, dr, bl, br, disp_scale: float):
    """G2 beyond the lowres preset's shapes (`G2D_EDGES`, `G2U_EDGES`):
    the 1080p pair down to a non-integer ratio, one row and one column,
    its 2160x3840 tiling down to 1080p; the 540x960 disparities `dl`, `dr`
    up to a non-integer ratio, one row and one column, their 1080p upscale
    `bl`, `br` up to 2160x3840."""
    import torch
    for suffix, (src, rows, cols) in G2D_EDGES.items():
        eyes = (img_l, img_r) if src == "1080p" else tuple(
            t.repeat(2, 2, 1).contiguous() for t in (img_l, img_r))
        record_tx_scale(chk, G2D[:G2D.index(" (")] + suffix, *eyes, rows,
                        cols)
        del eyes
    for suffix, (src, rows, cols) in G2U_EDGES.items():
        eyes = (dl, dr) if src == "low" else (bl, br)
        record_disp_scale(chk, G2U[:G2U.index(" (")] + suffix, *eyes, rows,
                          cols, disp_scale)
    torch.cuda.empty_cache()


def interlace_ops(h: int, w: int, num_views: int, rows: int, cols: int,
                  angle: float, device) -> int:
    """Float32 operations that B12's interlace mode needs for an (h, w)
    input and a (rows, cols) output: POINT_VIEW_OPS for each distinct
    (input point, intermediate view) and POINT_CHANNEL_OPS for each
    distinct (input point, view, channel) that the frame's subpixels
    read, and the 9 of a resampled subpixel's three lerps.  A subpixel
    reads its view at its input point, or at a resampled output at the
    lerp taps of weight > 0 (`lerp_taps`); one of view 0 or V - 1 reads a
    source pixel and merges nothing."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import mux
    from stereo_to_multiview_tpu_torch.ops.scale import lerp_taps
    vid = mux.mux_view_pattern(num_views, rows, cols, angle, device)
    merged = (vid > 0) & (vid < num_views - 1)
    resampled = (rows, cols) != (h, w)

    def axis_taps(n_out, n_in):
        if not resampled:
            i = torch.arange(n_out, device=device)
            return [(i, torch.ones_like(i, dtype=torch.bool))]
        i0, i1, wt = lerp_taps(n_out, n_in, device)
        return [(i0, torch.ones_like(i0, dtype=torch.bool)), (i1, wt != 0)]

    point_view = torch.zeros(h * w * num_views, dtype=torch.bool,
                             device=device)
    point_channel = torch.zeros(h * w * num_views * 3, dtype=torch.bool,
                                device=device)
    ch = torch.arange(3, device=device)
    for iy, ky in axis_taps(rows, h):
        for ix, kx in axis_taps(cols, w):
            keep = merged & (ky[:, None] & kx[None, :])[:, :, None]
            pv = ((iy[:, None] * w + ix[None, :])[:, :, None] * num_views
                  + vid)[keep]
            point_view[pv] = True
            point_channel[pv * 3 + ch.expand_as(vid)[keep]] = True
            del keep, pv
    return (POINT_VIEW_OPS * int(point_view.sum())
            + POINT_CHANNEL_OPS * int(point_channel.sum())
            + (9 * rows * cols * 3 if resampled else 0))


def record_interlace(chk, name, margs, num_views: int, rows: int, cols: int,
                     angle: float):
    """One entry of B12's interlace mode on (img_l, img_r, disp_l, disp_r,
    mask_l, mask_r, feathered) = `margs`.  Bound: the two images and the
    five float planes read once and the frame written once, or the
    float32 operations without contraction that the frame needs
    (`interlace_ops`)."""
    from stereo_to_multiview_tpu_torch.ops import dibr
    h, w = margs[0].shape[:2]
    iargs = (*margs, num_views, rows, cols, angle)
    got = dibr.warp_merge_interlace(*iargs)
    ops = interlace_ops(h, w, num_views, rows, cols, angle, got.device)
    chk.record(name, got, dibr.warp_merge_interlace_plain(*iargs),
               lambda: dibr.warp_merge_interlace(*iargs),
               lambda: dibr.warp_merge_interlace_plain(*iargs),
               nbytes=2 * h * w * 3 + 5 * h * w * 4 + got.numel(), ops=ops,
               ops_rate=PEAK_FP32_NOFMA_PER_S)


def check_synth_kernels(chk, img_l, img_r, bl, br, cfg, b14=True):
    """The occlusion stage (fused, and B7's hits and B11's u8 entry
    unfused), G1, B12 (its view stack and its interlace mode at the
    configuration's own output) and, with `b14`, B14 on a frame's images
    and filtered disparities.  Returns the inputs of the merge: (mask_l,
    mask_r, feathered)."""
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
    from stereo_to_multiview_tpu_torch.ops import dibr

    hw = img_l.shape[0] * img_l.shape[1]
    rb = cfg.bleed_radius
    if has_fused_occl():
        record_occl_masks(chk, B7B11, bl, br, rb)
    occl = record_dcc(chk, "B7 dibr_occl (hits)", bl, br)
    mask_l = record_bleed(chk, "B11 dibr_bleed_mask", occl[0], rb)
    mask_r = dibr.dibr_bleed_mask(occl[1], rb)

    feathered = record_feather(chk, "G1 dibr_feather", mask_r,
                               cfg.feather_radius, cfg.feather_sigma)
    wargs = (img_l, img_r, bl, br, mask_l, mask_r, feathered,
             _synth_shifts(cfg.num_views))
    views = dibr.warp_merge_views(*wargs)
    chk.record("B12 warp_merge_views", views,
               dibr.warp_merge_views_plain(*wargs),
               lambda: dibr.warp_merge_views(*wargs),
               lambda: dibr.warp_merge_views_plain(*wargs),
               nbytes=2 * hw * 3 + 5 * hw * 4 + views.numel(),
               ops=views.numel() * 20)
    del views
    record_interlace(chk, B12I, wargs[:7], cfg.num_views, cfg.num_rows_out,
                     cfg.num_cols_out, cfg.angle)
    if b14:
        uargs = (img_l, img_r, bl, br, _synth_shifts(cfg.num_views))
        vab = dibr.warp_views(*uargs)
        chk.record("B14 warp_views", vab, dibr.warp_views_plain(*uargs),
                   lambda: dibr.warp_views(*uargs),
                   lambda: dibr.warp_views_plain(*uargs),
                   nbytes=2 * hw * 3 + 2 * hw * 4 + 2 * vab[0].numel() * 4,
                   ops=2 * vab[0].numel() * 8)
    return mask_l, mask_r, feathered


def check_view_stack_edges(chk, img_l, img_r, bl, br, masks, cfg):
    """B12's view stack at its edges (`B12V_EDGES`) on the 1080p frame's
    stages (`masks` from `check_synth_kernels`): 3 and 16 views, crops of
    37x1001, 37x1 and 37x17, masks and a feather outside [0, 1], the
    crop's views written into a view stack's middle views in place (a
    package without `out=` copies its result there), and two rows tiled
    21 times across (40320 columns)."""
    import inspect
    import torch
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
    from stereo_to_multiview_tpu_torch.ops import dibr

    margs = (img_l, img_r, bl, br, *masks)
    y0 = img_l.shape[0] // 2

    def crop(rows, cols):
        return tuple(t[y0:y0 + rows, :cols].contiguous() for t in margs)

    def rec(suffix, args, nviews, kern=None):
        wargs = (*args, _synth_shifts(nviews))
        hw = args[0].shape[0] * args[0].shape[1]
        kern = kern or (lambda: dibr.warp_merge_views(*wargs))
        ref = dibr.warp_merge_views_plain(*wargs)
        chk.record(B12V + suffix, kern(), ref, kern,
                   lambda: dibr.warp_merge_views_plain(*wargs),
                   nbytes=2 * hw * 3 + 5 * hw * 4 + ref.numel(),
                   ops=ref.numel() * 20)

    v = cfg.num_views
    rec(B12V_EDGES[0], margs, 3)
    rec(B12V_EDGES[1], margs, 16)
    c37 = crop(37, 1001)
    rec(B12V_EDGES[2], c37, v)
    rec(B12V_EDGES[3], crop(37, 1), v)
    rec(B12V_EDGES[4], crop(37, 17), v)
    # masks of 0 and 1.5, a feather in [-0.25, 1.25]
    rec(B12V_EDGES[5], (*c37[:4], c37[4] * 1.5, c37[5], c37[6] * 1.5 - 0.25),
        v)
    stack = torch.empty((v, *c37[0].shape), dtype=torch.uint8,
                        device=img_l.device)
    mids = stack[1:-1]
    if c37[0].shape[:2] == (37, 1001) and mids.data_ptr() % 16 == 0:
        raise SmokeFailure("B12: the 37x1001 stack's middle views are "
                           "16-byte aligned")
    wargs = (*c37, _synth_shifts(v))
    if "out" in inspect.signature(dibr.warp_merge_views).parameters:
        kern = lambda: dibr.warp_merge_views(*wargs, out=mids)
    else:
        kern = lambda: mids.copy_(dibr.warp_merge_views(*wargs))
    rec(B12V_EDGES[6], c37, v, kern)
    wide = tuple(t[y0:y0 + 2].repeat(1, 21, *[1] * (t.dim() - 2))
                 .contiguous() for t in margs)
    rec(B12V_EDGES[7], wide, v)


def check_synth_edges(chk, img_l, img_r, bl, br, masks, cfg):
    """B12's interlace mode and G1 beyond the 1080p main path's own
    shapes, on its frame's stages (`masks` from `check_synth_kernels`):
    the HSLO_4K preset's 2160x3840 output from these 1080p views, two
    views, a 37x1001 crop (also with masks and a feather outside [0, 1]),
    a shrunk output, another angle; the feather
    at r = 0 and 1, on a 37x15 crop and at r = 40 and 70 on a 200x1001
    crop."""
    import torch
    from stereo_to_multiview_tpu_torch.config import HD1080_D128_HSLO_4K
    margs = (img_l, img_r, bl, br, *masks)
    v, angle = cfg.num_views, cfg.angle
    hcfg = HD1080_D128_HSLO_4K
    record_interlace(chk, B12I + B12I_HSLO, margs, hcfg.num_views,
                     hcfg.num_rows_out, hcfg.num_cols_out, hcfg.angle)
    torch.cuda.empty_cache()
    record_interlace(chk, B12I + B12I_EDGES[0], margs, 2, cfg.num_rows_out,
                     cfg.num_cols_out, angle)
    y0 = img_l.shape[0] // 2
    crop = tuple(t[y0:y0 + 37, :1001].contiguous() for t in margs)
    record_interlace(chk, B12I + B12I_EDGES[1], crop, v, 37, 1001, angle)
    record_interlace(chk, B12I + B12I_EDGES[2], margs, v, 720, 1280, angle)
    record_interlace(chk, B12I + B12I_EDGES[3], margs, v, cfg.num_rows_out,
                     cfg.num_cols_out, 30.0)
    # masks of 0 and 1.5, a feather in [-0.25, 1.25]
    odd = (*crop[:4], crop[4] * 1.5, crop[5], crop[6] * 1.5 - 0.25)
    record_interlace(chk, B12I + B12I_EDGES[4], odd, v, 37, 1001, angle)
    mask_r = masks[1]
    for suffix, r in G1_EDGES.items():
        m = (mask_r[y0:y0 + 37, :15] if "37x15" in suffix else
             mask_r[y0:y0 + 200, :1001] if "200x1001" in suffix else mask_r)
        record_feather(chk, "G1 dibr_feather" + suffix, m.contiguous(), r,
                       cfg.feather_sigma)


def check_occl_edges(chk, bl, br, cfg):
    """The occlusion kernels beyond the presets' shapes, on crops and
    tilings of the 1080p frame's final disparities (`bl`, `br`) and on
    made-up planes (OCCL_CROPS, OCCL_RADII, OCCL_DISPS, OCCL_WIDE,
    B11_EDGES).  A package without the fused stage (an older checkout's)
    runs only the unfused entries on the crops and made-up planes, not
    the wide ones: its B7 refused planes wider than 24,576 columns."""
    import torch
    fused = has_fused_occl()
    dev, thresh, rb = bl.device, cfg.dcc_thresh, cfg.bleed_radius
    y0 = bl.shape[0] // 2

    def all_three(suffix, dl, dr, radius=rb, b7_suffix=None):
        if fused:
            record_occl_masks(chk, B7B11 + suffix, dl, dr, radius)
        if fused or b7_suffix is None:
            b7_suffix = b7_suffix or suffix
            record_dcc(chk, "B7 dr_dcc (labels)" + b7_suffix, dl, dr, thresh)
            record_dcc(chk, "B7 dibr_occl (hits)" + b7_suffix, dl, dr)

    for suffix, (h, w) in OCCL_CROPS.items():
        all_three(suffix, *(t[y0:y0 + h, :w].contiguous() for t in (bl, br)))
    if fused:
        for suffix, r in OCCL_RADII.items():
            record_occl_masks(chk, B7B11 + suffix, bl, br, r)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    rand = lambda: torch.rand((200, 1001), generator=g, device=dev)
    # past a border: |d| beyond the row, some past int32, both signs
    past = [torch.where(rand() < 0.5, 1.0, -1.0) * (1001.0 + rand() * 50)
            for _ in range(2)]
    for d in past:
        d[rand() < 0.05] = 3e9
        d[rand() < 0.05] = -3e9
    zero = torch.zeros((200, 1001), device=dev)
    negative = [-(rand() * 60.0) for _ in range(2)]
    for suffix, (dl, dr) in zip(OCCL_DISPS, (past, (zero, zero), negative)):
        all_three(suffix, dl.contiguous(), dr.contiguous())
    for suffix, b7_suffix, h, w, r in OCCL_WIDE:
        reps = -(-w // bl.shape[1])
        all_three(suffix, *(t[y0:y0 + h].repeat(1, reps)[:, :w].contiguous()
                            for t in (bl, br)), radius=r, b7_suffix=b7_suffix)
        torch.cuda.empty_cache()
    # B11's u8 entry on 0, 1 and 2 (a 2 counts, but is no 1)
    vals = torch.randint(0, 3, bl.shape, generator=g, device=dev,
                         dtype=torch.uint8)
    record_bleed(chk, "B11 dibr_bleed_mask" + B11_EDGES[0],
                 vals[y0:y0 + 37, :15].contiguous(), rb)
    record_bleed(chk, "B11 dibr_bleed_mask" + B11_EDGES[1], vals, 3)


def check_band_digits(chk, img_l, img_r, arms, cfg):
    """B4-B6 on the left eye at the rescale shifts of band_digits 2 and 1
    (at usd=34: (0, 6, 6) and (7, 6, 6); the path's own are (0, 3, 6))."""
    from stereo_to_multiview_tpu_torch.ops import band, costkern
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN

    h, w = img_l.shape[:2]
    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    hw, hwd = h * w, h * w * nd
    m = costkern.pair_margin(nd, zd)
    pair = costkern.cost_pair(*cost_args(img_l, img_r, cfg))
    cost_l = pair[:, m:m + w]
    ud = (arms[UP], arms[DOWN])
    for digits in (2, 1):
        s1, s2, s3 = band.agg_rescale_shifts(usd, digits)
        tag = f", band_digits={digits} shifts)"
        a1 = record_hpass(chk, "B4 h_pass_sum (pass 1" + tag, cost_l, arms,
                          usd, s1)
        a2 = band.vv_pass(a1, *ud, s2, s3, usd)
        chk.record("B5 vv_pass (passes 2+3" + tag, a2,
                   band.vv_pass_plain(a1, *ud, s2, s3, usd),
                   lambda: band.vv_pass(a1, *ud, s2, s3, usd),
                   lambda: band.vv_pass_plain(a1, *ud, s2, s3, usd),
                   nbytes=hwd * 4 + 2 * hw * 4 + hwd * 4, ops=2 * 4 * hwd)
        del a1
        record_hpass(chk, "B6 h_pass_wta (pass 4 + WTA" + tag, a2, arms, usd,
                     zd=zd)
        print(f"  band_digits={digits}: shifts {(s1, s2, s3)}, pass-3 "
              f"values up to {int(a2.max())}", flush=True)
        del a2


def check_band_dials(chk, img_l, img_r, arms, cfg):
    """The modes of the band_qscale and band_lossy_wta dials on a frame
    (the left eye's arms for the passes): B2's int16 pair (qscale 510) and
    float32 pair, and both eyes directly in u8, int16 and float32; B3 on
    the int16 and float32 pairs; B4 on the int16 left eye at the
    qscale-510 shifts of band_digits 3, 2 and 1 (usd=34: s1 = 0, 2, 9);
    B6's lossy WTA at the default qscale's shifts of band_digits 3, 2 and
    1; then B6's lossy WTA on a crop's inputs that the bf16 rounding turns
    into ties."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern, cross
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    h, w = img_l.shape[:2]
    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    m = costkern.pair_margin(nd, zd)
    cargs = cost_args(img_l, img_r, cfg)
    for label, q, quant in (("int16, qscale 510", 510.0, True),
                            ("float32", 127.0, False)):
        pair = record_cost(chk, f"B2 cost_pair (pair, {label})", cargs, q,
                           quant)
        record_shear(chk, f"B3 shear_right ({label})", pair, zd,
                     library=True)
        for digits in (3, 2, 1) if quant else ():
            s1 = band.agg_rescale_shifts(usd, digits, q)[0]
            a1 = record_hpass(
                chk, f"{B4I[:-1]}, qscale=510 band_digits={digits} shifts)",
                pair[:, m:m + w], arms, usd, s1)
            print(f"  int16 costs up to {int(pair.max())}: pass 1 at s1 = "
                  f"{s1}, sums up to {int(a1.max())}", flush=True)
            del a1
        del pair
        torch.cuda.empty_cache()
    for mode, q, quant in DIAL_MODES:
        for eye, side in (("l", "left"), ("r", "right")):
            record_cost(chk, f"B2 cost_pair ({side} eye {mode}, direct)",
                        cargs, q, quant, eye)
        torch.cuda.empty_cache()

    cost_l = costkern.cost_pair(*cargs)[:, m:m + w]
    lr, ud = (arms[LEFT], arms[RIGHT]), (arms[UP], arms[DOWN])
    for digits in (3, 2, 1):
        s1, s2, s3 = band.agg_rescale_shifts(usd, digits)
        a2 = band.vv_pass(band.h_pass_sum(cost_l, *lr, s1, usd), *ud, s2, s3,
                          usd)
        lossy = record_hpass(chk, f"{B6L[:-1]}, band_digits={digits} shifts)",
                             a2, arms, usd, zd=zd, lossy=True)
        moved = float((lossy != band.h_pass_wta(a2, *lr, zd, usd))
                      .float().mean())
        print(f"  band_lossy_wta at band_digits={digits}: pass-4 inputs up "
              f"to {int(a2.max())}; {moved:.5f} of the disparities differ "
              f"from the exact WTA's", flush=True)
        del a2
    del cost_l

    # inputs in [100000, 100256) round to two bf16 values (512 apart)
    y0 = h // 2
    crop = img_l[y0:y0 + 200, :1001].contiguous()
    carms = cross.cross_arms(crop, cfg.ucd, cfg.lcd, usd, cfg.lsd)
    gen = torch.Generator(device=img_l.device).manual_seed(7)
    vol = torch.randint(100_000, 100_256, (*crop.shape[:2], nd),
                        generator=gen, device=img_l.device,
                        dtype=torch.int32)
    chk.suffix = AT_TIES
    disp = record_hpass(chk, B6L, vol, carms, usd, zd=zd, lossy=True)
    chk.suffix = ""
    sums = band.h_pass_sum_plain(band.round_bf16(vol), carms[LEFT],
                                 carms[RIGHT], 0, usd)
    last = nd - 1 - torch.argmin(sums.flip(2), dim=2)
    tied = float((last - zd != disp).float().mean())
    print(f"  lossy ties: the last minimum differs from the first at "
          f"{tied:.4f} of the pixels", flush=True)
    if tied < 0.01:
        raise SmokeFailure("B6 lossy ties: too few ties to test the "
                           "first-min rule")


def check_dial_edges(chk, img_l, img_r, cfg):
    """The dials' modes where the streams and vector paths end, on crops
    of the frame's middle rows: 37x1001 (B4 on int16 costs, B6's lossy
    WTA); the 200x1001 crop's own pair at D=126 (scalar loads and stores:
    B2 and B3 in int16 and float32, B4 int16, B6 lossy); and random int16
    costs in 32000..32767, whose windows carry B4's u32 prefixes past
    2^16."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern, cross
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    usd = cfg.usd
    y0 = img_l.shape[0] // 2
    arm_args = (cfg.ucd, cfg.lcd, usd, cfg.lsd)
    for suffix, rows, nd, zd in ((AT_SHORT, 37, cfg.num_disp, cfg.zero_disp),
                                 (AT_D126, 200, 126, 63)):
        chk.suffix = suffix
        l, r = (t[y0:y0 + rows, :1001].contiguous() for t in (img_l, img_r))
        arms = cross.cross_arms(l, *arm_args)
        cargs = cost_args(l, r, cfg.replace(num_disp=nd, zero_disp=zd))
        m = costkern.pair_margin(nd, zd)
        if suffix == AT_D126:
            for label, q, quant in (("int16, qscale 510", 510.0, True),
                                    ("float32", 127.0, False)):
                pair = record_cost(chk, f"B2 cost_pair (pair, {label})",
                                   cargs, q, quant)
                record_shear(chk, f"B3 shear_right ({label})", pair, zd)
        pair = costkern.cost_pair(*cargs, qscale=510.0)
        s1 = band.agg_rescale_shifts(usd, 3, 510.0)[0]
        wc = l.shape[1]
        record_hpass(chk, B4I, pair[:, m:m + wc], arms, usd, s1)
        s1, s2, s3 = band.agg_rescale_shifts(usd, 3)
        lr = (arms[LEFT], arms[RIGHT])
        a1 = band.h_pass_sum(costkern.cost_pair(*cargs)[:, m:m + wc], *lr,
                             s1, usd)
        a2 = band.vv_pass(a1, arms[UP], arms[DOWN], s2, s3, usd)
        record_hpass(chk, B6L, a2, arms, usd, zd=zd, lossy=True)

    chk.suffix = AT_I16MAX
    gen = torch.Generator(device=img_l.device).manual_seed(16)
    l = img_l[y0:y0 + 200, :1001].contiguous()
    vol = torch.randint(32_000, 32_768, (*l.shape[:2], cfg.num_disp),
                        generator=gen, device=img_l.device,
                        dtype=torch.int16)
    out = record_hpass(chk, B4I, vol, cross.cross_arms(l, *arm_args), usd)
    chk.suffix = ""
    if int(out.max()) < 1 << 16:
        raise SmokeFailure("B4 int16: no window sum passed 2^16")


def run_xm_entry(img_l, img_r, cfg):
    """`ci_adcensus_kern_xm` as paths in each cost mode (u8, int16 at
    qscale 510, float32): shear=True (B2's pair volume, B3) equal to
    shear=False (B2 once an eye, directly) in every element of both eyes;
    both timed."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import costkern

    args = (img_l, img_r, cfg.ad_coeff, cfg.census_coeff, cfg.num_disp,
            cfg.zero_disp)
    res = {}
    for mode, q, quant in DIAL_MODES:
        kw = dict(quant=quant, qscale=q)
        reset_counts()
        got = costkern.ci_adcensus_kern_xm(*args, **kw)
        pair_launches = read_counts(XM_PAIR[mode], {"cost_pair": 1,
                                                    "shear_right": 1})
        reset_counts()
        ref = costkern.ci_adcensus_kern_xm(*args, shear=False, **kw)
        eye_launches = read_counts(XM_EYES[mode], {"cost_pair": 2},
                                   zero=("shear_right",))
        for eye, a, b in (("left", got[0], ref[0]), ("right", got[1],
                                                     ref[1])):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise SmokeFailure(f"path {XM_PAIR[mode]}: {eye} eye differs "
                                   f"from shear=False")
        del got, ref
        torch.cuda.empty_cache()
        for path, shear, launches in ((XM_PAIR[mode], True, pair_launches),
                                      (XM_EYES[mode], False, eye_launches)):
            res[path] = dict(launches=launches, xm_ms=time_ms(
                lambda: costkern.ci_adcensus_kern_xm(*args, shear=shear,
                                                     **kw), 3))
            torch.cuda.empty_cache()
        print(f"path {XM_PAIR[mode]}: equal to shear=False in both eyes; "
              f"{res[XM_PAIR[mode]]['xm_ms']:.3f} ms against "
              f"{res[XM_EYES[mode]]['xm_ms']:.3f} ms (whole entry: census, "
              f"kernels; CUDA events, mean of 3)", flush=True)
    return res


def dm_cost_fns(costkern, img_l, img_r):
    """(kern, plain): B16 and its plain version on the two images of a
    whole frame, called as (ad_coeff, census_coeff, D, zd, quant=True,
    eyes="lr", rows=None, cols=None, out=None), the interface of
    `cost_dm` since its census moved into the kernel (the right eye's one
    or two column ranges written into `out`).  For an older package whose
    `cost_dm` takes census codes, the frame's census is computed here
    once, beforehand (untimed), and handed over sliced to the rows, and
    each column range is one launch copied into place: the way
    `--band-checks --package-root` times the parent's kernels."""
    import inspect
    if "cen_l" not in inspect.signature(costkern.cost_dm).parameters:
        return (functools.partial(costkern.cost_dm, img_l, img_r),
                functools.partial(costkern.cost_dm_plain, img_l, img_r))
    from stereo_to_multiview_tpu_torch.ops.cost import census_transform_9x7
    from stereo_to_multiview_tpu_torch.ops.mux import mux_average
    cens = [census_transform_9x7(mux_average(t)) for t in (img_l, img_r)]

    def adapt(fn):
        def call(ad, cen, nd, zd, quant=True, eyes="lr", rows=None,
                 cols=None, out=None):
            start, count = rows or (0, img_l.shape[0])
            sl = slice(start, start + count)
            args = (img_l[sl], img_r[sl], cens[0][sl], cens[1][sl], ad,
                    cen, nd, zd, quant)
            if eyes != "r":
                return fn(*args, eyes=eyes)
            for x0, x1 in cols:
                out[:, :, x0:x1] = fn(*args, eyes="r", cols=(x0, x1))
            return out
        return call
    return adapt(costkern.cost_dm), adapt(costkern.ci_adcensus_stacked_plain)


def census_rows_read(h: int, rows) -> int:
    """The frame rows a row range's census reads: 3 either side, clamped
    to the frame."""
    start, count = rows or (0, h)
    return min(h, start + count + 3) - max(0, start - 3)


def record_dm_cost(chk, name, kern, plain, args, h, w, nd, quant=True,
                   rows=None):
    """One B16 entry of the stacked mode over a row range: bytes the
    images' rows the census reads (once) and the volume written."""
    count = rows[1] if rows else h
    kw = dict(quant=quant, rows=rows)
    vol2 = 2 * count * w * nd
    got = kern(*args, **kw)
    # per element: 3 abs-diffs, 2 xor + popcount, index, lookup
    chk.record(name, got, plain(*args, **kw), lambda: kern(*args, **kw),
               lambda: plain(*args, **kw),
               nbytes=2 * census_rows_read(h, rows) * w * 3
               + (766 * 49 if quant else 815 * 4) + vol2 * (1 if quant
                                                            else 4),
               ops=10 * vol2)
    return got


def check_dm_kernels(chk, img_l, img_r, arms_l, arms_r, cfg, full=True,
                     rows=None):
    """B16 and B18a-c on both eyes of a frame (or of a row chunk's
    extent, rows=(start, count) of the frame, `arms_*` those rows'): the
    stacked u8 cost and the three passes; with `full`, also the row-major
    pairs (u8 and float32) and pass 4 once more on a volume of tied
    planes."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern

    h, w = rows[1] if rows else img_l.shape[0], img_l.shape[1]
    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    hw, vol2 = h * w, 2 * h * w * nd          # elements of the (2D, H, W)
    coeffs = (cfg.ad_coeff, cfg.census_coeff, nd, zd)
    kern, plain = dm_cost_fns(costkern, img_l, img_r)
    cost2 = record_dm_cost(chk, "B16 cost_dm (stacked u8)", kern, plain,
                           coeffs, img_l.shape[0], w, nd, rows=rows)
    if full:

        def pair_plain(quant):
            v = plain(*coeffs, quant)
            return (v[:nd].permute(1, 2, 0).contiguous(),
                    v[nd:].permute(1, 2, 0).contiguous())

        # the entry point as a user calls it: census, kernel, and one
        # torch copy per eye into (H, W, D)
        for quant, label, size in ((True, "u8", 1), (False, "float32", 4)):
            pargs = (img_l, img_r, *coeffs, quant)
            got = costkern.ci_adcensus_kern(*pargs)
            ref = pair_plain(quant)
            chk.record(f"B16 ci_adcensus_kern (row-major pair {label})",
                       got, ref, lambda: costkern.ci_adcensus_kern(*pargs),
                       lambda: pair_plain(quant),
                       nbytes=2 * hw * 3 + vol2 * size, ops=10 * vol2)
            del got, ref

    _, s2, s3 = band.agg_rescale_shifts(usd, 2)
    arms = (arms_l, arms_r)
    p1 = band.pass1_dm(cost2, *arms, usd)
    chk.record("B18a pass1_dm", p1, band.pass1_dm_plain(cost2, *arms, usd),
               lambda: band.pass1_dm(cost2, *arms, usd),
               lambda: band.pass1_dm_plain(cost2, *arms, usd),
               nbytes=vol2 + 4 * hw * 4 + vol2 * 2, ops=3 * vol2)
    del cost2
    vv = band.vv_dm(p1, *arms, s2, s3, usd)
    chk.record("B18b vv_dm (passes 2+3)", vv,
               band.vv_dm_plain(p1, *arms, s2, s3, usd),
               lambda: band.vv_dm(p1, *arms, s2, s3, usd),
               lambda: band.vv_dm_plain(p1, *arms, s2, s3, usd),
               nbytes=vol2 * 2 + 4 * hw * 4 + vol2 * 2, ops=2 * 4 * vol2)
    del p1
    disp = band.pass4_wta_dm(vv, *arms, zd, usd)
    chk.record("B18c pass4_wta_dm", disp,
               band.pass4_wta_dm_plain(vv, *arms, zd, usd),
               lambda: band.pass4_wta_dm(vv, *arms, zd, usd),
               lambda: band.pass4_wta_dm_plain(vv, *arms, zd, usd),
               nbytes=vol2 * 2 + 4 * hw * 4 + 2 * hw * 4, ops=3 * vol2)
    if not full:
        return
    # ties: the volume cut to a few levels, and a block where every plane
    # is equal (a flat region's aggregate), where the first minimum is d=0
    tied = vv >> 11
    y0, y1, x0, x1 = h // 4, h // 2, w // 4, 3 * w // 4
    tied[:, y0:y1, x0:x1] = 7
    del vv
    tdisp = band.pass4_wta_dm(tied, *arms, zd, usd)
    chk.record("B18c pass4_wta_dm (tied planes)", tdisp,
               band.pass4_wta_dm_plain(tied, *arms, zd, usd),
               lambda: band.pass4_wta_dm(tied, *arms, zd, usd),
               lambda: band.pass4_wta_dm_plain(tied, *arms, zd, usd),
               nbytes=vol2 * 2 + 4 * hw * 4 + 2 * hw * 4, ops=3 * vol2)
    inner = tdisp[0][y0 + usd:y1 - usd, x0 + usd:x1 - usd]
    levels = int(tied.max()) + 1
    if not bool((inner == -zd).all()):
        raise SmokeFailure("B18c: a block of equal planes must give the "
                           "first disparity")
    print(f"  B18c tied planes: {levels} levels; the block of equal planes "
          f"gives d=0 at each of its {inner.numel()} inner pixels",
          flush=True)


def check_vdm_edges(chk, nd: int, dev):
    """B18b's edge entries (`VDM_EDGES`) on (2D, H, W) int16 volumes and
    arms drawn here: values in the range pass 1 gives them at the reach
    (at the ceiling entry, 30000..32767 under arms of 34: rescaled pass-2
    sums of ~33000), arms drawn from -2 to 5 past the reach."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band

    gen = torch.Generator(device=dev).manual_seed(1818)

    def entry(suffix, h, w, planes, reach, lo=0, hi=None, arm_lo=-2):
        hi = 254 * 2 * max(reach, 1) if hi is None else hi
        vol = torch.randint(lo, hi, (2 * planes, h, w), generator=gen,
                            device=dev, dtype=torch.int16)
        arms = [torch.randint(arm_lo, reach + 6, (4, h, w), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(2)]
        _, s2, s3 = band.agg_rescale_shifts(reach, 2)
        got = band.vv_dm(vol, *arms, s2, s3, reach)
        hw, vol2 = h * w, vol.numel()
        chk.suffix = suffix
        chk.record("B18b vv_dm (passes 2+3)", got,
                   band.vv_dm_plain(vol, *arms, s2, s3, reach),
                   lambda: band.vv_dm(vol, *arms, s2, s3, reach),
                   lambda: band.vv_dm_plain(vol, *arms, s2, s3, reach),
                   nbytes=vol2 * 2 + 4 * hw * 4 + vol2 * 2, ops=2 * 4 * vol2)
        chk.suffix = ""
        return vol, arms, (s2, s3)

    entry(" (200x1001, reach 0)", 200, 1001, nd, 0)
    entry(" (200x1001, reach 64)", 200, 1001, nd, 64)
    entry(" (37x1001)", 37, 1001, nd, 34)
    entry(" (200x1001, D=30)", 200, 1001, 30, 34)
    vol, arms, (s2, _) = entry(
        " (200x1001, pass-2 sums at the int16 ceiling)", 200, 1001, nd, 34,
        lo=30000, hi=32768, arm_lo=34)
    p2 = band._span_dm(vol[:nd], arms[0][0], arms[0][1], 1, 34)
    over = float((((p2 + (1 << (s2 - 1))) >> s2) > 32767).float().mean())
    if over == 0.0:
        raise SmokeFailure("B18b ceiling entry: no rescaled pass-2 sum "
                           "passes 32767")
    print(f"  B18b ceiling entry: {over:.4f} of the left eye's rescaled "
          f"pass-2 sums pass 32767 and wrap", flush=True)


def check_hdm_edges(chk, nd: int, dev):
    """B18a's and B18c's edge entries (`HDM_EDGES`, `HDM_C_EDGES`) on
    (2D, H, W) volumes and arms drawn here: u8 costs for B18a; for B18c,
    values in the range passes 2+3 give them (at the sums entries
    30000..32767 under arms of 64), arms drawn from -2 to 5 past the
    reach."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band

    gen = torch.Generator(device=dev).manual_seed(1816)

    def draw(h, w, planes, reach, lo, hi, dtype, offset, arm_lo):
        n = 2 * planes * h * w
        flat = torch.randint(lo, hi, (n + offset,), generator=gen,
                             device=dev, dtype=dtype)
        vol = flat[offset:].view(2 * planes, h, w)
        arms = [torch.randint(arm_lo, reach + 6, (4, h, w), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(2)]
        return vol, arms

    def entry(suffix, h, w, planes, reach, offset=0):
        hw, vol2 = h * w, 2 * planes * h * w
        chk.suffix = suffix
        vol, arms = draw(h, w, planes, reach, 0, 256, torch.uint8, offset,
                         -2)
        chk.record("B18a pass1_dm", band.pass1_dm(vol, *arms, reach),
                   band.pass1_dm_plain(vol, *arms, reach),
                   lambda: band.pass1_dm(vol, *arms, reach),
                   lambda: band.pass1_dm_plain(vol, *arms, reach),
                   nbytes=vol2 + 4 * hw * 4 + vol2 * 2, ops=3 * vol2)
        vol, arms = draw(h, w, planes, reach, 0, 17_300, torch.int16, offset,
                         -2)
        wta(vol, arms, reach)
        chk.suffix = ""

    def wta(vol, arms, reach, zd=3):
        h, w = vol.shape[1:]
        hw, vol2 = h * w, vol.numel()
        chk.record("B18c pass4_wta_dm", band.pass4_wta_dm(vol, *arms, zd,
                                                          reach),
                   band.pass4_wta_dm_plain(vol, *arms, zd, reach),
                   lambda: band.pass4_wta_dm(vol, *arms, zd, reach),
                   lambda: band.pass4_wta_dm_plain(vol, *arms, zd, reach),
                   nbytes=vol2 * 2 + 4 * hw * 4 + 2 * hw * 4, ops=3 * vol2)

    entry(" (200x1001, reach 0)", 200, 1001, nd, 0)
    entry(" (200x1001, reach 64)", 200, 1001, nd, 64)
    entry(" (37x1001)", 37, 1001, nd, 34)
    entry(" (37x1, W=1)", 37, 1, nd, 34)
    entry(" (37x15, W=15)", 37, 15, nd, 34)
    entry(" (37x17, W=17)", 37, 17, nd, 34)
    entry(" (200x1001, D=30)", 200, 1001, 30, 34)
    entry(" (200x1920, D=30)", 200, 1920, 30, 34)
    entry(" (37x1001, D=261)", 37, 1001, 261, 34)
    entry(" (200x1920, base one element off)", 200, 1920, nd, 34, offset=1)
    for suffix, w in ((" (200x1001, sums past 2^21)", 1001),
                      (" (200x1920, sums past 2^21)", 1920)):
        vol, arms = draw(200, w, nd, 64, 30000, 32768, torch.int16, 0, 64)
        chk.suffix = suffix
        wta(vol, arms, 64)
        chk.suffix = ""
        top = int(band._span_dm(vol[:nd], arms[0][2], arms[0][3], 2,
                                64).max())
        if top < 1 << 21:
            raise SmokeFailure(f"B18c{suffix}: the largest window sum "
                               f"{top} does not pass 2^21")
        print(f"  B18c{suffix}: window sums up to {top}", flush=True)
    # ties: few levels, and a block where every plane is equal (the first
    # minimum there is d=0)
    vol, arms = draw(200, 1001, nd, 34, 0, 4, torch.int16, 0, -2)
    vol[:, 50:150, 200:800] = 2
    chk.suffix = " (200x1001, tied planes)"
    wta(vol, arms, 34)
    chk.suffix = ""
    got = band.pass4_wta_dm(vol, *arms, 3, 34)[0][50 + 34:150 - 34,
                                                  200 + 34:800 - 34]
    if not bool((got == -3).all()):
        raise SmokeFailure("B18c tied planes (200x1001): a block of equal "
                           "planes must give the first disparity")


def run_dm_core(name, img_l, img_r, arms_l, arms_r, cfg):
    """The disparity-major core as a path: launch counts zeroed just
    before one call of `band_stereo_core_dm` and read just after; the
    result against the lane-major core at the same config (band_digits=2),
    every pixel of both eyes; then both cores timed side by side."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band

    args = (img_l, img_r, arms_l, arms_r, cfg)
    reset_counts()
    dm = band.band_stereo_core_dm(*args)
    launches = read_counts(name, {}, zero=LANE_CORE_WRAPPERS)
    missing = [n for n in DM_WRAPPERS if launches[n] <= 0]
    if missing:
        raise SmokeFailure(f"path {name}: kernels not launched: {missing}")
    lane = band.band_stereo_core_chunked(*args)
    for eye, a, b in (("left", dm[0], lane[0]), ("right", dm[1], lane[1])):
        if a.shape != b.shape or not torch.equal(a, b):
            raise SmokeFailure(
                f"path {name}: {eye} eye differs from the lane-major core "
                f"at band_digits={cfg.band_digits} at "
                f"{int((a != b).sum())} pixels")
        if float(a.std()) == 0.0:
            raise SmokeFailure(f"path {name}: constant disparities")
    res = dict(launches=launches)
    for label, fn in (("dm", band.band_stereo_core_dm),
                      ("lane_major", band.band_stereo_core_chunked)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res[label + "_ms"] = time_ms(lambda: fn(*args), 3)
        res[label + "_peak_gb"] = (torch.cuda.max_memory_allocated()
                                   - before) / 1e9
    print(f"path {name}: equal to the lane-major core at band_digits="
          f"{cfg.band_digits} in every pixel of both eyes (left std "
          f"{float(dm[0].std()):.3f}); stereo core {res['dm_ms']:.3f} ms "
          f"against {res['lane_major_ms']:.3f} ms lane-major (CUDA events, "
          f"mean of 3); peak memory above the inputs "
          f"{res['dm_peak_gb']:.2f} GB against "
          f"{res['lane_major_peak_gb']:.2f} GB", flush=True)
    return res


def check_small_dm_core():
    """Phase 4b for the disparity-major core: a 96x160 frame, usd=34,
    D=32, whole and in 32-row chunks, on the card (kernels) against the
    CPU (plain versions) and against the lane-major core: exact."""
    import torch
    from stereo_to_multiview_tpu_torch.config import PipelineConfig
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops import band
    from stereo_to_multiview_tpu_torch.ops.cross import cross_arms

    cfg = PipelineConfig(num_rows=96, num_cols=160, num_rows_out=96,
                         num_cols_out=160, num_disp=32, zero_disp=16,
                         usd=34, lsd=17, band_digits=2)
    sbs = torch.from_numpy(stereo_sbs(cfg.num_rows, cfg.num_cols))
    for chunk in (0, 32):
        c = cfg.replace(band_row_chunk=chunk)
        res = {}
        for dev in ("cuda", "cpu"):
            l, r = (t.contiguous().to(dev) for t in pipeline.demux_sbs(sbs))
            arms = [cross_arms(t, c.ucd, c.lcd, c.usd, c.lsd) for t in (l, r)]
            res[dev] = [d.cpu() for d in
                        band.band_stereo_core_dm(l, r, *arms, c)]
            if dev == "cuda":
                res["lane"] = [d.cpu() for d in
                               band.band_stereo_core_chunked(l, r, *arms, c)]
        for eye in range(2):
            if not (torch.equal(res["cuda"][eye], res["cpu"][eye])
                    and torch.equal(res["cuda"][eye], res["lane"][eye])):
                raise SmokeFailure(f"small frame dm core, band_row_chunk="
                                   f"{chunk}: eye {eye} differs card vs CPU "
                                   f"or dm vs lane-major")
        if float(res["cuda"][0].std()) == 0.0:
            raise SmokeFailure("small frame dm core: constant disparities")
    print("small frame dm core 96x160 D=32 usd=34, band_row_chunk 0 and 32: "
          "equal card vs CPU and dm vs lane-major", flush=True)


def reset_counts():
    import torch
    from stereo_to_multiview_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()


def read_counts(name, want, zero=()):
    """The launch counts since `reset_counts`; each wrapper in `want` must
    have launched exactly that often, each in `zero` never."""
    import torch
    from stereo_to_multiview_tpu_torch import kernels
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in kernels.wrappers().items()}
    print(f"path {name}: launches "
          f"{ {n: c for n, c in launches.items() if c} }", flush=True)
    for n, c in want.items():
        if launches.get(n, 0) != c:
            raise SmokeFailure(f"path {name}: {n} launched "
                               f"{launches.get(n, 0)} times, expected {c}")
    stray = [n for n in zero if launches.get(n, 0) != 0]
    if stray:
        raise SmokeFailure(f"path {name}: kernels launched that the path "
                           f"replaces: {stray}")
    return launches


def window_adds(arm_neg, arm_pos, axis: int, inclusive: bool, max_arm: int):
    """Elements a span sum adds for each d: the clamped window lengths of
    this run's arms, summed over the plane."""
    import torch
    n = arm_neg.shape[axis]
    pos = torch.arange(n, device=arm_neg.device)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    lo = (pos - arm_neg.clamp(0, max_arm)).clamp(min=0)
    hi = (pos + arm_pos.clamp(0, max_arm) + int(inclusive)).clamp(max=n)
    return float((hi - lo).clamp(min=0).sum())


def record_span(chk, name, vol, arm_neg, arm_pos, axis, inclusive, nsplit,
                max_arm):
    """One B15 entry: the kernel against its plain version on `vol`, bit
    for bit."""
    from stereo_to_multiview_tpu_torch.ops import band
    fn = band.band_span_sum_v if axis == 0 else band.band_span_sum_h
    args = (vol, arm_neg, arm_pos, inclusive, nsplit, max_arm)
    plain = (vol, arm_neg, arm_pos, axis, inclusive, nsplit, max_arm)
    got = fn(*args)
    # bytes: the volume in and out, two arm planes; operations: one add a
    # window element and d, and the bf16 split of each element
    adds = vol.shape[2] * window_adds(arm_neg, arm_pos, axis, inclusive,
                                      max_arm)
    chk.record(name, got, band.span_sum_float_plain(*plain),
               lambda: fn(*args), lambda: band.span_sum_float_plain(*plain),
               nbytes=2 * vol.numel() * 4 + 2 * arm_neg.numel() * 4,
               ops=adds + (4 * nsplit - 2) * vol.numel(), bits=True)
    return got


def check_span_edges(chk, vol, arms_l, usd: int):
    """B15's edge entries (`SPAN_EDGES`), each along x and y: crops and
    cuts of `vol` (one eye's float volume) and volumes made here, with
    the frame's arms (`arms_l`, at usd) or arms drawn past [0, max_arm]
    to test the clamp."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    dev = vol.device
    gen = torch.Generator(device=dev).manual_seed(1515)

    def drawn(h, w, hi):
        return [torch.randint(-3, hi, (h, w), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(4)]

    def frame(h, w):
        return [arms_l[i, :h, :w].contiguous() for i in (UP, DOWN, LEFT,
                                                          RIGHT)]

    def both(suffix, v, arms, inclusive, nsplit, max_arm):
        chk.suffix = suffix
        record_span(chk, "B15 band_span_sum_h", v, arms[2], arms[3], 1,
                    inclusive, nsplit, max_arm)
        record_span(chk, "B15 band_span_sum_v", v, arms[0], arms[1], 0,
                    inclusive, nsplit, max_arm)
        chk.suffix = ""

    crop = vol[:200, :1001].contiguous()
    hw = crop.shape[:2]
    both(" (200x1001, max_arm=0, inclusive, nsplit=3)", crop,
         drawn(*hw, 40), True, 3, 0)
    both(" (200x1001, max_arm=64, nsplit=2)", crop, drawn(*hw, 70), False,
         2, 64)
    short = torch.randint(0, 200, (*vol[:37, :100].shape,), generator=gen,
                          device=dev).to(torch.float32)
    both(" (37x100, max_arm=64: lines shorter than a window, integers, "
         "inclusive, nsplit=1)", short, drawn(*short.shape[:2], 70), True, 1,
         64)
    short_f = vol[:37, :100].contiguous()
    both(" (37x100, max_arm=64: lines shorter than a window, float, "
         "nsplit=2)", short_f, drawn(*short_f.shape[:2], 70), False, 2, 64)
    both(" (200x1001, D=1, inclusive, nsplit=1)",
         crop[:, :, :1].contiguous(), frame(*hw), True, 1, usd)
    both(" (200x1001, D=30, nsplit=2)", crop[:, :, :30].contiguous(),
         frame(*hw), False, 2, usd)
    del crop, short, short_f
    # integers in [-2^15, 2^15] take prefix differences, but a block that
    # stages one 32769 (a term past the bound) sums its windows term by
    # term
    v130 = torch.randint(-32768, 32769, (*hw, 130), generator=gen,
                         device=dev).to(torch.float32)
    v130.view(-1)[::500009] = 32769.0
    both(" (200x1001, D=130, integers to 2^15 and some 32769, inclusive, "
         "nsplit=3)", v130, frame(*hw), True, 3, usd)
    del v130

    # mixed signs; one element in 5000 each +inf, -inf, NaN; runs of 1e8,
    # 1, -1e8 along x (rows y % 7 == 0) and along y (columns x % 11 == 5),
    # whose sum depends on the order; a 40x40 block of -0.0 whose windows
    # (arms 0..3 there) hold nothing else: +0.0 + -0.0 = +0.0
    h, w, nd = 200, 1001, 32
    v = torch.rand((h, w, nd), generator=gen, device=dev) * 2 - 1
    pick = torch.rand((h, w, nd), generator=gen, device=dev)
    v[pick < 2e-4] = float("inf")
    v[(pick >= 2e-4) & (pick < 4e-4)] = -float("inf")
    v[(pick >= 4e-4) & (pick < 6e-4)] = float("nan")
    for k, val in enumerate((1e8, 1.0, -1e8)):
        v[0::7, k:w - 2 + k:11] = val
        v[k:h - 2 + k:13, 5::11] = val
    v[100:140, 500:540] = -0.0
    arms = drawn(h, w, usd + 6)
    for a in arms:
        a[100:140, 500:540] = torch.randint(
            0, 4, (40, 40), generator=gen, device=dev, dtype=torch.int32)
    for nsplit in (1, 2, 3):
        both(f" (200x1001, +-inf, NaN, -0.0, 1e8 / 1 / -1e8, "
             f"nsplit={nsplit})", v, arms, nsplit == 2, nsplit, usd)
    # the entries test nothing unless each kind of output occurs
    out = band.band_span_sum_h(v, arms[2], arms[3], False, 1, usd)
    block = out[104:136, 504:536]
    counts = (int(torch.isnan(out).sum()), int(torch.isinf(out).sum()),
              int(((block == 0) & ~torch.signbit(block)).sum()))
    if min(counts) == 0:
        raise SmokeFailure(f"B15 non-finite edge volume: NaN, inf and +0.0 "
                           f"outputs expected, counted {counts}")
    print(f"  B15 non-finite volume: {counts[0]} NaN, {counts[1]} +-inf, "
          f"{counts[2]} +0.0 outputs of windows of -0.0 (along x, nsplit=1)",
          flush=True)
    del v, pick, out


def check_irv_band(chk, dl, dr, labels, arms_l, arms_r, cfg):
    """B15 on the stacked one-hot of the frame's raw disparities and
    labels (the volumes of `dr_irv_band_lr`'s first round) and on float
    volumes of one eye, the latter also as the paths `SPAN_FLOAT`: one
    call each of `band_span_sum_h` and `_v`; then `dr_irv_band_lr` as a
    path: 5 fixed rounds, which must equal the fixed-round `dr_irv`
    (B8/B9) in every disparity and label of both eyes.  Returns the
    paths' results by name."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, irv
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    arms = torch.cat([arms_l, arms_r], dim=1)
    onehot = band.irv_onehot(torch.cat([dl, dr]),
                             torch.cat([labels[0], labels[1]]), nd, zd)
    lr = (arms[LEFT].contiguous(), arms[RIGHT].contiguous())
    ud = (arms[UP].clamp(max=usd).contiguous(), arms[DOWN].contiguous())
    tag = "stacked one-hot, nsplit=1, inclusive"
    row = record_span(chk, f"B15 band_span_sum_h ({tag})", onehot, *lr, 1,
                      True, 1, usd)
    del onehot
    record_span(chk, f"B15 band_span_sum_v ({tag})", row, *ud, 0, True, 1,
                usd)
    del row
    torch.cuda.empty_cache()

    # float volumes of one eye in [0, 1), half-open windows
    gen = torch.Generator(device=dl.device).manual_seed(15)
    vol = torch.rand((*dl.shape, nd), generator=gen, device=dl.device)
    lr_l = (arms_l[LEFT].contiguous(), arms_l[RIGHT].contiguous())
    ud_l = (arms_l[UP].contiguous(), arms_l[DOWN].contiguous())
    paths = {}
    for nsplit in (3, 2):
        tag = f"float, nsplit={nsplit}"
        record_span(chk, f"B15 band_span_sum_h ({tag})", vol, *lr_l, 1,
                    False, nsplit, usd)
        record_span(chk, f"B15 band_span_sum_v ({tag})", vol, *ud_l, 0,
                    False, nsplit, usd)

        def spans():
            return (band.band_span_sum_h(vol, *lr_l, False, nsplit, usd),
                    band.band_span_sum_v(vol, *ud_l, False, nsplit, usd))
        reset_counts()
        spans()
        launches = read_counts(SPAN_FLOAT[nsplit], {"band_span_sum_h": 1,
                                                    "band_span_sum_v": 1})
        paths[SPAN_FLOAT[nsplit]] = dict(launches=launches,
                                         span_ms=time_ms(spans, 3))
    # rows of 1001 * 128 floats: no block starts on a 128-column boundary
    chk.suffix = AT_ODD
    odd = vol[:200, :1001].contiguous()
    crop = [a[:200, :1001].contiguous() for a in (*lr_l, *ud_l)]
    record_span(chk, "B15 band_span_sum_h (float, nsplit=3)", odd, *crop[:2],
                1, False, 3, usd)
    record_span(chk, "B15 band_span_sum_v (float, nsplit=3)", odd, *crop[2:],
                0, False, 3, usd)
    chk.suffix = ""
    del odd
    check_span_edges(chk, vol, arms_l, usd)
    del vol
    torch.cuda.empty_cache()

    rounds = cfg.irv_iterations
    args = (dl, labels[0], dr, labels[1], arms_l, arms_r, cfg.irv_thresh_s,
            cfg.irv_thresh_h, nd, zd, usd, rounds)
    reset_counts()
    got = band.dr_irv_band_lr(*args)
    launches = read_counts(
        IRV_BAND, {"band_span_sum_h": rounds, "band_span_sum_v": rounds},
        zero=("irv_rowspan", "irv_vote"))
    fixed_args = (cfg.irv_thresh_s, cfg.irv_thresh_h, nd, zd, usd, rounds)
    changed = 0
    for eye, (d, o, a), (gd, go) in (
            ("left", (dl, labels[0], arms_l), got[0]),
            ("right", (dr, labels[1], arms_r), got[1])):
        fd, fo = irv.dr_irv(d, o, a, *fixed_args)
        if not (torch.equal(gd, fd) and torch.equal(go, fo)):
            raise SmokeFailure(
                f"path {IRV_BAND}: {eye} eye differs from the fixed-round "
                f"dr_irv at {int((gd != fd).sum())} disparities and "
                f"{int((go != fo).sum())} labels")
        changed += int((go != o).sum())
    if changed == 0:
        raise SmokeFailure(f"path {IRV_BAND}: the rounds changed no label")
    res = dict(launches=launches, rounds=rounds, labels_changed=changed)
    for label, fn in (
            ("band_ms", lambda: band.dr_irv_band_lr(*args)),
            ("dr_irv_ms", lambda: (irv.dr_irv(dl, labels[0], arms_l,
                                              *fixed_args),
                                   irv.dr_irv(dr, labels[1], arms_r,
                                              *fixed_args)))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res[label] = time_ms(fn, 3)
        res[label.replace("_ms", "_peak_gb")] = (
            torch.cuda.max_memory_allocated() - before) / 1e9
    print(f"path {IRV_BAND}: {rounds} fixed rounds equal to dr_irv (B8/B9) "
          f"in every disparity and label of both eyes ({changed} labels "
          f"changed); {res['band_ms']:.3f} ms against {res['dr_irv_ms']:.3f} "
          f"ms for dr_irv on both eyes (CUDA events, mean of 3); peak memory "
          f"above the inputs {res['band_peak_gb']:.2f} GB against "
          f"{res['dr_irv_peak_gb']:.2f} GB", flush=True)
    paths[IRV_BAND] = res
    return paths


def check_shift_extract(chk, img_l, img_r, cfg):
    """B16's left-eye and right-eye modes (one strip; both strips in one
    launch, written into the sheared volume in place) and B17 (u8 and
    float32) on a frame's pair."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import costkern

    h, w = img_l.shape[:2]
    nd, zd = cfg.num_disp, cfg.zero_disp
    hw, vol = h * w, h * w * nd
    m = costkern.pair_margin(nd, zd)
    kern, plain = dm_cost_fns(costkern, img_l, img_r)
    coeffs = (cfg.ad_coeff, cfg.census_coeff, nd, zd)
    for quant, label, size in ((True, "u8", 1), (False, "float32", 4)):
        kw = dict(quant=quant, eyes="l")
        left = kern(*coeffs, **kw)
        chk.record(f"B16 cost_dm (left eye {label})", left,
                   plain(*coeffs, **kw), lambda: kern(*coeffs, **kw),
                   lambda: plain(*coeffs, **kw),
                   nbytes=2 * hw * 3 + vol * size, ops=5 * vol)
        sheared = costkern.shear_right_dm(left, zd)
        if quant:
            for name, cols in (
                    ("B16 cost_dm (right-eye strip u8)", ((w - m, w),)),
                    (B16_STRIPS, ((0, m), (w - m, w)))):
                record_strips(chk, name, kern, plain, coeffs, sheared, cols,
                              nd, zd)
        del sheared
        record_shear_dm(chk, f"B17 shear_right_dm ({label})", left, zd)
        del left
        torch.cuda.empty_cache()


def record_shear_dm(chk, name, vol, zd):
    """One B17 entry: the shear of a (D, H, W) volume against its plain
    version, beside the library call, one gather from a zero-padded copy
    made beforehand (held equal to the plain version first); bytes: the
    volume read and written once."""
    import torch
    import torch.nn.functional as F
    from stereo_to_multiview_tpu_torch.ops import costkern

    nd, h, w = vol.shape
    m = max(zd, nd - zd)
    x = torch.arange(w, device=vol.device)[None, None, :]
    d = torch.arange(nd, device=vol.device)[:, None, None]
    idx = (x + m - (d - zd)).expand(nd, h, w)
    padded = F.pad(vol, (m, m))
    try:
        ref = costkern.shear_right_dm_plain(vol, zd)
    except RuntimeError:
        # an older package's plain version slices past rows shorter than
        # the shifts; this checkout's must not
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(costkern.__file__))))
        if os.path.samefile(root, HERE):
            raise
        print(f"{name}: not taken by the package's plain version",
              flush=True)
        return
    if not torch.equal(torch.gather(padded, 2, idx), ref):
        raise SmokeFailure(f"{name}: the library gather disagrees")
    chk.record(name, costkern.shear_right_dm(vol, zd), ref,
               lambda: costkern.shear_right_dm(vol, zd),
               lambda: costkern.shear_right_dm_plain(vol, zd),
               nbytes=2 * vol.numel() * vol.element_size(), ops=0,
               library=lambda: torch.gather(padded, 2, idx))


def check_shear_dm_edges(chk, img_l, img_r, cfg):
    """B17 u8 at its edges (`B17_EDGES`) on the 1080p frame's left-eye
    volume (B16's left-eye mode): crops of 200x1004, 37x1, 37x15 and
    37x17, the whole volume at zd = 0 and zd = D, its first plane at
    zd = 1, and its first 680 rows tiled twice across (128x680x3840)."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import costkern

    nd, zd = cfg.num_disp, cfg.zero_disp
    kern, _ = dm_cost_fns(costkern, img_l, img_r)
    left = kern(cfg.ad_coeff, cfg.census_coeff, nd, zd, quant=True,
                eyes="l")
    y0 = left.shape[1] // 2
    for suffix, (rows, cols) in zip(B17_EDGES[:4], ((200, 1004), (37, 1),
                                                    (37, 15), (37, 17))):
        record_shear_dm(chk, B17U8 + suffix,
                        left[:, y0:y0 + rows, :cols].contiguous(), zd)
    record_shear_dm(chk, B17U8 + B17_EDGES[4], left, 0)
    record_shear_dm(chk, B17U8 + B17_EDGES[5], left, nd)
    record_shear_dm(chk, B17U8 + B17_EDGES[6], left[:1].contiguous(), 1)
    wide = left[:, :680].repeat(1, 1, 2).contiguous()
    del left
    torch.cuda.empty_cache()
    record_shear_dm(chk, B17U8 + B17_EDGES[7], wide, zd)
    del wide
    torch.cuda.empty_cache()


def record_strips(chk, name, kern, plain, coeffs, vol, cols, nd, zd):
    """One B16 entry of the right-eye mode: `cols` of the (D, H, W) u8
    volume `vol` written in place (on copies of it, every other column
    kept), against the plain version, timed from a CUDA graph (device
    time: the launch is shorter than its wrapper's host time); bytes: the
    right eye's pixels over the strips and the left eye's over the
    columns they reach (the census rows included: every row), and the
    strips written."""
    h, w = vol.shape[1:]
    got, ref = vol.clone(), vol.clone()
    kw = dict(quant=True, eyes="r", cols=cols)
    kern(*coeffs, **kw, out=got)
    plain(*coeffs, **kw, out=ref)
    width = sum(x1 - x0 for x0, x1 in cols)
    reach = sum(min(w, x1 + zd) - max(0, x0 - (nd - 1 - zd))
                for x0, x1 in cols)
    chk.record(name, got, ref, lambda: kern(*coeffs, **kw, out=got),
               lambda: plain(*coeffs, **kw, out=ref),
               nbytes=h * (width + reach) * 3 + h * width * nd,
               ops=5 * h * width * nd, graph=True)


def check_dm_edges(chk, img_l, img_r, cfg):
    """B16 at its edges (`B16_EDGES` but the 4K chunk, and the strips at
    M = 1) on the 1080p frame's pair and crops of it."""
    import inspect
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern

    h, w = img_l.shape[:2]
    nd, zd = cfg.num_disp, cfg.zero_disp
    ext, bounds = band.chunk_bounds(h, 540, 2 * cfg.usd)
    last = (bounds[-1][0], ext)
    if h == 1080 and last != (400, 680):
        raise SmokeFailure(f"the 1080p frame's last 540-row chunk is rows "
                           f"[{last[0]}, {last[0] + ext}), not [400, 1080)")
    kern, plain = dm_cost_fns(costkern, img_l, img_r)
    coeffs = (cfg.ad_coeff, cfg.census_coeff, nd, zd)
    record_dm_cost(chk, B16 + B16_EDGES[0], kern, plain, coeffs, h, w, nd,
                   rows=last)
    record_dm_cost(chk, B16 + B16_EDGES[7], kern, plain, coeffs, h, w, nd,
                   quant=False, rows=(0, ext))
    torch.cuda.empty_cache()
    y0 = h // 2
    # an older package's B16 wrapper refuses D > 128 (its JAX entry's
    # limit, not the kernel's)
    old = "cen_l" in inspect.signature(costkern.cost_dm).parameters
    for suffix, (rows, cols, dd, zz) in zip(B16_EDGES[1:7], (
            (37, 1, nd, zd), (37, 15, nd, zd), (37, 17, nd, zd),
            (200, 1001, 30, 15), (200, 1001, 256, 128),
            (200, 1001, nd, 0))):
        if old and dd > 128:
            print(f"B16{suffix}: not taken by the package's wrapper",
                  flush=True)
            continue
        crop = [t[y0:y0 + rows, :cols].contiguous() for t in (img_l, img_r)]
        ck, cp = dm_cost_fns(costkern, *crop)
        record_dm_cost(chk, B16 + suffix, ck, cp,
                       (cfg.ad_coeff, cfg.census_coeff, dd, zz),
                       *crop[0].shape[:2], dd)
    vol = torch.zeros((nd, h, w), dtype=torch.uint8, device=img_l.device)
    record_strips(chk, B16_STRIPS + B16_M1, kern, plain, coeffs, vol,
                  ((0, 1), (w - 1, w)), nd, zd)
    del vol
    torch.cuda.empty_cache()


def check_dm_chunk4k(chk, img_l, img_r, cfg):
    """B16 on the 4K preset's third row chunk of the whole frame (rows
    1012-1691), whose census reads rows outside the chunk."""
    from stereo_to_multiview_tpu_torch.ops import band, costkern
    ext, bounds = band.chunk_bounds(cfg.num_rows, cfg.band_row_chunk,
                                    2 * cfg.usd)
    rows = (bounds[2][0], ext)
    if cfg.num_rows == 2160 and rows != (1012, 680):
        raise SmokeFailure(f"the 4K preset's third chunk is rows "
                           f"[{rows[0]}, {rows[0] + ext}), not [1012, 1692)")
    kern, plain = dm_cost_fns(costkern, img_l, img_r)
    record_dm_cost(chk, B16 + B2_CHUNK4K, kern, plain,
                   (cfg.ad_coeff, cfg.census_coeff, cfg.num_disp,
                    cfg.zero_disp), *img_l.shape[:2], cfg.num_disp,
                   rows=rows)


def events_split(steps, reps: int = 3):
    """CUDA-event ms of each labelled part of a run: `steps()` returns
    [(label, fn), ...] to run in order; events recorded around each part
    on the current stream, summed by label, mean of `reps` runs after one
    warm-up; 'total' from the first event to the last."""
    import torch
    sums = {}
    for rep in range(reps + 1):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
        labels = []
        for label, fn in steps():
            fn()
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            labels.append(label)
        torch.cuda.synchronize()
        if rep == 0:
            continue
        for i, label in enumerate(labels):
            sums[label] = sums.get(label, 0.0) + marks[i].elapsed_time(
                marks[i + 1])
        sums["total"] = sums.get("total", 0.0) + marks[0].elapsed_time(
            marks[-1])
    return {k: v / reps for k, v in sums.items()}


def split_cost_entry(img_l, img_r, cfg, quant: bool):
    """`ci_adcensus_kern` (direct path) split by CUDA events: the torch
    census (an older package's; none since B16 computes it), B16, and the
    two (D, H, W) -> (H, W, D) relayout copies; the parts' result held
    equal to the entry's."""
    import inspect
    import torch
    from stereo_to_multiview_tpu_torch.ops import costkern
    from stereo_to_multiview_tpu_torch.ops.cost import census_transform_9x7
    from stereo_to_multiview_tpu_torch.ops.mux import mux_average

    nd = cfg.num_disp
    coeffs = (cfg.ad_coeff, cfg.census_coeff, nd, cfg.zero_disp, quant)
    old = "cen_l" in inspect.signature(costkern.cost_dm).parameters
    st = {}

    def census():
        st.clear()          # the last run's outputs freed first
        st["cen"] = ([census_transform_9x7(mux_average(t))
                      for t in (img_l, img_r)] if old else [])

    def b16():
        st["vol"] = costkern.cost_dm(img_l, img_r, *st["cen"], *coeffs)

    def relayout():
        v = st.pop("vol")
        st["out"] = (v[:nd].permute(1, 2, 0).contiguous(),
                     v[nd:].permute(1, 2, 0).contiguous())

    res = events_split(lambda: [("census", census), ("B16", b16),
                                ("relayout", relayout)])
    ref = costkern.ci_adcensus_kern(img_l, img_r, *coeffs)
    if not all(torch.equal(a, b) for a, b in zip(st["out"], ref)):
        raise SmokeFailure("ci_adcensus_kern split: the parts differ from "
                           "the entry")
    res["entry"] = time_ms(lambda: costkern.ci_adcensus_kern(
        img_l, img_r, *coeffs), 3)
    return res


def split_dm_core(img_l, img_r, arms_l, arms_r, cfg):
    """`band_stereo_core_dm` split by CUDA events, step for step as it
    runs: the torch census of the frame (an older package's), and per
    chunk B16, B18a, B18b, B18c and the glue (the chunk's outputs cut
    out, and the parts' concatenation at the end); the result held equal
    to the entry's."""
    import inspect
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern
    from stereo_to_multiview_tpu_torch.ops.cost import census_transform_9x7
    from stereo_to_multiview_tpu_torch.ops.mux import mux_average

    h = img_l.shape[0]
    usd, nd, zd = cfg.usd, cfg.num_disp, cfg.zero_disp
    chunk = cfg.band_row_chunk or h
    ext, bounds = band.chunk_bounds(h, chunk, 2 * usd)
    _, s2, s3 = band.agg_rescale_shifts(usd, 2)
    old = "cen_l" in inspect.signature(costkern.cost_dm).parameters
    coeffs = (cfg.ad_coeff, cfg.census_coeff, nd, zd)
    st = {}

    def steps():
        st.clear()          # the last run's outputs freed first
        out = [("census", lambda: st.update(cen=[
            census_transform_9x7(mux_average(t)) for t in (img_l, img_r)]
            if old else []))]
        st["parts"] = ([], [])
        for start, lo in bounds:
            sl = slice(start, start + ext)
            arms = (arms_l[:, sl], arms_r[:, sl])

            def b16(sl=sl, start=start):
                if old:
                    st["v"] = costkern.cost_dm(
                        img_l[sl], img_r[sl], st["cen"][0][sl],
                        st["cen"][1][sl], *coeffs)
                else:
                    st["v"] = costkern.cost_dm(img_l, img_r, *coeffs,
                                               rows=(start, ext))

            def glue(start=start, lo=lo):
                n = min(chunk, h - (start + lo))
                st["parts"][0].append(st["d"][0][lo:lo + n])
                st["parts"][1].append(st["d"][1][lo:lo + n])

            out += [("B16", b16),
                    ("B18a", lambda arms=arms: st.update(
                        v=band.pass1_dm(st["v"], *arms, usd))),
                    ("B18b", lambda arms=arms: st.update(
                        v=band.vv_dm(st["v"], *arms, s2, s3, usd))),
                    ("B18c", lambda arms=arms: st.update(
                        d=band.pass4_wta_dm(st.pop("v"), *arms, zd, usd))),
                    ("glue", glue)]
        out.append(("glue", lambda: st.update(out=[
            p[0] if len(p) == 1 else torch.cat(p, dim=0)
            for p in st["parts"]])))
        return out

    res = events_split(steps)
    ref = band.band_stereo_core_dm(img_l, img_r, arms_l, arms_r, cfg)
    if not all(torch.equal(a, b) for a, b in zip(st["out"], ref)):
        raise SmokeFailure("band_stereo_core_dm split: the parts differ "
                           "from the entry")
    return res


def run_cost_splits(img_l, img_r, arms_l, arms_r, cfg, cfg4k=None,
                    img4k=None):
    """The splits of `ci_adcensus_kern` (u8, float32) and
    `band_stereo_core_dm` (whole frame, 540-row chunks; at 4K with
    `img4k` = (img_l, img_r, arms_l, arms_r)), printed and returned."""
    import torch
    res = {}
    for quant, label in ((True, "u8"), (False, "float32")):
        res[f"ci_adcensus_kern {label}"] = split_cost_entry(img_l, img_r,
                                                            cfg, quant)
        torch.cuda.empty_cache()
    cfg2 = cfg.replace(band_digits=2)
    res["band_stereo_core_dm 1080p"] = split_dm_core(img_l, img_r, arms_l,
                                                     arms_r, cfg2)
    res["band_stereo_core_dm 1080p band_row_chunk=540"] = split_dm_core(
        img_l, img_r, arms_l, arms_r, cfg2.replace(band_row_chunk=540))
    if img4k is not None:
        torch.cuda.empty_cache()
        res["band_stereo_core_dm UHD4K_16V"] = split_dm_core(
            *img4k, cfg4k.replace(band_digits=2))
    for name, parts in res.items():
        print(f"split {name}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    return res


def run_shift_extract(img_l, img_r, cfg):
    """`ci_adcensus_kern(shift_extract=True)` as a path, u8 and float32:
    B16 twice (the left eye; both border strips in one launch) and B17
    once, equal to shift_extract=False in every element of both eyes;
    both timed."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import costkern

    res = {}
    for quant, name in ((True, SHIFT_X), (False, SHIFT_X_F32)):
        args = (img_l, img_r, cfg.ad_coeff, cfg.census_coeff, cfg.num_disp,
                cfg.zero_disp, quant)
        reset_counts()
        got = costkern.ci_adcensus_kern(*args, shift_extract=True)
        launches = read_counts(name, {"cost_dm": 2, "shear_right_dm": 1})
        ref = costkern.ci_adcensus_kern(*args)
        for eye, a, b in (("left", got[0], ref[0]), ("right", got[1],
                                                     ref[1])):
            if not torch.equal(a, b):
                raise SmokeFailure(f"path {name}: {eye} eye differs from "
                                   f"shift_extract=False at "
                                   f"{int((a != b).sum())} elements")
        del got, ref
        r = res[name] = dict(launches=launches)
        for label, se in (("shift_extract_ms", True), ("direct_ms", False)):
            torch.cuda.empty_cache()
            r[label] = time_ms(lambda: costkern.ci_adcensus_kern(
                *args, shift_extract=se), 3)
        print(f"path {name}: equal to shift_extract=False in both eyes; "
              f"{r['shift_extract_ms']:.3f} ms against {r['direct_ms']:.3f} "
              f"ms direct (whole entry: census, kernels, one copy an eye; "
              f"CUDA events, mean of 3)", flush=True)
    return res


def same_bits(a, b) -> bool:
    """Equal shapes and equal float32 bits, a zero's sign included."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def record_b19(chk, name, img_l, img_r, dl, dr, shifts, nd, zd):
    """One B19 entry: every view's bounded warps against the plain
    version in every bit (the zeros outside a view's range +0.0), timed
    from a CUDA graph (device time) and by CUDA events (the wrapper's host
    time included); bytes: the images and disparities read once, both
    volumes written once.  Returns the kernel's output."""
    from stereo_to_multiview_tpu_torch.ops import warpkern
    hw = img_l.shape[0] * img_l.shape[1]
    args = (img_l, img_r, dl, dr, shifts, nd, zd)
    got = warpkern.dibr_warp_views_kern(*args)
    chk.record(name, got, warpkern.warp_views_bounded_plain(*args),
               lambda: warpkern.dibr_warp_views_kern(*args),
               lambda: warpkern.warp_views_bounded_plain(*args),
               nbytes=2 * hw * 3 + 2 * hw * 4 + 2 * got[0].numel() * 4,
               ops=2 * got[0].numel() * 8, graph=True, events=True,
               bits=True)
    return got


def record_b20(chk, name, img_l, img_r, dl, dr, s, nd, zd):
    """One B20 entry (one view at shift `s`), as `record_b19`."""
    from stereo_to_multiview_tpu_torch.ops import warpkern
    hw = img_l.shape[0] * img_l.shape[1]
    pargs = (img_l, img_r, dl, dr, s, nd, zd)
    pair = warpkern.dibr_warp_pair_kern(*pargs)

    def plain():
        va, vb = warpkern.warp_views_bounded_plain(img_l, img_r, dl, dr,
                                                   (s,), nd, zd)
        return va[0], vb[0]

    chk.record(name, pair, plain(),
               lambda: warpkern.dibr_warp_pair_kern(*pargs), plain,
               nbytes=2 * hw * 3 + 2 * hw * 4 + 2 * pair[0].numel() * 4,
               ops=2 * pair[0].numel() * 8, graph=True, events=True,
               bits=True)


def check_warp_rowmajor(chk, img_l, img_r, bl, br, cfg):
    """B19 and B20 on a frame's final disparities and the views of the
    configuration, B19 once more on disparities pushed outside the range;
    then the row-major warps as a path: B19 once and B20 per view, equal
    view by view in every bit and equal to the unfused warps (B14) on
    these in-range disparities.  Returns the path's results."""
    import torch
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
    from stereo_to_multiview_tpu_torch.ops import dibr, warpkern

    nd, zd = cfg.num_disp, cfg.zero_disp
    shifts = _synth_shifts(cfg.num_views)
    nv = len(shifts)
    outside = B19 + " (disparities outside [-64, 64])"
    for name, dl, dr in ((B19, bl, br), (outside, bl * 3, br * 3)):
        got = record_b19(chk, name, img_l, img_r, dl, dr, shifts, nd, zd)
        zeros = float((got[0] == 0).float().mean())
        print(f"  {name}: {zeros:.4f} of the left-image warps' subpixels "
              f"are 0", flush=True)
        if name == outside:
            # the bounds must act: the unbounded B14 reads a true sample
            # where B19 gives 0, and agrees with B19 everywhere else
            b14 = dibr.warp_views(img_l, img_r, dl, dr, shifts)
            for i, eye in enumerate(("left", "right")):
                cut = (got[i] == 0) & (b14[i] != 0)
                share = float(cut.float().mean())
                print(f"  {name}: {share:.4f} of the {eye}-image warps' "
                      f"subpixels are 0 by the bounds alone", flush=True)
                if share < 0.01:
                    raise SmokeFailure(f"{name}: the bounds zero only "
                                       f"{share:.4f} of the {eye}-image "
                                       f"warps' subpixels")
                if not torch.equal(got[i][~cut], b14[i][~cut]):
                    raise SmokeFailure(f"{name}: B19 differs from B14 "
                                       f"inside the bounds")
            del b14, cut
        del got
    record_b20(chk, "B20 dibr_warp_pair_kern", img_l, img_r, bl, br,
               shifts[nv // 2], nd, zd)

    args = (img_l, img_r, bl, br, shifts, nd, zd)
    reset_counts()
    views = warpkern.dibr_warp_views_kern(*args)
    pairs = [warpkern.dibr_warp_pair_kern(img_l, img_r, bl, br, s, nd, zd)
             for s in shifts]
    launches = read_counts(WARP_RM, {"dibr_warp_views_kern": 1,
                                     "dibr_warp_pair_kern": nv},
                           zero=("warp_views",))
    for v, (a, b) in enumerate(pairs):
        if not (same_bits(views[0][v], a) and same_bits(views[1][v], b)):
            raise SmokeFailure(f"path {WARP_RM}: B19 and B20 differ at view "
                               f"{v}")
    b14 = dibr.warp_views(img_l, img_r, bl, br, shifts)
    for i in range(2):
        if not torch.equal(views[i], b14[i]):
            raise SmokeFailure(
                f"path {WARP_RM}: B19 differs from B14 on in-range "
                f"disparities at {int((views[i] != b14[i]).sum())} subpixels")
    del views, pairs, b14
    res = dict(launches=launches,
               views_ms=time_ms(lambda: warpkern.dibr_warp_views_kern(*args),
                                10),
               pairs_ms=time_ms(lambda: [warpkern.dibr_warp_pair_kern(
                   img_l, img_r, bl, br, s, nd, zd) for s in shifts], 10))
    print(f"path {WARP_RM}: B19 equal to B20 view by view and to B14 on the "
          f"frame's disparities; all {nv} views {res['views_ms']:.4f} ms in "
          f"one call, {res['pairs_ms']:.4f} ms as {nv} pair calls",
          flush=True)
    return res


def check_warp_rowmajor_edges(chk, img_l, img_r, bl, br, cfg):
    """B19 at its edges (`B19_EDGES`) on crops of a frame's images and
    final disparities, and on disparities of +-64 (the configuration's
    reach) whose samples clamp at both ends of a row; B20 at the shifts 0
    and 1 on the whole frame."""
    import torch
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts

    nd, zd = cfg.num_disp, cfg.zero_disp
    shifts = _synth_shifts(cfg.num_views)
    y0 = img_l.shape[0] // 2

    def crop(rows, cols):
        return [t[y0:y0 + rows, :cols].contiguous()
                for t in (img_l, img_r, bl, br)]

    for suffix, shape in zip(B19_EDGES[:4], ((37, 1001), (37, 1), (37, 15),
                                             (37, 17))):
        record_b19(chk, B19 + suffix, *crop(*shape), shifts, nd, zd)
    # left half +reach, right half -reach in disp_r (its warp's shifts are
    # negative), the other way round in disp_l, a quarter less on every
    # third row: samples clamped to column 0 at the row's start and W - 1
    # at its end
    l, r, _, _ = crop(200, 1001)
    reach = float(min(zd, nd - zd))
    x = torch.arange(1001, device=l.device)
    y = torch.arange(200, device=l.device)
    sign = torch.where(x < 500, 1.0, -1.0)[None, :]
    mag = reach - 0.25 * (y % 3 == 0).float()[:, None]
    dr = (mag * sign).contiguous()
    dl = (-dr).contiguous()
    record_b19(chk, B19 + B19_EDGES[4], l, r, dl, dr, shifts, nd, zd)
    for suffix, s in B20_SHIFTS.items():
        record_b20(chk, "B20 dibr_warp_pair_kern" + suffix, img_l, img_r, bl,
                   br, s, nd, zd)


def check_warp_rowmajor_4k(chk, img_l, img_r, bl, br, cfg):
    """B19 on the 4K preset's frame: its images and final disparities,
    its 14 intermediate views."""
    import torch
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
    record_b19(chk, B19 + B19_4K, img_l, img_r, bl, br,
               _synth_shifts(cfg.num_views), cfg.num_disp, cfg.zero_disp)
    torch.cuda.empty_cache()


def run_synthesis_entries(img_l, img_r, bl, br, cfg):
    """The JAX-named synthesis entries beside process_frame, each as a
    path on a frame's final disparities: `synthesize_views` (the masks,
    the feather and B12's view stack), B7's hits then B11's u8 entry on
    each eye (equal to the fused stage), and `warp_views` (B14).  The
    stack interlaced by the torch `mux_multiview` must equal
    `synthesize_interlace` (B12's interlace mode).  Returns the paths'
    results."""
    import torch
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops import dibr, mux

    args = (img_l, img_r, bl, br, cfg)
    fused = has_fused_occl()
    masks = ({"dibr_occl_masks": 1} if fused else
             {"dibr_occl": 1, "dibr_bleed_mask": 2})
    reset_counts()
    views = pipeline.synthesize_views(*args)
    launches = read_counts(SYNTH_VIEWS, {
        **masks, "dibr_feather_mask": 1, "warp_merge_views": 1},
        zero=("warp_merge_interlace", "warp_views",
              *(UNFUSED_OCCL if fused else ())))
    chain = mux.mux_multiview(views, cfg.num_rows_out, cfg.num_cols_out,
                              cfg.angle)
    if not torch.equal(chain, pipeline.synthesize_interlace(*args)):
        raise SmokeFailure(f"path {SYNTH_VIEWS}: mux_multiview of the view "
                           f"stack differs from synthesize_interlace")
    del views, chain
    res = {SYNTH_VIEWS: dict(
        launches=launches,
        synth_views_ms=time_ms(lambda: pipeline.synthesize_views(*args), 10),
        synth_interlace_ms=time_ms(
            lambda: pipeline.synthesize_interlace(*args), 10))}
    # B7's hits and B11's u8 entry, unfused, as the JAX package's
    # `dcc_occl_kern` and `filter_bleed_mask_kern` run them
    rb = cfg.bleed_radius
    unfused = lambda: [dibr.dibr_bleed_mask(o, rb)
                       for o in dibr.dibr_occl(bl, br)]
    reset_counts()
    got = unfused()
    res[OCCL_UNFUSED] = dict(launches=read_counts(
        OCCL_UNFUSED, {"dibr_occl": 1, "dibr_bleed_mask": 2},
        zero=("dibr_occl_masks",) if fused else ()))
    res[OCCL_UNFUSED]["unfused_ms"] = time_graph_ms(unfused, 10)
    if fused:
        if not all(torch.equal(a, b) for a, b in
                   zip(got, dibr.dibr_occl_masks(bl, br, rb))):
            raise SmokeFailure(f"path {OCCL_UNFUSED}: the masks differ "
                               f"from dibr_occl_masks")
        res[OCCL_UNFUSED]["fused_ms"] = time_graph_ms(
            lambda: dibr.dibr_occl_masks(bl, br, rb), 10)
    print(f"path {OCCL_UNFUSED}: {res[OCCL_UNFUSED]['unfused_ms']:.4f} ms "
          f"unfused (three launches), "
          f"{res[OCCL_UNFUSED].get('fused_ms', float('nan')):.4f} ms "
          f"fused; equal masks", flush=True)
    del got
    # 38 intermediate views: B12 once; 2 views: the sources alone, no B12
    for nv, name in ((40, SYNTH_VIEWS_40), (2, SYNTH_VIEWS_2)):
        vcfg = cfg.replace(num_views=nv)
        vargs = (img_l, img_r, bl, br, vcfg)
        reset_counts()
        views = pipeline.synthesize_views(*vargs)
        launches = read_counts(name, {
            **masks, "dibr_feather_mask": 1,
            "warp_merge_views": int(nv > 2)},
            zero=("warp_merge_interlace", "warp_views"))
        mids = (dibr.warp_merge_views_plain(
            img_l, img_r, bl, br, *pipeline.synthesis_masks(bl, br, vcfg),
            dibr.synth_shifts(nv)) if nv > 2
            else img_l.new_empty((0, *img_l.shape)))
        if not torch.equal(views, torch.cat([img_r[None], mids,
                                             img_l[None]])):
            raise SmokeFailure(f"path {name}: the view stack differs from "
                               f"the plain chain's")
        del views, mids
        print(f"path {name}: the view stack equal to the plain chain's",
              flush=True)
        res[name] = dict(
            launches=launches,
            synth_views_ms=time_ms(lambda: pipeline.synthesize_views(*vargs),
                                   10),
            synth_interlace_ms=time_ms(
                lambda: pipeline.synthesize_interlace(*vargs), 10))
    shifts = dibr.synth_shifts(cfg.num_views)
    reset_counts()
    dibr.warp_views(img_l, img_r, bl, br, shifts)
    res[WARP_VIEWS] = dict(
        launches=read_counts(WARP_VIEWS, {"warp_views": 1}),
        warp_views_ms=time_ms(
            lambda: dibr.warp_views(img_l, img_r, bl, br, shifts), 10))
    print(f"path {SYNTH_VIEWS}: the stack interlaced equal to "
          f"synthesize_interlace; {res[SYNTH_VIEWS]['synth_views_ms']:.3f} "
          f"ms for the views, "
          f"{res[SYNTH_VIEWS]['synth_interlace_ms']:.3f} ms for the "
          f"interlaced frame (masks and feather included)", flush=True)
    return res


def check_interlaced(name, sbs, cfg, out):
    """A path's interlaced frame against the plain chain on the card,
    from the path's own final disparities: the plain versions of B7's
    hits, B11, G1 and B12's interlace mode (the view stack, then
    `mux_multiview`), bit for bit."""
    import torch
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops import dibr

    img_l, img_r = (t.contiguous() for t in pipeline.demux_sbs(
        torch.as_tensor(sbs).to(out[2].device)))
    dl, dr = out[0], out[1]
    occl_l, occl_r = dibr.dibr_occl_plain(dl, dr)
    mask_l, mask_r = (dibr.dibr_bleed_mask_plain(o, cfg.bleed_radius)
                      for o in (occl_l, occl_r))
    feathered = dibr.dibr_feather_mask_plain(mask_r, cfg.feather_radius,
                                             cfg.feather_sigma)
    ref = dibr.warp_merge_interlace_plain(
        img_l, img_r, dl, dr, mask_l, mask_r, feathered, cfg.num_views,
        cfg.num_rows_out, cfg.num_cols_out, cfg.angle)
    if not torch.equal(out[2], ref):
        raise SmokeFailure(f"path {name}: the interlaced frame differs from "
                           f"the plain chain at "
                           f"{int((out[2] != ref).sum())} subpixels")
    print(f"path {name}: interlaced frame equal to the plain chain "
          f"(views, then mux_multiview) on the card", flush=True)


def check_forward_warp(img_l, img_r, bl, br, cfg):
    """`dibr_dfm` (plain torch on every device) at 1080p on the card,
    timed; on a 96x160 crop the card's result must equal the CPU's, the
    bounded forward warp's too."""
    import torch
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
    from stereo_to_multiview_tpu_torch.ops import dibr

    occl = dibr.dibr_occl(bl, br)
    masks = [dibr.dibr_bleed_mask(o, cfg.bleed_radius) for o in occl]
    s = _synth_shifts(cfg.num_views)[2]
    args = (img_l, img_r, bl, br, *masks, s)
    view = dibr.dibr_dfm(*args)
    if view.shape != img_l.shape or view.dtype != torch.uint8:
        raise SmokeFailure(f"dibr_dfm: {tuple(view.shape)} {view.dtype}")
    if float(view.float().std()) < 10.0:
        raise SmokeFailure("dibr_dfm: degenerate view")
    ms = time_ms(lambda: dibr.dibr_dfm(*args), 3)
    crop = [t[:96, :160].contiguous() for t in args[:6]]
    for what, fn in (
            ("dibr_dfm", lambda ts: dibr.dibr_dfm(*ts, s)),
            ("dibr_forward_warp (bounded)", lambda ts: dibr.dibr_forward_warp(
                ts[0], ts[2], s, cfg.num_disp, cfg.zero_disp))):
        card = fn(crop).cpu()
        host = fn([t.cpu() for t in crop])
        if not torch.equal(card, host):
            raise SmokeFailure(f"{what}: card and CPU differ on a 96x160 "
                               f"crop at {int((card != host).sum())} "
                               f"subpixels")
    unhit = float((view == 0).all(dim=2).float().mean())
    print(f"forward warp: dibr_dfm at {tuple(img_l.shape[:2])} "
          f"{ms:.3f} ms (plain torch, CUDA events, mean of 3); {unhit:.4f} "
          f"of the pixels are 0; card equal to CPU on a 96x160 crop",
          flush=True)
    return dict(dfm_ms=ms, unhit_share=unhit)


def run_path(name, entry, sbs, cfg, n_frames: int, exact: bool = True):
    """Phase 3, one path: `entry(sbs, cfg)` once with the launch counts
    zeroed just before and read just after, then n_frames timed frames.
    `exact` holds the kernels NOT_ON_PATH replaces to zero launches and
    the counts of EXACT_LAUNCHES (off only when timing another checkout's
    package, whose wrappers and routes may differ)."""
    import torch
    from stereo_to_multiview_tpu_torch import kernels

    sbs_dev = torch.as_tensor(sbs).to(torch.device("cuda"))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = entry(sbs_dev, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.wrappers().items()}
    print(f"path {name}: first frame {first_s * 1e3:.1f} ms; launches "
          f"{launches}; expected zero: {sorted(NOT_ON_PATH[name])}",
          flush=True)
    missing = [n for n, c in launches.items()
               if c <= 0 and n not in NOT_ON_PATH[name]]
    if missing:
        raise SmokeFailure(f"path {name}: kernels not launched: {missing}")
    stray = [n for n in NOT_ON_PATH[name] if launches.get(n, 0) != 0]
    if stray and exact:
        raise SmokeFailure(f"path {name}: kernels launched that the path "
                           f"replaces: {stray}")
    for n, want in EXACT_LAUNCHES[name].items() if exact else ():
        if launches[n] != want:
            raise SmokeFailure(f"path {name}: {n} launched {launches[n]} "
                               f"times, expected {want}")
    staged = getattr(kernels.wrappers().get("vv_pass"), "staged", None)
    print(f"path {name}: vv_pass.staged {staged}", flush=True)
    if exact and name in EXACT_STAGED and staged != EXACT_STAGED[name]:
        raise SmokeFailure(f"path {name}: vv_pass.staged {staged}, "
                           f"expected {EXACT_STAGED[name]}")
    # every B9 launch of every path takes its staged path
    irv_staged = getattr(kernels.wrappers().get("irv_vote"), "staged", None)
    print(f"path {name}: irv_vote.staged {irv_staged}", flush=True)
    if exact and irv_staged is not None and (irv_staged
                                             != launches["irv_vote"]):
        raise SmokeFailure(f"path {name}: irv_vote.staged {irv_staged}, "
                           f"expected {launches['irv_vote']}")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        out = entry(sbs_dev, cfg)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"path {name}: {frame_ms:.2f} ms/frame over {n_frames} frames "
          f"(host clock, synchronized); peak device memory {peak_gb:.2f} GB",
          flush=True)
    return out, dict(launches=launches, vv_pass_staged=staged,
                     irv_vote_staged=irv_staged,
                     frame_ms=frame_ms, peak_memory_gb=peak_gb,
                     first_frame_ms=first_s * 1e3)


def check_outputs(name, out, cfg, disp_bounds):
    """Phase 4a: a path's 1080p outputs are well formed; disp_bounds =
    (num_disp, zero_disp) of the disparity values it may hold."""
    import torch
    dl, dr, il = out
    lo, hi = -disp_bounds[1], disp_bounds[0] - disp_bounds[1]
    for eye, d in (("disp_l", dl), ("disp_r", dr)):
        if tuple(d.shape) != (cfg.num_rows, cfg.num_cols) or d.dtype != \
                torch.float32:
            raise SmokeFailure(f"{name} {eye}: shape {tuple(d.shape)} "
                               f"{d.dtype}")
        if not bool(torch.isfinite(d).all()):
            raise SmokeFailure(f"{name} {eye}: non-finite values")
        if float(d.min()) < lo or float(d.max()) >= hi:
            raise SmokeFailure(f"{name} {eye}: values outside [{lo}, {hi})")
        if float(d.std()) == 0.0:
            raise SmokeFailure(f"{name} {eye}: constant disparities")
        print(f"path {name} {eye}: min {float(d.min()):.3f}, max "
              f"{float(d.max()):.3f}, mean {float(d.mean()):.3f}, std "
              f"{float(d.std()):.3f}", flush=True)
    if tuple(il.shape) != cfg.out_shape or il.dtype != torch.uint8:
        raise SmokeFailure(f"{name} interlaced: shape {tuple(il.shape)} "
                           f"{il.dtype}")
    if float(il.float().std()) < 10.0:
        raise SmokeFailure(f"{name} interlaced: degenerate image")


def check_small_frame(label, cfg):
    """Phase 4b: a small frame on the card (kernels) against the same
    frame on the CPU (plain versions): disparities before the median and
    bilateral filters and the labels exact; final disparities and
    interlace within the float32 rounding of torch.exp on the two
    devices.  A lowres config goes through process_frame_lowres."""
    import numpy as np
    import torch
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops.scale import tx_scale_bilinear

    sbs = stereo_sbs(cfg.num_rows, cfg.num_cols)
    entry = (pipeline.process_frame_lowres if cfg.lowres
             else pipeline.process_frame)
    res = {}
    for dev in ("cuda", "cpu"):
        l, r = (t.contiguous().to(dev) for t in
                pipeline.demux_sbs(torch.from_numpy(sbs)))
        if cfg.lowres:
            l, r = (tx_scale_bilinear(t, cfg.num_rows_disp,
                                      cfg.num_cols_disp).contiguous()
                    for t in (l, r))
        raw = pipeline.raw_disparities(l, r, cfg)
        if cfg.use_hslo and dev == "cuda":
            # the penalties must be strong enough to move disparities, or
            # the comparison below would not see the optimisation at all
            wta = pipeline.raw_disparities(l, r, cfg.replace(use_hslo=False))
            moved = float((raw[0] != wta[0]).float().mean())
            print(f"small frame {label}: the scanline optimisation changes "
                  f"{moved:.4f} of the left eye's disparities", flush=True)
            if moved < 0.02:
                raise SmokeFailure(f"small frame {label}: the penalties "
                                   f"move too few disparities")
        final = entry(sbs, cfg, device=dev)
        res[dev] = [x.cpu().numpy() for x in (*raw, *final)]
    g, c = res["cuda"], res["cpu"]
    for i, name in enumerate(("raw disp_l", "raw disp_r", "labels_l",
                              "labels_r")):
        if not np.array_equal(g[i], c[i]):
            raise SmokeFailure(f"small frame {label}: {name} differs card "
                               f"vs CPU")
    dmax = max(float(np.abs(g[4] - c[4]).max()),
               float(np.abs(g[5] - c[5]).max()))
    same = float(np.mean(g[6] == c[6]))
    print(f"small frame {label} {cfg.num_rows}x{cfg.num_cols} "
          f"D={cfg.num_disp}: raw disparities and labels equal card vs CPU; "
          f"final disparity max diff {dmax:.3g}; interlaced identical on "
          f"{same:.5f} of subpixels", flush=True)
    if dmax > 1e-4 or same < 0.999:
        raise SmokeFailure(f"small frame {label}: card and CPU outputs "
                           f"disagree")
    return dict(final_disp_max_diff=dmax, interlaced_same=same)


def small_configs():
    """The small configurations of phase 4b."""
    from stereo_to_multiview_tpu_torch.config import PipelineConfig
    base = PipelineConfig(num_rows=96, num_cols=160, num_rows_out=96,
                          num_cols_out=160, num_disp=32, zero_disp=16,
                          usd=12, lsd=6, num_views=8, irv_iterations=3,
                          bilateral_radius=3, feather_radius=5)
    return {
        "plain": base,
        "hslo+median+resampled": base.replace(
            use_hslo=True, use_median=True, num_views=6, num_rows_out=120,
            num_cols_out=192, hslo_H1=3000.0, hslo_H2=9000.0),
        "lowres": base.replace(num_rows_disp=48, num_cols_disp=80,
                               disp_scale=0.5, num_disp=16, zero_disp=8),
        # the configuration limits the card once refused halfway through
        # a frame
        "bilateral_radius=10": base.replace(bilateral_radius=10),
        "num_disp=30": base.replace(num_disp=30, zero_disp=15),
        "num_views=40": base.replace(num_views=40),
        # the band engine's dials
        "band_qscale=510": base.replace(band_qscale=510.0),
        "band_qscale=64": base.replace(band_qscale=64.0),
        "band_lossy_wta": base.replace(band_lossy_wta=True),
        "band_lossy_wta band_digits=1": base.replace(band_lossy_wta=True,
                                                     band_digits=1),
        "hslo band_qscale=510": base.replace(use_hslo=True, band_qscale=510.0,
                                             hslo_H1=3000.0, hslo_H2=9000.0),
    }


def stream_frames(rows: int, cols: int, n: int):
    """n distinct SBS frames of (rows, 2 * cols): the bud pair as
    `stereo_sbs` builds it, both eyes cropped at columns 8 * i."""
    import numpy as np
    wide = stereo_sbs(rows, cols + 8 * (n - 1))
    half = wide.shape[1] // 2
    l, r = wide[:, :half], wide[:, half:]
    return [np.ascontiguousarray(np.concatenate(
        [l[:, 8 * i:8 * i + cols], r[:, 8 * i:8 * i + cols]], axis=1))
        for i in range(n)]


def stream_host_costs(frame_dir, y4m, frame, reps: int = 5) -> dict:
    """Host-clock ms of what a streamed frame costs beside its compute:
    a BMP decode, a Y4M decode (the reader Y4MSource takes), the copy of
    a decoded frame into pinned memory, and its upload from pageable and
    from pinned memory (synchronized)."""
    import torch
    from stereo_to_multiview_tpu_torch.models import stream as st
    from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

    def ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return round((time.perf_counter() - t0) * 1e3 / reps, 3)

    dev = torch.device("cuda")
    pinned = torch.empty(frame.shape, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(frame.shape, dtype=torch.uint8, device=dev)
    bmp = os.path.join(frame_dir, sorted(os.listdir(frame_dir))[0])
    out = {"bmp_decode": ms(lambda: read_bmp(bmp))}
    if y4m is not None:
        reader = st.Y4MSource(y4m)._reader
        out["y4m_decode"] = ms(lambda: reader.read_frame() is not None
                               or reader.rewind())
    out["copy_into_pinned"] = ms(
        lambda: pinned.numpy().__setitem__(Ellipsis, frame))
    out["upload_pageable"] = ms(
        lambda: torch.as_tensor(frame).to(dev))
    out["upload_pinned"] = ms(lambda: dst.copy_(pinned, non_blocking=True))
    return out


def check_stream(label, cfg, path, n_distinct, n_frames, combos, tmp, card):
    """The stream driver (`models.stream.stream`) over sources of
    n_distinct frames written to `tmp`: BMP files (FrameSource, and the
    native decode queue) and one Y4M file (Y4MSource), each combo (source,
    depth, readback) for n_frames.  Every frame's three outputs must be
    bit-equal to process_frame on the same frame (for the Y4M source, on
    the decoded frame), checked on the device without a host sync.  The
    first combo runs with the launch counts zeroed just before and read
    just after: each kernel of the path must have launched, those of
    EXACT_LAUNCHES[path] once a frame times their count.  Prints fps and
    ms beside process_frame's own ms on a device-resident frame."""
    import itertools
    import torch
    from stereo_to_multiview_tpu_torch import kernels, native
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.models import stream as st
    from stereo_to_multiview_tpu_torch.utils.bmp import write_bmp
    from stereo_to_multiview_tpu_torch.utils.y4m import Y4MReader, write_y4m

    dev = torch.device("cuda")
    frames = stream_frames(cfg.num_rows, cfg.num_cols, n_distinct)
    frame_dir = os.path.join(tmp, label)
    os.makedirs(frame_dir)
    for i, f in enumerate(frames):
        write_bmp(os.path.join(frame_dir, f"frame_{i:03d}.bmp"), f)
    sources = {"bmp": frames}
    y4m = None
    if any(c[0] == "Y4MSource" for c in combos):
        y4m = os.path.join(tmp, f"{label}.y4m")
        write_y4m(y4m, frames, colorspace="C444")
        sources["y4m"] = list(Y4MReader(y4m))
    refs = {k: [pipeline.process_frame(torch.from_numpy(f).to(dev), cfg)
                for f in fs] for k, fs in sources.items()}
    del sources
    sbs_dev = torch.from_numpy(frames[0]).to(dev)
    pf_ms = time_ms(lambda: pipeline.process_frame(sbs_dev, cfg), 10)
    del sbs_dev
    host = stream_host_costs(frame_dir, y4m, frames[0])
    print(f"stream {label}: process_frame {pf_ms:.2f} ms a frame on a "
          f"device-resident frame ({cfg.num_rows}x{cfg.num_cols}); host "
          f"costs a frame (host clock, ms): {host} on {card}", flush=True)
    rows = []
    for n, (source, depth, readback) in enumerate(combos):
        queue = None
        if source == "FrameSource":
            src, kind, reader = (st.FrameSource(frame_dir, loop=True,
                                                max_frames=n_frames),
                                 "bmp", "python")
        elif source == "native_source":
            queue = st.native_source(frame_dir,
                                     loops=-(-n_frames // n_distinct))
            src, kind = itertools.islice(queue, n_frames), "bmp"
            reader = ("native" if isinstance(queue, native.NativeFrameQueue)
                      else "python (no host compiler)")
        else:
            src = st.Y4MSource(y4m, loop=True, max_frames=n_frames)
            kind, reader = "y4m", src.reader
        differs = torch.zeros((), dtype=torch.bool, device=dev)
        seen = []

        def on_frame(i, dl, dr, il, kind=kind, seen=seen, differs=differs):
            ref = refs[kind][i % n_distinct]
            seen.append(i)
            for a, b in zip((dl, dr, il), ref):
                differs.logical_or_((a != b).any())

        if n == 0:
            reset_counts()
        stats = st.stream(src, cfg, on_frame=on_frame, verbose=False,
                          depth=depth, readback=readback)
        if n == 0:
            launches = read_counts(f"stream {label}", {
                k: v * n_frames for k, v in EXACT_LAUNCHES[path].items()},
                zero=NOT_ON_PATH[path])
            idle = [k for k, c in launches.items()
                    if k not in NOT_ON_PATH[path] and c < n_frames]
            if idle:
                raise SmokeFailure(f"stream {label}: kernels launched fewer "
                                   f"times than frames: {idle}")
        if queue is not None and hasattr(queue, "close"):
            queue.close()
        if seen != list(range(n_frames)):
            raise SmokeFailure(f"stream {label} {source}: frames {seen}")
        if bool(differs):
            raise SmokeFailure(f"stream {label} {source} depth {depth} "
                               f"{readback}: outputs differ from "
                               f"process_frame")
        row = dict(source=source, reader=reader, depth=depth,
                   readback=readback, frames_run=n_frames, **stats,
                   process_frame_ms=pf_ms, host_ms=host)
        rows.append(row)
        print(f"stream {label}: {source} (reader {reader}) depth {depth} "
              f"readback {readback}: {stats['fps']:.2f} fps, ms_mean "
              f"{stats['ms_mean']:.2f}, ms_min {stats['ms_min']:.2f}, ms_max "
              f"{stats['ms_max']:.2f} over {stats['frames']} metered of "
              f"{n_frames} frames, each bit-equal to process_frame "
              f"({pf_ms:.2f} ms device-resident) on {card}", flush=True)
    del refs
    torch.cuda.empty_cache()
    return rows


def check_xla_path(sbs, cfg, card):
    """engine="xla" at the main path's configuration through `run_path`
    (its launch set: B1, B7's labels, B8/B9, the fused occlusion stage;
    three timed frames, peak memory), its outputs' form, and the share of
    pixels whose disparities (before the bilateral filter and after) and
    labels equal the band engine's."""
    import torch
    from stereo_to_multiview_tpu_torch.models import pipeline

    xcfg = cfg.replace(engine="xla")
    out, res = run_path(XLA, pipeline.process_frame, sbs, xcfg, 3)
    check_outputs(XLA, out, xcfg, pipeline.synth_disp_bounds(xcfg))
    band = pipeline.process_frame(sbs, cfg)
    img_l, img_r = (t.contiguous() for t in pipeline.demux_sbs(
        torch.from_numpy(sbs).to(out[2].device)))
    raw = [pipeline.raw_disparities(img_l, img_r, c) for c in (xcfg, cfg)]
    same = lambda a, b: float((a == b).float().mean())
    res["equal_band"] = {
        "raw disparities": [same(a, b) for a, b in zip(raw[0][:2],
                                                       raw[1][:2])],
        "labels": [same(a, b) for a, b in zip(raw[0][2:], raw[1][2:])],
        "final disparities": [same(a, b) for a, b in zip(out[:2],
                                                         band[:2])]}
    print(f"path {XLA}: share of pixels equal to the band engine's (left, "
          f"right): {res['equal_band']}; {res['frame_ms']:.1f} ms a frame, "
          f"peak {res['peak_memory_gb']:.2f} GB on {card}", flush=True)
    del out, band, raw
    torch.cuda.empty_cache()
    return res


def xla_small_configs():
    """96x160 frames of the XLA engine (usd 6: at xla_agg_qscale 8 the
    prefix sums stay below 2^24)."""
    base = small_configs()["plain"].replace(engine="xla", usd=6, lsd=3)
    return {"xla qscale=8": base.replace(xla_agg_qscale=8.0),
            "xla qscale=0": base,
            "xla qscale=8 hslo+median": base.replace(
                xla_agg_qscale=8.0, use_hslo=True, use_median=True,
                hslo_H1=8.0, hslo_H2=24.0)}


def check_small_xla(label, cfg):
    """A small frame of the XLA engine on the card against the CPU: the
    raw disparities, labels, final disparities and interlaced frame.
    Required exact at xla_agg_qscale 8; at 0 (float32 aggregation, summed
    in the same order on both devices) a share of at most 1e-3 of pixels
    may differ.  Returns the shares that differ."""
    import numpy as np
    import torch
    from stereo_to_multiview_tpu_torch.models import pipeline

    sbs = stereo_sbs(cfg.num_rows, cfg.num_cols)
    res = {}
    for dev in ("cuda", "cpu"):
        l, r = (t.contiguous().to(dev) for t in
                pipeline.demux_sbs(torch.from_numpy(sbs)))
        raw = pipeline.raw_disparities(l, r, cfg)
        final = pipeline.process_frame(sbs, cfg, device=dev)
        res[dev] = [x.cpu().numpy() for x in (*raw, *final)]
    names = ("raw disp_l", "raw disp_r", "labels_l", "labels_r", "disp_l",
             "disp_r", "interlaced")
    shares = {n: float(np.mean(a != b)) for n, a, b in
              zip(names, res["cuda"], res["cpu"])}
    print(f"small frame {label} {cfg.num_rows}x{cfg.num_cols} "
          f"D={cfg.num_disp}: share differing card vs CPU {shares}",
          flush=True)
    limit = 0.0 if cfg.xla_agg_qscale > 0 else 1e-3
    if max(shares.values()) > limit:
        raise SmokeFailure(f"small frame {label}: card and CPU differ "
                           f"beyond {limit}")
    return shares


APP_IMAGE_NAMES = ("00_left", "01_right", "04_disp_raw_l", "04_disp_raw_r",
                   "05_outliers_l", "05_outliers_r", "06_disp_l",
                   "06_disp_r", "07_mask_l", "07_mask_r")


def run_apps(frame_dir, cfg, tmp, card):
    """The two apps through their main([...]) on the card: the video app
    on the frame directory (--frames 12 --depth 2 --readback sync,
    --out-dir), the image app on the 1080p bud pair (--npy).  Each must
    return 0 and write the files the JAX package's app writes, under the
    same names."""
    import numpy as np
    from stereo_to_multiview_tpu_torch.apps import image_io, video_io
    from stereo_to_multiview_tpu_torch.utils.bmp import write_bmp

    nums = lambda *ks: [str(getattr(cfg, k)) for k in ks]
    res = {}
    out = os.path.join(tmp, "video_out")
    t0 = time.perf_counter()
    rc = video_io.main([
        frame_dir, *nums("num_views", "angle", "num_cols_out",
                         "num_rows_out", "num_disp", "zero_disp", "ad_coeff",
                         "census_coeff", "ucd", "lcd", "usd", "lsd",
                         "irv_thresh_s", "irv_thresh_h"),
        "--frames", "12", "--depth", "2", "--readback", "sync",
        "--out-dir", out])
    res["video_s"] = time.perf_counter() - t0
    want = sorted(f"{k}_{i:04d}.png" for k in ("disp_l", "interlaced")
                  for i in range(12))
    if rc != 0 or sorted(os.listdir(out)) != want:
        raise SmokeFailure(f"video app: rc {rc}, files "
                           f"{sorted(os.listdir(out))[:6]}...")
    print(f"app video_io: rc 0, {len(want)} files as the JAX app names "
          f"them, {res['video_s']:.1f} s (12 frames, PNG writes included) "
          f"on {card}", flush=True)
    img_dir = os.path.join(tmp, "img")
    os.makedirs(img_dir)
    sbs = stereo_sbs(cfg.num_rows, cfg.num_cols)
    write_bmp(os.path.join(img_dir, "left.bmp"), sbs[:, :cfg.num_cols])
    write_bmp(os.path.join(img_dir, "right.bmp"), sbs[:, cfg.num_cols:])
    out = os.path.join(tmp, "image_out")
    t0 = time.perf_counter()
    rc = image_io.main([
        "left", "right", *nums("ad_coeff", "census_coeff", "num_disp",
                               "zero_disp", "ucd", "lcd", "usd", "lsd",
                               "num_views", "angle", "num_cols_out",
                               "num_rows_out", "irv_thresh_s",
                               "irv_thresh_h"),
        "--img-dir", img_dir, "--out-dir", out, "--npy"])
    res["image_s"] = time.perf_counter() - t0
    names = [*APP_IMAGE_NAMES,
             *(f"08_view_{v}" for v in range(cfg.num_views)),
             "09_interlaced"]
    want = sorted(f"{n}.{e}" for n in names for e in ("png", "npy"))
    if rc != 0 or sorted(os.listdir(out)) != want:
        raise SmokeFailure(f"image app: rc {rc}, files "
                           f"{sorted(os.listdir(out))[:6]}...")
    disp = np.load(os.path.join(out, "06_disp_l.npy"))
    il = np.load(os.path.join(out, "09_interlaced.npy"))
    if (disp.shape != (cfg.num_rows, cfg.num_cols)
            or not np.isfinite(disp).all() or il.shape != cfg.out_shape):
        raise SmokeFailure("image app: malformed outputs")
    print(f"app image_io: rc 0, {len(want)} files as the JAX app names "
          f"them, {res['image_s']:.1f} s (the dump's stages, PNG and NPY "
          f"writes included) on {card}", flush=True)
    return res


def runtime_checks(card) -> dict:
    """The stream driver, the XLA engine and the apps (phase 5)."""
    import shutil
    import tempfile
    import torch
    from stereo_to_multiview_tpu_torch import config

    tmp = tempfile.mkdtemp(prefix="stm_smoke_")
    try:
        cfg = config.HD1080_D128
        combos = [(src, depth, rb)
                  for src in ("FrameSource", "native_source", "Y4MSource")
                  for depth in (2, 1) for rb in ("full", "sync")]
        rep = {"stream": check_stream(MAIN, cfg, MAIN, 8, 30, combos, tmp,
                                      card)}
        rep["apps"] = run_apps(os.path.join(tmp, MAIN), cfg, tmp, card)
        shutil.rmtree(os.path.join(tmp, MAIN))
        cfg4k = config.UHD4K_16V
        rep["stream"] += check_stream(
            UHD4K, cfg4k, UHD4K, 4, 10,
            [("FrameSource", 2, "full"), ("FrameSource", 2, "sync")], tmp,
            card)
        torch.cuda.empty_cache()
        rep["xla"] = check_xla_path(stereo_sbs(cfg.num_rows, cfg.num_cols),
                                    cfg, card)
        rep["xla_small_frames"] = {
            label: check_small_xla(label, scfg)
            for label, scfg in xla_small_configs().items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rep


def halo_rows(rows: int, n: int, i: int, usd: int):
    """Shard i of n of a frame of `rows` rows, extended by the image halo
    of 3 * usd rows as the halo path's exchange fills it (edge rows
    replicated outside the frame): (row indices into the frame, the
    extended shard's row offset)."""
    import numpy as np
    halo, loc = 3 * usd, rows // n
    row0 = i * loc - halo
    return np.clip(np.arange(row0, row0 + loc + 2 * halo), 0, rows - 1), row0


def check_arms_halo(chk, frames: dict):
    """B1's halo-shard mode (`B1_HALO`) against its plain version: both
    eyes of each extended shard in one launch."""
    import torch
    from stereo_to_multiview_tpu_torch import config
    for suffix, (n, i, usd, preset) in B1_HALO.items():
        cfg = config.HD1080_D128 if preset == MAIN else config.UHD4K_16V
        img_l, img_r = frames[preset]
        idx, row0 = halo_rows(cfg.num_rows, n, i, usd)
        idx = torch.from_numpy(idx).to(img_l.device)
        ext = [t.index_select(0, idx).contiguous() for t in (img_l, img_r)]
        arms = record_arms(chk, "B1 cross_arms" + suffix, *ext,
                           (cfg.ucd, cfg.lcd, usd, cfg.lsd),
                           halo=(row0, cfg.num_rows))
        print(f"  B1{suffix}: {ext[0].shape[0]} rows from frame row "
              f"{row0}, mean UP arm {float(arms[0][0].float().mean()):.2f}",
              flush=True)
        del ext, arms
    torch.cuda.empty_cache()


def smooth_sbs(rows: int, cols: int, seed: int, shift: int):
    """A small SBS frame of smoothed noise, the right eye `shift` columns
    over (the frames of the JAX package's sharding tests)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (rows, cols + 2 * shift, 3)).astype(
        np.float32)
    k = np.ones(3) / 3.0
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    return np.concatenate([base[:, :cols].astype(np.uint8),
                           base[:, shift:shift + cols].astype(np.uint8)],
                          axis=1)


def shard_small_cfg():
    """The XLA engine's row strategies at the sizes of the JAX package's
    halo test: 96x64, D = 8, usd 7, integer costs (xla_agg_qscale 8)."""
    from stereo_to_multiview_tpu_torch.config import PipelineConfig
    return PipelineConfig(num_rows=96, num_cols=64, num_rows_out=96,
                          num_cols_out=64, num_disp=8, zero_disp=4, usd=7,
                          lsd=3, irv_iterations=2, bilateral_radius=2,
                          feather_radius=3, num_views=4, engine="xla",
                          xla_agg_qscale=8.0)


def shard_jobs():
    """Phase 6's sharded paths: (name, kind, config name, mesh name, timed
    frames)."""
    return [
        (HALO2, "halo", "HD1080_D128", "row2", 3),
        (HALO4, "halo", "HD1080_D128", "row4", 3),
        (HALO4K_ROW, "halo", "UHD4K_16V", "row2", 2),
        (HALO4K_2D, "view", "UHD4K_16V", "row2_view2", 2),
        (HALO_HSLO, "halo", "HSLO_4K_NO_MEDIAN", "row2", 2),
        (DISP4, "disp", "HD1080_D128", "disp4", 2),
        (DISP4_FRAME, "disp_frame", "HD1080_D128", "disp4", 2),
        (DISP4_HSLO, "disp", "HSLO_4K_NO_MEDIAN", "disp4", 2),
        (XLA_HALO, "halo", "SMALL_XLA", "row4", 3),
        (XLA_SHARDED, "sharded", "SMALL_XLA", "row4", 3),
    ]


def shard_cfg(name: str):
    from stereo_to_multiview_tpu_torch import config
    return {"HD1080_D128": config.HD1080_D128,
            "UHD4K_16V": config.UHD4K_16V,
            "HSLO_4K_NO_MEDIAN": config.HD1080_D128_HSLO_4K.replace(
                use_median=False),
            "SMALL_XLA": shard_small_cfg()}[name]


def shard_frame(cfg_name: str):
    cfg = shard_cfg(cfg_name)
    if cfg_name == "SMALL_XLA":
        return smooth_sbs(cfg.num_rows, cfg.num_cols, 7, 4)
    return stereo_sbs(cfg.num_rows, cfg.num_cols)


def run_shard_job(job, meshes, frames):
    """One sharded path in one rank: the counted frame (launch counts,
    collectives and peak memory from zero), then the timed frames (host
    clock, device synchronized; ranks time-share the card).  Returns the
    rank's report, with the assembled outputs on the mesh's first rank."""
    import torch
    import torch.distributed as dist
    from stereo_to_multiview_tpu_torch import kernels
    from stereo_to_multiview_tpu_torch.models.pipeline import demux_sbs
    from stereo_to_multiview_tpu_torch.parallel import (
        disp_sharded_disparities, disp_sharded_process_frame, gather_rows,
        halo_process_frame, shard_rows, sharded_process_frame)
    name, kind, cfg_name, mesh_name, n_frames = job
    mesh, cfg = meshes[mesh_name], shard_cfg(cfg_name)
    dist.barrier()
    if not mesh.member:
        return None
    if cfg_name not in frames:
        frames[cfg_name] = shard_frame(cfg_name)
    sbs = frames[cfg_name]
    if kind in ("disp", "disp_frame"):
        fn = (disp_sharded_disparities(mesh, cfg) if kind == "disp"
              else disp_sharded_process_frame(mesh, cfg))
        arg = (sbs if kind == "disp_frame" else tuple(
            t.contiguous() for t in demux_sbs(torch.from_numpy(sbs))))
    else:
        view = "view" if kind == "view" else None
        fn = (sharded_process_frame(mesh, cfg) if kind == "sharded"
              else halo_process_frame(mesh, cfg, view_axis=view))
        arg = (shard_rows(sbs, mesh, "row"),)
    arg = arg if isinstance(arg, tuple) else (arg,)
    arg = tuple(torch.as_tensor(a).cuda() for a in arg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mesh.stats.clear()
    out = fn(*arg)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in kernels.wrappers().items()}
    comm_first = {op: dict(v) for op, v in mesh.stats.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mesh.stats.clear()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        out = fn(*arg)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    exch_ms = sum(v["seconds"] for v in mesh.stats.values()) * 1e3 \
        / n_frames
    if kind not in ("disp", "disp_frame"):
        out = tuple(gather_rows(o, mesh, "row") for o in out)
    first = mesh.rank == int(mesh.ranks.flat[0])
    return dict(launches=launches, comm=comm_first, frame_ms=frame_ms,
                exchange_ms=exch_ms, peak_memory_gb=peak_gb,
                out=tuple(o.cpu() for o in out) if first else None)


def shard_rank(jobs):
    """The rank function of phase 6 (run through parallel.launch): build
    every mesh (collectively, in one order on every rank), then run each
    job; returns {job name: report}."""
    from stereo_to_multiview_tpu_torch.parallel import make_mesh
    import torch.distributed as dist
    world = dist.get_world_size()
    meshes = {}
    if world == 1:
        meshes["row1"] = make_mesh((1,), ("row",))
    else:
        meshes["row2"] = make_mesh((2,), ("row",), [0, 1])
        meshes["row4"] = make_mesh((4,), ("row",))
        meshes["row2_view2"] = make_mesh((2, 2), ("row", "view"))
        meshes["disp4"] = make_mesh((4,), ("disp",))
    frames = {}
    return {job[0]: run_shard_job(job, meshes, frames) for job in jobs}


def shard_references(card):
    """The unsharded outputs each sharded path must equal, computed on
    the card in this process: `process_frame` (the row strategies), the
    unsharded band core and `replicated_tail` of it (the disparity
    planes).  Moved to the host."""
    import torch
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops.band import (
        band_stereo_core_chunked)
    from stereo_to_multiview_tpu_torch.ops.cross import cross_arms_lr
    from stereo_to_multiview_tpu_torch.parallel.dispshard import (
        replicated_tail)
    refs = {}
    for name, kind, cfg_name, _, _ in shard_jobs():
        cfg, sbs = shard_cfg(cfg_name), shard_frame(cfg_name)
        sbs_dev = torch.from_numpy(sbs).cuda()
        if kind in ("halo", "view", "sharded"):
            out = pipeline.process_frame(sbs_dev, cfg)
        else:
            img_l, img_r = (t.contiguous() for t in pipeline.demux_sbs(
                sbs_dev))
            arms = cross_arms_lr(img_l, img_r, cfg.ucd, cfg.lcd, cfg.usd,
                                 cfg.lsd)
            out = band_stereo_core_chunked(img_l, img_r, *arms, cfg)
            if kind == "disp_frame":
                out = replicated_tail(img_l, img_r, *out, *arms, cfg)
            del img_l, img_r, arms
        refs[name] = tuple(o.cpu() for o in out)
        del out, sbs_dev
        torch.cuda.empty_cache()
    return refs


def check_shard_path(name, reports, ref, card):
    """One sharded path's reports from its ranks: every rank launched the
    path's kernels (and none it replaces), the assembled outputs equal
    the unsharded ones bit for bit; prints its ms a frame, ms in
    exchanges and peak memory per rank, as ranks time-sharing one card."""
    import torch
    want, never = SHARD_LAUNCHES[name]
    mine = [r for r in reports if r is not None]
    for k, r in enumerate(mine):
        missing = sorted(n for n in want if r["launches"].get(n, 0) < 1)
        stray = sorted(n for n in never if r["launches"].get(n, 0))
        if missing or stray:
            raise SmokeFailure(f"path {name}: rank {k} did not launch "
                               f"{missing}, launched {stray}")
    out = mine[0]["out"]
    if len(out) != len(ref):
        raise SmokeFailure(f"path {name}: {len(out)} outputs, expected "
                           f"{len(ref)}")
    for i, (o, r) in enumerate(zip(out, ref)):
        if o.shape != r.shape or o.dtype != r.dtype or not torch.equal(o, r):
            bad = (int((o != r).sum()) if o.shape == r.shape else "shape")
            raise SmokeFailure(f"path {name}: output {i} differs from the "
                               f"unsharded one ({bad})")
    rep = dict(launches=mine[0]["launches"], ranks=len(mine),
               shard_ms=max(r["frame_ms"] for r in mine),
               exchange_ms=max(r["exchange_ms"] for r in mine),
               peak_memory_gb=[r["peak_memory_gb"] for r in mine],
               collectives=mine[0]["comm"])
    staged = {op: v["staged"] for op, v in rep["collectives"].items()}
    print(f"path {name}: bit-equal to the unsharded outputs; "
          f"{rep['shard_ms']:.2f} ms a frame, {rep['exchange_ms']:.2f} ms "
          f"in exchanges, peak memory per rank "
          f"{', '.join(f'{g:.3f}' for g in rep['peak_memory_gb'])} GB "
          f"({rep['ranks']} ranks time-sharing one card, not a scaling "
          f"result; {card})", flush=True)
    print(f"path {name}: collectives of the counted frame "
          f"{ {op: v['calls'] for op, v in rep['collectives'].items()} }, "
          f"staged through pinned host memory {staged}", flush=True)
    print(f"path {name}: launches (rank 0) "
          f"{ {n: c for n, c in rep['launches'].items() if c} }", flush=True)
    return rep


def shard_checks(chk, card) -> dict:
    """Phase 6: B1's halo-shard mode on the card, then every sharded path
    in ranks time-sharing the card over gloo, and NCCL as a world of one;
    returns {path name: report}."""
    import torch
    from stereo_to_multiview_tpu_torch import config
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.parallel.launch import launch
    frames = {}
    for preset, cfg in ((MAIN, config.HD1080_D128),
                        (UHD4K, config.UHD4K_16V)):
        sbs = torch.from_numpy(stereo_sbs(cfg.num_rows, cfg.num_cols))
        frames[preset] = tuple(t.contiguous().cuda()
                               for t in pipeline.demux_sbs(sbs))
    check_arms_halo(chk, frames)
    del frames
    refs = shard_references(card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = launch(shard_rank, SHARD_RANKS, args=(shard_jobs(),),
                     backend="gloo", timeout_s=900.0)
    print(f"sharding: {SHARD_RANKS} gloo ranks on one card ran "
          f"{len(shard_jobs())} paths in {time.perf_counter() - t0:.1f} s",
          flush=True)
    paths = {name: check_shard_path(name, [r[name] for r in reports],
                                    refs[name], card)
             for name, *_ in shard_jobs()}
    row_il, view_il = (reports[0][n]["out"][2] for n in (HALO4K_ROW,
                                                         HALO4K_2D))
    if not torch.equal(row_il, view_il):
        raise SmokeFailure(f"{HALO4K_2D}: interlace differs from the "
                           f"row-only mesh's")
    print(f"path {HALO4K_2D}: interlace bit-equal to the row-only mesh's",
          flush=True)
    # NCCL as a world of one: the NCCL code path, no neighbour traffic
    job = (NCCL1, "halo", "HD1080_D128", "row1", 3)
    reports = launch(shard_rank, 1, args=([job],), backend="nccl",
                     timeout_s=600.0)
    paths[NCCL1] = check_shard_path(NCCL1, [reports[0][NCCL1]], refs[HALO2],
                                    card)
    return paths


def time_frames(root: str, n_frames: int) -> int:
    """`--frames N [--package-root DIR]`: the four preset paths and the two
    dial paths (where the package has the dials) alone, N timed frames
    each, on the package found under DIR (this checkout by default).  To compare two commits on one card, unpack the other commit
    into a directory and run this script once with each root, in turn."""
    import torch
    sys.path.insert(0, root)
    from stereo_to_multiview_tpu_torch import config, kernels
    from stereo_to_multiview_tpu_torch.models import pipeline

    card = gpu_line()
    kernels.build_kernels()
    sbs = stereo_sbs(config.HD1080_D128.num_rows, config.HD1080_D128.num_cols)
    sbs4k = stereo_sbs(config.UHD4K_16V.num_rows, config.UHD4K_16V.num_cols)
    main_cfg = config.HD1080_D128
    for name, entry, cfg, frame in (
            (MAIN, pipeline.process_frame, main_cfg, sbs),
            (QSCALE510, pipeline.process_frame,
             main_cfg.replace(band_qscale=510.0), sbs),
            (LOSSY, pipeline.process_frame,
             main_cfg.replace(band_lossy_wta=True), sbs),
            (HSLO4K, pipeline.process_frame, config.HD1080_D128_HSLO_4K,
             sbs),
            (LOWRES, pipeline.process_frame_lowres, config.HD1080_LOWRES,
             sbs),
            (UHD4K, pipeline.process_frame, config.UHD4K_16V, sbs4k)):
        try:
            pipeline.check_ported(cfg)
        except NotImplementedError as e:
            print(f"frame: {name} not in the package under {root}: {e}",
                  flush=True)
            continue
        try:
            _, res = run_path(name, entry, frame, cfg, n_frames,
                              exact=os.path.samefile(root, HERE))
        except (SmokeFailure, RuntimeError, ValueError) as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(f"frame: {res['frame_ms']:.2f} ms per frame over {n_frames} "
              f"frames at {name}, package under {root}, on {card}",
              flush=True)
        torch.cuda.empty_cache()
    return 0


def print_ptxas(logs: dict):
    """Each source's nvcc seconds, then each built kernel's (mangled)
    name, its registers and spills, from nvcc's -Xptxas -v report."""
    for name, log in logs.items():
        for line in log.splitlines():
            if (line.startswith("nvcc ") or "Compiling entry" in line
                    or "registers" in line or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}", flush=True)


def stream_checks(root: str) -> int:
    """`--stream-checks [--package-root DIR]`: only the checks that hold
    the staged B1 and B2 and the streamed B3, B4, B5, B6, B8, B9, B10
    and B13 against their plain versions (the stereo core's at 1080p
    with the scanline optimisation's route, B13 and B3 at their edges, B1
    at its thresholds' and crops' edges, B2 at D=130 and B2 and B3 on the
    4K preset's third row chunk, the IRV kernels in each round and B10,
    then the edge frames, then the dials' modes of B2-B4 and B6), on the
    package under DIR.  Exit 1 if one fails: a deliberately broken copy
    of a kernel must."""
    import torch
    sys.path.insert(0, root)
    from stereo_to_multiview_tpu_torch import config, kernels
    from stereo_to_multiview_tpu_torch.models import pipeline

    print(f"gpu: {gpu_line()}", flush=True)
    print_ptxas(kernels.build_kernels())
    cfg = config.HD1080_D128
    sbs = torch.from_numpy(stereo_sbs(cfg.num_rows, cfg.num_cols))
    img_l, img_r = (t.contiguous() for t in
                    pipeline.demux_sbs(sbs.to(torch.device("cuda"))))
    chk = KernelChecks(reps=5)
    try:
        arms_l, arms_r = check_core_kernels(chk, img_l, img_r, cfg)
        torch.cuda.empty_cache()
        check_hslo_edges(chk, img_l, img_r, cfg)
        check_shear_edges(chk, img_l, img_r, cfg)
        # B3 at the lowres preset's shapes (540x960, D=64: half a chunk,
        # the rows cut into segments of x)
        from stereo_to_multiview_tpu_torch.ops import costkern
        from stereo_to_multiview_tpu_torch.ops.scale import tx_scale_bilinear
        lcfg = config.HD1080_LOWRES
        low = [tx_scale_bilinear(t, lcfg.num_rows_disp,
                                 lcfg.num_cols_disp).contiguous()
               for t in (img_l, img_r)]
        chk.suffix = AT_LOWRES
        record_shear(chk, "B3 shear_right",
                     costkern.cost_pair(*cost_args(*low, lcfg)),
                     lcfg.zero_disp)
        chk.suffix = ""
        del low
        check_arms_edges(chk, img_l, img_r, cfg)
        check_cost_d130(chk, img_l, img_r, cfg)
        cfg4k = config.UHD4K_16V
        sbs4k = torch.from_numpy(stereo_sbs(cfg4k.num_rows, cfg4k.num_cols))
        check_cost_chunk(chk, *(t.contiguous() for t in pipeline.demux_sbs(
            sbs4k.to(torch.device("cuda")))), cfg4k)
        del sbs4k
        torch.cuda.empty_cache()
        check_disp_kernels(chk, img_l, img_r, arms_l, arms_r, cfg)
        check_vstream_edges(chk, chk.raw[0], chk.raw[2][0], arms_l, cfg)
        check_vote_edges(chk, chk.raw[0], chk.raw[2][0], arms_l, cfg)
        check_vpass_edges(chk, arms_l, cfg)
        check_rowspan_edges(chk, chk.raw[0], chk.raw[2][0], arms_l, cfg)
        check_hstream_edges(chk, img_l, img_r, cfg)
        check_band_dials(chk, img_l, img_r, arms_l, cfg)
        check_dial_edges(chk, img_l, img_r, cfg)
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


def synth_checks(root: str) -> int:
    """`--synth-checks [--package-root DIR]`: only the synthesis kernels,
    on the package under DIR: G1 and B12 (both modes) on the 1080p
    frame's stages and at their edges, the synthesis entries as paths,
    B19 and B20 (at their edges and as a path), then the preset paths'
    interlaced frames (one frame each, launch counts held) against the
    plain chain, and the 4K frame's G1, B12 and B19.  Exit 1 if one
    fails: a deliberately broken copy must."""
    import torch
    sys.path.insert(0, root)
    from stereo_to_multiview_tpu_torch import config, kernels
    from stereo_to_multiview_tpu_torch.models import pipeline

    print(f"gpu: {gpu_line()}", flush=True)
    print_ptxas(kernels.build_kernels())
    cfg = config.HD1080_D128
    sbs = stereo_sbs(cfg.num_rows, cfg.num_cols)
    chk = KernelChecks(reps=10)
    try:
        out = pipeline.process_frame(sbs, cfg)
        img_l, img_r = (t.contiguous() for t in pipeline.demux_sbs(
            torch.from_numpy(sbs).to(out[2].device)))
        bl, br = out[0], out[1]
        masks = check_synth_kernels(chk, img_l, img_r, bl, br, cfg)
        check_synth_edges(chk, img_l, img_r, bl, br, masks, cfg)
        check_occl_edges(chk, bl, br, cfg)
        check_many_views(chk, img_l, img_r, bl, br, cfg)
        check_view_stack_edges(chk, img_l, img_r, bl, br, masks, cfg)
        run_synthesis_entries(img_l, img_r, bl, br, cfg)
        del masks
        torch.cuda.empty_cache()
        check_warp_rowmajor(chk, img_l, img_r, bl, br, cfg)
        check_warp_rowmajor_edges(chk, img_l, img_r, bl, br, cfg)
        del out, img_l, img_r, bl, br
        torch.cuda.empty_cache()
        cfg4k = config.UHD4K_16V
        sbs4k = stereo_sbs(cfg4k.num_rows, cfg4k.num_cols)
        for name, entry, pcfg, frame in (
                (MAIN, pipeline.process_frame, cfg, sbs),
                (HSLO4K, pipeline.process_frame, config.HD1080_D128_HSLO_4K,
                 sbs),
                (LOWRES, pipeline.process_frame_lowres, config.HD1080_LOWRES,
                 sbs),
                (UHD4K, pipeline.process_frame, cfg4k, sbs4k)):
            out, _ = run_path(name, entry, frame, pcfg, 1,
                              exact=has_fused_occl())
            check_interlaced(name, frame, pcfg, out)
            if name == UHD4K:
                img_l, img_r = (t.contiguous() for t in pipeline.demux_sbs(
                    torch.from_numpy(frame).to(out[2].device)))
                chk.suffix = AT_4K
                check_synth_kernels(chk, img_l, img_r, out[0], out[1], pcfg,
                                    b14=False)
                chk.suffix = ""
                check_warp_rowmajor_4k(chk, img_l, img_r, out[0], out[1],
                                       pcfg)
                ms = time_ms(lambda: pipeline.synthesize_views(
                    img_l, img_r, out[0], out[1], pcfg), 10)
                print(f"synthesis: {ms:.3f} ms view stack "
                      f"(synthesize_views) at {UHD4K}, package under "
                      f"{root}, on {gpu_line()}", flush=True)
            del out
            torch.cuda.empty_cache()
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


def band_checks(root: str) -> int:
    """`--band-checks [--package-root DIR]`: only B15 and B18a-c (and
    what feeds them), on the package under DIR: B15 on the 1080p frame's
    stacked one-hot and float volumes and at its edges, `dr_irv_band_lr`
    as a path; B16 and B18a-c on the 1080p frame, a 680-row chunk, a
    200x1001 crop and a 680x3840 chunk of the 4K frame, B18a-c at their
    edges, `band_stereo_core_dm` whole-frame, in 540-row chunks and at
    4K as paths.  The way to time two commits' kernels in turns.  Exit 1
    if one fails."""
    import torch
    sys.path.insert(0, root)
    from stereo_to_multiview_tpu_torch import config, kernels
    from stereo_to_multiview_tpu_torch.models import pipeline
    from stereo_to_multiview_tpu_torch.ops import band, cross, dcc

    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print_ptxas(kernels.build_kernels())
    cfg = config.HD1080_D128
    usd = cfg.usd
    arm_args = (cfg.ucd, cfg.lcd, usd, cfg.lsd)
    dev = torch.device("cuda")
    sbs = torch.from_numpy(stereo_sbs(cfg.num_rows, cfg.num_cols))
    img_l, img_r = (t.contiguous() for t in pipeline.demux_sbs(sbs.to(dev)))
    chk = KernelChecks(reps=10)
    try:
        arms_l, arms_r = (cross.cross_arms(t, *arm_args)
                          for t in (img_l, img_r))
        dl, dr = band.band_stereo_core_chunked(img_l, img_r, arms_l, arms_r,
                                               cfg)
        labels = dcc.dr_dcc(dl, dr, cfg.dcc_thresh)
        paths = check_irv_band(chk, dl, dr, labels, arms_l, arms_r, cfg)
        del dl, dr, labels
        torch.cuda.empty_cache()

        check_dm_kernels(chk, img_l, img_r, arms_l, arms_r, cfg, full=False)
        chk.suffix = AT_CHUNK
        ext = band.chunk_bounds(cfg.num_rows, 540, 2 * usd)[0]
        check_dm_kernels(chk, img_l, img_r, arms_l[:, :ext],
                         arms_r[:, :ext], cfg, full=False, rows=(0, ext))
        chk.suffix = AT_ODD
        odd_l, odd_r = (t[:200, :1001].contiguous() for t in (img_l, img_r))
        check_dm_kernels(chk, odd_l, odd_r, cross.cross_arms(odd_l, *arm_args),
                         cross.cross_arms(odd_r, *arm_args), cfg, full=False)
        chk.suffix = ""
        del odd_l, odd_r
        torch.cuda.empty_cache()
        # B16's one-eye modes and its edges
        check_shift_extract(chk, img_l, img_r, cfg)
        check_shear_dm_edges(chk, img_l, img_r, cfg)
        paths.update(run_shift_extract(img_l, img_r, cfg))
        torch.cuda.empty_cache()
        check_dm_edges(chk, img_l, img_r, cfg)
        check_vdm_edges(chk, cfg.num_disp, dev)
        check_hdm_edges(chk, cfg.num_disp, dev)
        torch.cuda.empty_cache()
        cfg2 = cfg.replace(band_digits=2)
        paths[DM] = run_dm_core(DM, img_l, img_r, arms_l, arms_r, cfg2)
        paths[DM_CHUNKED] = run_dm_core(DM_CHUNKED, img_l, img_r, arms_l,
                                        arms_r,
                                        cfg2.replace(band_row_chunk=540))
        hd = (img_l, img_r, arms_l, arms_r)
        del img_l, img_r, arms_l, arms_r
        torch.cuda.empty_cache()

        cfg4k = config.UHD4K_16V
        sbs4k = torch.from_numpy(stereo_sbs(cfg4k.num_rows, cfg4k.num_cols))
        img_l, img_r = (t.contiguous()
                        for t in pipeline.demux_sbs(sbs4k.to(dev)))
        del sbs4k
        arm_args = (cfg4k.ucd, cfg4k.lcd, cfg4k.usd, cfg4k.lsd)
        arms_l, arms_r = (cross.cross_arms(t, *arm_args)
                          for t in (img_l, img_r))
        core_rows = band.chunk_bounds(cfg4k.num_rows, cfg4k.band_row_chunk,
                                      2 * cfg4k.usd)[0]
        chk.suffix = AT_4K
        check_dm_kernels(chk, img_l, img_r,
                         arms_l[:, :core_rows].contiguous(),
                         arms_r[:, :core_rows].contiguous(), cfg4k,
                         full=False, rows=(0, core_rows))
        chk.suffix = ""
        check_dm_chunk4k(chk, img_l, img_r, cfg4k)
        torch.cuda.empty_cache()
        paths[DM_4K] = run_dm_core(DM_4K, img_l, img_r, arms_l, arms_r,
                                   cfg4k.replace(band_digits=2))
        torch.cuda.empty_cache()
        # the cost entry and the disparity-major core split into their
        # parts by CUDA events
        run_cost_splits(*hd, cfg, cfg4k, (img_l, img_r, arms_l, arms_r))
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for name, p in paths.items():
        if "band_ms" in p:
            print(f"IRV: {p['band_ms']:.3f} ms dr_irv_band_lr at {name}, "
                  f"package under {root}, on {card}", flush=True)
        elif "dm_ms" in p:
            print(f"stereo core: {p['dm_ms']:.3f} ms disparity-major at "
                  f"{name}, package under {root}, on {card}", flush=True)
        elif "span_ms" in p:
            print(f"span sums: {p['span_ms']:.3f} ms band_span_sum_h + _v "
                  f"at {name}, package under {root}, on {card}", flush=True)
    return 0


def only_runtime_checks() -> int:
    """`--runtime-checks`: phase 5 alone (the kernels built first)."""
    sys.path.insert(0, HERE)
    from stereo_to_multiview_tpu_torch import kernels
    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print_ptxas(kernels.build_kernels())
    try:
        runtime_checks(card)
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


def only_shard_checks() -> int:
    """`--shard-checks`: phase 6 alone (the kernels built first)."""
    sys.path.insert(0, HERE)
    from stereo_to_multiview_tpu_torch import kernels
    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print_ptxas(kernels.build_kernels())
    try:
        shard_checks(KernelChecks(reps=10), card)
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=0,
                    help="time only the preset and dial paths, this many "
                         "frames each, and print no result line")
    ap.add_argument("--stream-checks", action="store_true",
                    help="only hold B1-B6, B8-B10 and B13 (and "
                         "the dials' modes) against their plain "
                         "versions and print no result line")
    ap.add_argument("--synth-checks", action="store_true",
                    help="only hold the synthesis kernels (B7's hits, "
                         "B11, the fused occlusion stage, G1, B12, B19, "
                         "B20) and "
                         "the presets' interlaced frames against their "
                         "plain versions and print no result line")
    ap.add_argument("--band-checks", action="store_true",
                    help="only hold B15 and B18a-c (the disparity-major "
                         "core's kernels, B18a-c at their edges too) "
                         "against their plain versions, drive "
                         "dr_irv_band_lr and band_stereo_core_dm, and "
                         "print no result line")
    ap.add_argument("--vpass-checks", action="store_true",
                    help="only hold B5 against its plain version at the "
                         "presets' shapes and its edges, timed, and print "
                         "no result line")
    ap.add_argument("--irv-checks", action="store_true",
                    help="only hold B9 and G3 against their plain "
                         "versions at the presets' shapes and their "
                         "edges, timed, and print no result line")
    ap.add_argument("--runtime-checks", action="store_true",
                    help="only run the stream driver, the XLA engine and "
                         "the apps (phase 5) and print no result line")
    ap.add_argument("--shard-checks", action="store_true",
                    help="only run phase 6 (B1's halo-shard mode and the "
                         "sharded paths in ranks on the card) and print "
                         "no result line")
    ap.add_argument("--package-root", default=HERE,
                    help="with --frames, --stream-checks, "
                         "--synth-checks, --band-checks, "
                         "--vpass-checks or --irv-checks: the checkout "
                         "whose package runs (default: this one)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.frames > 0:
        return time_frames(os.path.abspath(args.package_root), args.frames)
    if args.stream_checks:
        return stream_checks(os.path.abspath(args.package_root))
    if args.synth_checks:
        return synth_checks(os.path.abspath(args.package_root))
    if args.band_checks:
        return band_checks(os.path.abspath(args.package_root))
    if args.vpass_checks:
        return vpass_checks(os.path.abspath(args.package_root))
    if args.irv_checks:
        return irv_checks(os.path.abspath(args.package_root))
    if args.runtime_checks:
        return only_runtime_checks()
    if args.shard_checks:
        return only_shard_checks()
    sys.path.insert(0, HERE)
    try:
        from stereo_to_multiview_tpu_torch import config, kernels
        from stereo_to_multiview_tpu_torch.models import pipeline
        from stereo_to_multiview_tpu_torch.ops import band, cross
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False   # no matmul is expected;
    torch.backends.cudnn.allow_tf32 = False         # full f32 if any runs
    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    report = {"gpu": card}
    try:
        t0 = time.perf_counter()
        logs = kernels.build_kernels()
        report["build_s"] = time.perf_counter() - t0
        print(f"build: {len(logs)} kernel libraries in "
              f"{report['build_s']:.1f} s", flush=True)
        print_ptxas(logs)

        cfg = config.HD1080_D128
        sbs = stereo_sbs(cfg.num_rows, cfg.num_cols)
        dev = torch.device("cuda")
        img_l, img_r = (t.contiguous() for t in
                        pipeline.demux_sbs(torch.from_numpy(sbs).to(dev)))
        chk = KernelChecks(reps=10)
        paths = {}
        arms_l, arms_r = check_core_kernels(chk, img_l, img_r, cfg)
        torch.cuda.empty_cache()
        check_hslo_edges(chk, img_l, img_r, cfg)
        check_shear_edges(chk, img_l, img_r, cfg)
        check_arms_edges(chk, img_l, img_r, cfg)
        check_cost_d130(chk, img_l, img_r, cfg)
        bl, br = check_disp_kernels(chk, img_l, img_r, arms_l, arms_r, cfg)
        check_vstream_edges(chk, chk.raw[0], chk.raw[2][0], arms_l, cfg)
        check_vote_edges(chk, chk.raw[0], chk.raw[2][0], arms_l, cfg)
        check_vpass_edges(chk, arms_l, cfg)
        check_rowspan_edges(chk, chk.raw[0], chk.raw[2][0], arms_l, cfg)
        check_frontier_edges(chk, dev)
        check_hstream_edges(chk, img_l, img_r, cfg)
        torch.cuda.empty_cache()
        masks = check_synth_kernels(chk, img_l, img_r, bl, br, cfg)
        check_synth_edges(chk, img_l, img_r, bl, br, masks, cfg)
        torch.cuda.empty_cache()
        check_occl_edges(chk, bl, br, cfg)
        torch.cuda.empty_cache()
        check_many_views(chk, img_l, img_r, bl, br, cfg)
        check_view_stack_edges(chk, img_l, img_r, bl, br, masks, cfg)
        del masks
        paths.update(run_synthesis_entries(img_l, img_r, bl, br, cfg))
        torch.cuda.empty_cache()
        # the entry points beside process_frame, on this frame's stages:
        # B15 and dr_irv_band_lr on its raw disparities and labels, the
        # row-major warps (B19, B20) and the forward warp on its final
        # disparities, B16's one-eye modes and B17 on its pair
        raw, chk.raw = chk.raw, None
        paths.update(check_irv_band(chk, *raw, arms_l, arms_r, cfg))
        del raw
        torch.cuda.empty_cache()
        paths[WARP_RM] = check_warp_rowmajor(chk, img_l, img_r, bl, br, cfg)
        check_warp_rowmajor_edges(chk, img_l, img_r, bl, br, cfg)
        torch.cuda.empty_cache()
        report["forward_warp"] = check_forward_warp(img_l, img_r, bl, br, cfg)
        del bl, br
        torch.cuda.empty_cache()
        check_shift_extract(chk, img_l, img_r, cfg)
        check_shear_dm_edges(chk, img_l, img_r, cfg)
        paths.update(run_shift_extract(img_l, img_r, cfg))
        torch.cuda.empty_cache()
        check_band_digits(chk, img_l, img_r, arms_l, cfg)
        torch.cuda.empty_cache()
        # the band engine's dials: their kernel modes on this frame and at
        # the edges, then the cost entry in each mode as paths
        check_band_dials(chk, img_l, img_r, arms_l, cfg)
        torch.cuda.empty_cache()
        check_dial_edges(chk, img_l, img_r, cfg)
        paths.update(run_xm_entry(img_l, img_r, cfg))
        torch.cuda.empty_cache()

        # the disparity-major core: its kernels at 1080p and at the extent
        # of a 540-row chunk, then the core as a path, whole-frame and
        # chunked, against the lane-major core at band_digits=2
        check_dm_kernels(chk, img_l, img_r, arms_l, arms_r, cfg)
        torch.cuda.empty_cache()
        chk.suffix = AT_CHUNK
        ext = band.chunk_bounds(cfg.num_rows, 540, 2 * cfg.usd)[0]
        check_dm_kernels(chk, img_l, img_r, arms_l[:, :ext],
                         arms_r[:, :ext], cfg, full=False, rows=(0, ext))
        chk.suffix = AT_ODD
        odd_l, odd_r = (t[:200, :1001].contiguous() for t in (img_l, img_r))
        arm_args = (cfg.ucd, cfg.lcd, cfg.usd, cfg.lsd)
        check_dm_kernels(chk, odd_l, odd_r,
                         cross.cross_arms(odd_l, *arm_args),
                         cross.cross_arms(odd_r, *arm_args), cfg, full=False)
        check_shift_extract(chk, odd_l, odd_r, cfg)
        chk.suffix = ""
        del odd_l, odd_r
        check_dm_edges(chk, img_l, img_r, cfg)
        check_vdm_edges(chk, cfg.num_disp, dev)
        check_hdm_edges(chk, cfg.num_disp, dev)
        torch.cuda.empty_cache()
        cfg2 = cfg.replace(band_digits=2)
        paths[DM] = run_dm_core(DM, img_l, img_r, arms_l, arms_r, cfg2)
        paths[DM_CHUNKED] = run_dm_core(DM_CHUNKED, img_l, img_r, arms_l,
                                        arms_r,
                                        cfg2.replace(band_row_chunk=540))
        del arms_l, arms_r
        torch.cuda.empty_cache()

        # the same kernels on what the third path gives them, staged as
        # process_frame_lowres stages it: the pair scaled to 540x960 and
        # D=64 up to the bilateral filter, then the disparities scaled
        # back to 1080p (and doubled) for the synthesis
        # (the rescales by G2, held against their plain versions there
        # and at their edges)
        lcfg = config.HD1080_LOWRES
        low_l, low_r = record_tx_scale(chk, G2D, img_l, img_r,
                                       lcfg.num_rows_disp, lcfg.num_cols_disp)
        chk.suffix = AT_LOWRES
        arms_l, arms_r = check_core_kernels(chk, low_l, low_r, lcfg,
                                            hslo=False)
        dl, dr = check_disp_kernels(chk, low_l, low_r, arms_l, arms_r, lcfg)
        chk.suffix = ""
        bl, br = record_disp_scale(chk, G2U, dl, dr, lcfg.num_rows,
                                   lcfg.num_cols, 1.0 / lcfg.disp_scale)
        check_scale_edges(chk, img_l, img_r, dl, dr, bl, br,
                          1.0 / lcfg.disp_scale)
        del dl, dr
        chk.suffix = AT_LOWRES
        check_synth_kernels(chk, img_l, img_r, bl, br, lcfg, b14=False)
        chk.suffix = ""
        kres = chk.results
        report["irv_early_stop"] = chk.irv
        report["irv_need_shares"] = chk.irv_shares
        report["irv_rounds"] = chk.irv_rounds
        del img_l, img_r, low_l, low_r, arms_l, arms_r, bl, br
        torch.cuda.empty_cache()

        for name, entry, pcfg in (
                (MAIN, pipeline.process_frame, cfg),
                (HSLO4K, pipeline.process_frame, config.HD1080_D128_HSLO_4K),
                (LOWRES, pipeline.process_frame_lowres,
                 config.HD1080_LOWRES),
                (DIGITS2, pipeline.process_frame, cfg2),
                (DIGITS1, pipeline.process_frame,
                 cfg.replace(band_digits=1)),
                (QSCALE510, pipeline.process_frame,
                 cfg.replace(band_qscale=510.0)),
                (LOSSY, pipeline.process_frame,
                 cfg.replace(band_lossy_wta=True))):
            out, paths[name] = run_path(name, entry, sbs, pcfg, 10)
            check_outputs(name, out, pcfg, pipeline.synth_disp_bounds(pcfg))
            check_interlaced(name, sbs, pcfg, out)
            del out
            torch.cuda.empty_cache()

        # the 4K preset: a frame through process_frame, then the kernels
        # at its chunk shapes (680 rows of the stereo core, 1152 of the
        # IRV, 14 intermediate views at 2160x3840) on that frame
        cfg4k = config.UHD4K_16V
        sbs4k = stereo_sbs(cfg4k.num_rows, cfg4k.num_cols)
        out, paths[UHD4K] = run_path(UHD4K, pipeline.process_frame, sbs4k,
                                     cfg4k, 2)
        check_outputs(UHD4K, out, cfg4k, pipeline.synth_disp_bounds(cfg4k))
        check_interlaced(UHD4K, sbs4k, cfg4k, out)
        torch.cuda.empty_cache()
        img_l, img_r = (t.contiguous() for t in
                        pipeline.demux_sbs(torch.from_numpy(sbs4k).to(dev)))
        check_cost_chunk(chk, img_l, img_r, cfg4k)
        check_dm_chunk4k(chk, img_l, img_r, cfg4k)
        chk.suffix = AT_4K
        core_rows = band.chunk_bounds(cfg4k.num_rows, cfg4k.band_row_chunk,
                                      2 * cfg4k.usd)[0]
        irv_rows = band.chunk_bounds(cfg4k.num_rows, cfg4k.irv_row_chunk,
                                     cfg4k.usd)[0]
        check_core_kernels(chk, img_l[:core_rows], img_r[:core_rows], cfg4k,
                           hslo=False)
        torch.cuda.empty_cache()
        arm_args = (cfg4k.ucd, cfg4k.lcd, cfg4k.usd, cfg4k.lsd)
        check_disp_kernels(
            chk, img_l[:irv_rows], img_r[:irv_rows],
            cross.cross_arms(img_l[:irv_rows], *arm_args),
            cross.cross_arms(img_r[:irv_rows], *arm_args), cfg4k)
        torch.cuda.empty_cache()
        check_synth_kernels(chk, img_l, img_r, out[0], out[1], cfg4k,
                            b14=False)
        chk.suffix = ""
        check_warp_rowmajor_4k(chk, img_l, img_r, out[0], out[1], cfg4k)
        del out
        torch.cuda.empty_cache()
        # the disparity-major core at 3840 columns: its kernels on one of
        # the preset's 680-row chunks, then the core as a path
        arms_l, arms_r = (cross.cross_arms(t, *arm_args)
                          for t in (img_l, img_r))
        record_frontier_4k(chk, img_l, img_r, arms_l, arms_r, cfg4k)
        torch.cuda.empty_cache()
        chk.suffix = AT_4K
        check_dm_kernels(chk, img_l, img_r,
                         arms_l[:, :core_rows].contiguous(),
                         arms_r[:, :core_rows].contiguous(), cfg4k,
                         full=False, rows=(0, core_rows))
        chk.suffix = ""
        torch.cuda.empty_cache()
        paths[DM_4K] = run_dm_core(DM_4K, img_l, img_r, arms_l, arms_r,
                                   cfg4k.replace(band_digits=2))
        del img_l, img_r, arms_l, arms_r
        torch.cuda.empty_cache()

        report["small_frames"] = {label: check_small_frame(label, scfg)
                                  for label, scfg in small_configs().items()}
        check_small_dm_core()
        report["runtime"] = runtime_checks(card)
        paths[XLA] = report["runtime"]["xla"]
        torch.cuda.empty_cache()
        paths.update(shard_checks(chk, card))
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    unlisted = sorted(set(kres) ^ set(KERNELS))
    if unlisted:
        print(f"chip_smoke: FAILED: kernel entries recorded but not listed, "
              f"or listed but not recorded: {unlisted}", file=sys.stderr)
        return 1
    rows = []
    for name, (wrapper, source, replaces, path) in KERNELS.items():
        r = kres[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, path=path,
                         launches=paths[path]["launches"][wrapper],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         library_ms=r["library_ms"]))
    report.update(kernels=rows, paths=paths)
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    with open(os.path.join(HERE, "out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    for name, p in paths.items():
        if "frame_ms" in p:
            print(f"frame: {p['frame_ms']:.2f} ms per frame at {name} on "
                  f"{card}")
        elif "dm_ms" in p:
            print(f"stereo core: {p['dm_ms']:.3f} ms disparity-major, "
                  f"{p['lane_major_ms']:.3f} ms lane-major at {name} on "
                  f"{card}")
        elif "band_ms" in p:
            print(f"IRV: {p['band_ms']:.3f} ms dr_irv_band_lr, "
                  f"{p['dr_irv_ms']:.3f} ms dr_irv, {p['rounds']} fixed "
                  f"rounds both eyes, at {name} on {card}")
        elif "span_ms" in p:
            print(f"span sums: {p['span_ms']:.3f} ms band_span_sum_h + _v "
                  f"at {name} on {card}")
        elif "shift_extract_ms" in p:
            print(f"cost: {p['shift_extract_ms']:.3f} ms shift_extract, "
                  f"{p['direct_ms']:.3f} ms direct at {name} on {card}")
        elif "xm_ms" in p:
            print(f"cost: {p['xm_ms']:.3f} ms at {name} on {card}")
        elif "synth_views_ms" in p:
            print(f"synthesis: {p['synth_views_ms']:.3f} ms view stack, "
                  f"{p['synth_interlace_ms']:.3f} ms interlaced frame at "
                  f"{name} on {card}")
        elif "unfused_ms" in p:
            print(f"occlusion stage: {p['unfused_ms']:.4f} ms B7's hits "
                  f"and B11 twice, {p['fused_ms']:.4f} ms fused at {name} "
                  f"on {card}")
        elif "shard_ms" in p:
            print(f"sharded: {p['shard_ms']:.2f} ms a frame, "
                  f"{p['exchange_ms']:.2f} ms in exchanges at {name} "
                  f"({p['ranks']} ranks time-sharing one card, not a "
                  f"scaling result) on {card}")
        elif "warp_views_ms" in p:
            print(f"warps: {p['warp_views_ms']:.4f} ms B14's volumes at "
                  f"{name} on {card}")
        else:
            print(f"warps: {p['views_ms']:.4f} ms all views, "
                  f"{p['pairs_ms']:.4f} ms per-view pairs at {name} on "
                  f"{card}")
    print(f"gpu: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
