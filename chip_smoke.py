#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from stereo_to_multiview_tpu_torch/csrc (nvcc,
   sm_90a, one process per source, in parallel).
2. Holds every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (1080p, D=128, usd=34): bit equality
   required.  Times kernel, plain version, and one PyTorch library call
   where one computes the same function.
3. Drives the main path, `process_frame` at HD1080_D128 on a 1080p SBS
   frame built from tests/data/fish_{1,2}.bmp: launch counts are zeroed
   just before one frame and read just after (every kernel must have
   launched); then a few frames are timed with per-stage CUDA events.
4. Checks the output: shapes, dtypes, finite disparities in range, and a
   small frame run on the card against the same frame run on the CPU.

Prints the card's name and power limit, per-stage and per-kernel times,
a `{"kernels": [...]}` line, and last `{"ok": true, "device": {...}}`.
Exits non-zero, printing no result, without a CUDA device or when any
phase fails.  Detailed results also go to out/chip_smoke.json.
"""

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

# kernel name -> (wrapper, source, replaced TPU kernel)
_SRC = "stereo_to_multiview_tpu_torch/csrc/"
_TPU = "stereo_to_multiview_tpu/ops/"
KERNELS = {
    "B1 cross_arms": ("cross_arms", _SRC + "arms.cu", _TPU + "postkern.py:80"),
    "B2 cost_pair": ("cost_pair", _SRC + "cost.cu", _TPU + "costkern.py:279"),
    "B3 shear_right": ("shear_right", _SRC + "shear.cu",
                       _TPU + "costkern.py:342"),
    "B4 h_pass_sum (pass 1)": ("h_pass_sum", _SRC + "hpass.cu",
                               _TPU + "band.py:150"),
    "B5 vv_pass (passes 2+3)": ("vv_pass", _SRC + "vpass.cu",
                                _TPU + "band.py:330"),
    "B6 h_pass_wta (pass 4 + WTA)": ("h_pass_wta", _SRC + "hpass.cu",
                                     _TPU + "band.py:150"),
    "B7 dr_dcc (labels)": ("dr_dcc", _SRC + "dcc.cu",
                           _TPU + "postkern.py:255"),
    "B7 dibr_occl (hits)": ("dibr_occl", _SRC + "dcc.cu",
                            _TPU + "postkern.py:255"),
    "B8 irv_rowspan": ("irv_rowspan", _SRC + "irv.cu", _TPU + "irvkern.py:60"),
    "B9 irv_vote": ("irv_vote", _SRC + "irv.cu", _TPU + "irvkern.py:121"),
    "B10 filter_bilateral": ("filter_bilateral", _SRC + "bilateral.cu",
                             _TPU + "postkern.py:48"),
    "B11 dibr_bleed_mask": ("dibr_bleed_mask", _SRC + "bleed.cu",
                            _TPU + "postkern.py:442"),
    "B12 warp_merge_views": ("warp_merge_views", _SRC + "warp.cu",
                             _TPU + "warpkern.py:340"),
}


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


def fish_sbs(rows: int, cols: int):
    """SBS frame from the bundled fish pair, upscaled 3x (bilinear) and
    tiled/cropped to (rows, 2*cols, 3)."""
    import numpy as np
    from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

    def fit(name):
        img = up3(read_bmp(os.path.join(HERE, "tests", "data", name)))
        reps = (-(-rows // img.shape[0]), -(-cols // img.shape[1]), 1)
        return np.tile(img, reps)[:rows, :cols]

    return np.concatenate([fit("fish_1.bmp"), fit("fish_2.bmp")], axis=1)


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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelChecks:
    """Phase 2: each kernel against its plain version on the same inputs,
    bit equality required; times kernel, plain version and, where one
    exists, one PyTorch library call computing the same function."""

    def __init__(self, reps: int):
        self.reps = reps
        self.results = {}

    def record(self, name, got, ref, kern, plain, nbytes, ops, library=None):
        import torch
        torch.cuda.synchronize()
        pairs = (list(zip(got, ref)) if isinstance(got, tuple)
                 else [(got, ref)])
        err = 0.0
        for i, (g, r) in enumerate(pairs):
            if g.shape != r.shape or g.dtype != r.dtype:
                raise SmokeFailure(f"{name}: kernel output {i} is "
                                   f"{tuple(g.shape)} {g.dtype}, plain "
                                   f"{tuple(r.shape)} {r.dtype}")
            e = float((g.to(torch.float64) - r.to(torch.float64))
                      .abs().max())
            if e != 0.0:
                bad = int((g != r).sum())
                first = [int(j) for j in (g != r).nonzero()[0]]
                raise SmokeFailure(f"{name}: kernel output {i} != plain "
                                   f"version (max_abs_err {e}, {bad} "
                                   f"elements, first at {first})")
            err = max(err, e)
        b_ms, b_by = bound(nbytes, ops)
        reps = self.reps
        r = self.results[name] = dict(
            max_abs_err=err, ms=time_ms(kern, reps),
            plain_ms=time_ms(plain, max(1, reps // 4)), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None if library is None else time_ms(library, reps))
        print(f"kernel {name}: equal to plain; {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.3f} ms, bound {b_ms:.4f} ms by "
              f"{b_by}, library {r['library_ms']})", flush=True)


def check_core_kernels(chk, img_l, img_r, cfg):
    """B1-B6 on the left eye of the main path's whole-frame stereo core;
    returns both eyes' arms."""
    import torch
    from stereo_to_multiview_tpu_torch.ops import band, costkern, cross
    from stereo_to_multiview_tpu_torch.ops.cost import census_transform_9x7
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT
    from stereo_to_multiview_tpu_torch.ops.mux import mux_average

    h, w = img_l.shape[:2]
    nd, zd, usd = cfg.num_disp, cfg.zero_disp, cfg.usd
    arm_args = (cfg.ucd, cfg.lcd, usd, cfg.lsd)
    arms = cross.cross_arms(img_l, *arm_args)
    hw, hwd = h * w, h * w * nd
    # each walked step: two 3-channel max-abs-diffs and the tests (~14
    # integer operations); the walk ends at the arm's end or one past it
    chk.record("B1 cross_arms", arms, cross.cross_arms_plain(img_l, *arm_args),
               lambda: cross.cross_arms(img_l, *arm_args),
               lambda: cross.cross_arms_plain(img_l, *arm_args),
               nbytes=hw * 3 + 4 * hw * 4,
               ops=14 * (float(arms.sum()) + 4 * hw))

    m = costkern.pair_margin(nd, zd)
    s1, s2, s3 = band.agg_rescale_shifts(usd, cfg.band_digits)
    cen_l = census_transform_9x7(mux_average(img_l))
    cen_r = census_transform_9x7(mux_average(img_r))
    table = costkern.cost_table(cfg.ad_coeff, cfg.census_coeff).to(
        img_l.device)
    args = (img_l, img_r, cen_l, cen_r, table, nd, zd)
    pair = costkern.cost_pair(*args)
    chk.record("B2 cost_pair", pair, costkern.cost_pair_plain(*args),
               lambda: costkern.cost_pair(*args),
               lambda: costkern.cost_pair_plain(*args),
               nbytes=2 * hw * 3 + 2 * hw * 8 + table.numel() + pair.numel(),
               ops=10 * pair.numel())

    cost_r = costkern.shear_right(pair, zd)
    x = torch.arange(w, device=pair.device)[:, None]
    d = torch.arange(nd, device=pair.device)[None, :]
    idx = (x + m - (d - zd)).expand(h, w, nd)
    chk.record("B3 shear_right", cost_r, costkern.shear_right_plain(pair, zd),
               lambda: costkern.shear_right(pair, zd),
               lambda: costkern.shear_right_plain(pair, zd),
               nbytes=pair.numel() + hwd, ops=0,
               library=lambda: torch.gather(pair, 1, idx))
    del cost_r, idx

    cost_l = pair[:, m:m + w]
    lr = (arms[LEFT], arms[RIGHT])
    a1 = band.h_pass_sum(cost_l, *lr, s1, usd)
    chk.record("B4 h_pass_sum (pass 1)", a1,
               band.h_pass_sum_plain(cost_l, *lr, s1, usd),
               lambda: band.h_pass_sum(cost_l, *lr, s1, usd),
               lambda: band.h_pass_sum_plain(cost_l, *lr, s1, usd),
               nbytes=hwd + 2 * hw * 4 + hwd * 4, ops=3 * hwd)
    del pair

    ud = (arms[UP], arms[DOWN])
    a2 = band.vv_pass(a1, *ud, s2, s3, usd)
    chk.record("B5 vv_pass (passes 2+3)", a2,
               band.vv_pass_plain(a1, *ud, s2, s3, usd),
               lambda: band.vv_pass(a1, *ud, s2, s3, usd),
               lambda: band.vv_pass_plain(a1, *ud, s2, s3, usd),
               nbytes=hwd * 4 + 2 * hw * 4 + hwd * 4, ops=2 * 4 * hwd)
    del a1

    disp = band.h_pass_wta(a2, *lr, zd, usd)
    chk.record("B6 h_pass_wta (pass 4 + WTA)", disp,
               band.h_pass_wta_plain(a2, *lr, zd, usd),
               lambda: band.h_pass_wta(a2, *lr, zd, usd),
               lambda: band.h_pass_wta_plain(a2, *lr, zd, usd),
               nbytes=hwd * 4 + 2 * hw * 4 + hw * 4, ops=3 * hwd)
    return arms, cross.cross_arms(img_r, *arm_args)


def check_post_kernels(chk, img_l, img_r, arms_l, arms_r, cfg):
    """B7-B12 on the inputs the main path gives them: the stage outputs of
    one frame computed with the kernels."""
    from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
    from stereo_to_multiview_tpu_torch.ops import dcc, dibr, filters, irv
    from stereo_to_multiview_tpu_torch.ops.band import (
        band_stereo_core_chunked)
    from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

    h, w = img_l.shape[:2]
    hw, nd, zd, usd = h * w, cfg.num_disp, cfg.zero_disp, cfg.usd
    dl, dr = band_stereo_core_chunked(img_l, img_r, arms_l, arms_r, cfg)

    labels = dcc.dr_dcc(dl, dr, cfg.dcc_thresh)
    chk.record("B7 dr_dcc (labels)", labels,
               dcc.dr_dcc_plain(dl, dr, cfg.dcc_thresh),
               lambda: dcc.dr_dcc(dl, dr, cfg.dcc_thresh),
               lambda: dcc.dr_dcc_plain(dl, dr, cfg.dcc_thresh),
               nbytes=2 * hw * 4 + 2 * hw, ops=2 * hw * 10)

    ol = labels[0]
    lr, ud = (arms_l[LEFT], arms_l[RIGHT]), (arms_l[UP], arms_l[DOWN])
    cnt = irv.irv_rowspan(dl, ol, *lr, nd, zd, usd)
    chk.record("B8 irv_rowspan", cnt,
               irv.irv_rowspan_plain(dl, ol, *lr, nd, zd, usd),
               lambda: irv.irv_rowspan(dl, ol, *lr, nd, zd, usd),
               lambda: irv.irv_rowspan_plain(dl, ol, *lr, nd, zd, usd),
               nbytes=hw * (4 + 1 + 8) + cnt.numel(), ops=4 * cnt.numel())

    vote = (cfg.irv_thresh_s, cfg.irv_thresh_h, zd, usd)
    chk.record("B9 irv_vote", irv.irv_vote(cnt, dl, ol, *ud, *vote),
               irv.irv_vote_plain(cnt, dl, ol, *ud, *vote),
               lambda: irv.irv_vote(cnt, dl, ol, *ud, *vote),
               lambda: irv.irv_vote_plain(cnt, dl, ol, *ud, *vote),
               nbytes=cnt.numel() + hw * (4 + 1 + 8) + hw * (4 + 1),
               ops=4 * cnt.numel())
    del cnt

    irv_args = (cfg.irv_thresh_s, cfg.irv_thresh_h, nd, zd, usd,
                cfg.irv_iterations)
    dl, _ = irv.dr_irv(dl, ol, arms_l, *irv_args)
    dr, _ = irv.dr_irv(dr, labels[1], arms_r, *irv_args)
    r = cfg.bilateral_radius
    blf = (r, cfg.bilateral_sigma_color, cfg.bilateral_sigma_spatial)
    bl = filters.filter_bilateral(dl, *blf)
    chk.record("B10 filter_bilateral", bl,
               filters.filter_bilateral_plain(dl, *blf),
               lambda: filters.filter_bilateral(dl, *blf),
               lambda: filters.filter_bilateral_plain(dl, *blf),
               nbytes=2 * hw * 4, ops=20 * (2 * r + 1) ** 2 * hw)
    br = filters.filter_bilateral(dr, *blf)

    occl = dibr.dibr_occl(bl, br)
    chk.record("B7 dibr_occl (hits)", occl, dibr.dibr_occl_plain(bl, br),
               lambda: dibr.dibr_occl(bl, br),
               lambda: dibr.dibr_occl_plain(bl, br),
               nbytes=2 * hw * 4 + 2 * hw, ops=2 * hw * 4)

    rb = cfg.bleed_radius
    mask_l = dibr.dibr_bleed_mask(occl[0], rb)
    chk.record("B11 dibr_bleed_mask", mask_l,
               dibr.dibr_bleed_mask_plain(occl[0], rb),
               lambda: dibr.dibr_bleed_mask(occl[0], rb),
               lambda: dibr.dibr_bleed_mask_plain(occl[0], rb),
               nbytes=hw + hw * 4, ops=2 * (2 * rb + 1) ** 2 * hw)
    mask_r = dibr.dibr_bleed_mask(occl[1], rb)

    feathered = dibr.dibr_feather_mask(mask_r, cfg.feather_radius,
                                       cfg.feather_sigma)
    wargs = (img_l, img_r, bl, br, mask_l, mask_r, feathered,
             _synth_shifts(cfg.num_views))
    views = dibr.warp_merge_views(*wargs)
    chk.record("B12 warp_merge_views", views,
               dibr.warp_merge_views_plain(*wargs),
               lambda: dibr.warp_merge_views(*wargs),
               lambda: dibr.warp_merge_views_plain(*wargs),
               nbytes=2 * hw * 3 + 5 * hw * 4 + views.numel(),
               ops=views.numel() * 20)


def run_main_path(sbs, cfg, n_frames: int):
    """Phase 3: one counted frame, then n_frames timed frames."""
    import torch
    from stereo_to_multiview_tpu_torch import kernels
    from stereo_to_multiview_tpu_torch.models.pipeline import process_frame
    from stereo_to_multiview_tpu_torch.utils.profiling import StageTimer

    dev = torch.device("cuda")
    sbs_dev = torch.as_tensor(sbs).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = process_frame(sbs_dev, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.wrappers().items()}
    print(f"main path: first frame {first_s * 1e3:.1f} ms; launches "
          f"{launches}", flush=True)
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise SmokeFailure(f"kernels not launched on the main path: {missing}")

    timer = StageTimer()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        out = process_frame(sbs_dev, cfg, timer=timer)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    stages = {k: v / n_frames for k, v in timer.ms().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path: {frame_ms:.2f} ms/frame over {n_frames} frames "
          f"(host clock, synchronized); peak device memory {peak_gb:.2f} GB",
          flush=True)
    print("stages (CUDA events, ms/frame): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    return out, launches, frame_ms, stages, peak_gb


def check_outputs(out, cfg):
    """Phase 4a: the 1080p outputs are well formed."""
    import torch
    dl, dr, il = out
    lo, hi = cfg.disp_range
    for name, d in (("disp_l", dl), ("disp_r", dr)):
        if tuple(d.shape) != (cfg.num_rows, cfg.num_cols) or d.dtype != \
                torch.float32:
            raise SmokeFailure(f"{name}: shape {tuple(d.shape)} {d.dtype}")
        if not bool(torch.isfinite(d).all()):
            raise SmokeFailure(f"{name}: non-finite values")
        if float(d.min()) < lo or float(d.max()) >= hi:
            raise SmokeFailure(f"{name}: values outside [{lo}, {hi})")
    if tuple(il.shape) != cfg.out_shape or il.dtype != torch.uint8:
        raise SmokeFailure(f"interlaced: shape {tuple(il.shape)} {il.dtype}")
    if float(il.float().std()) < 10.0:
        raise SmokeFailure("interlaced: degenerate image")


def check_small_frame():
    """Phase 4b: a small frame on the card (kernels) against the same
    frame on the CPU (plain versions): disparities before the bilateral
    and the labels exact; final disparities and interlace within the
    float32 rounding of torch.exp on the two devices."""
    import numpy as np
    import torch
    from stereo_to_multiview_tpu_torch.config import PipelineConfig
    from stereo_to_multiview_tpu_torch.models import pipeline

    cfg = PipelineConfig(num_rows=96, num_cols=160, num_rows_out=96,
                         num_cols_out=160, num_disp=32, zero_disp=16,
                         usd=12, lsd=6, num_views=8, irv_iterations=3,
                         bilateral_radius=3, feather_radius=5)
    sbs = fish_sbs(96, 160)
    res = {}
    for dev in ("cuda", "cpu"):
        l, r = (t.contiguous().to(dev) for t in
                pipeline.demux_sbs(torch.from_numpy(sbs)))
        raw = pipeline.raw_disparities(l, r, cfg)
        final = pipeline.process_frame(sbs, cfg, device=dev)
        res[dev] = [x.cpu().numpy() for x in (*raw, *final)]
    g, c = res["cuda"], res["cpu"]
    for i, name in enumerate(("raw disp_l", "raw disp_r", "labels_l",
                              "labels_r")):
        if not np.array_equal(g[i], c[i]):
            raise SmokeFailure(f"small frame: {name} differs card vs CPU")
    dmax = max(float(np.abs(g[4] - c[4]).max()),
               float(np.abs(g[5] - c[5]).max()))
    same = float(np.mean(g[6] == c[6]))
    print(f"small frame 96x160 D=32: raw disparities and labels equal card "
          f"vs CPU; final disparity max diff {dmax:.3g}; interlaced "
          f"identical on {same:.5f} of subpixels", flush=True)
    if dmax > 1e-4 or same < 0.999:
        raise SmokeFailure("small frame: card and CPU outputs disagree")
    return dict(final_disp_max_diff=dmax, interlaced_same=same)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from stereo_to_multiview_tpu_torch import kernels
        from stereo_to_multiview_tpu_torch.config import HD1080_D128
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
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}", flush=True)

        cfg = HD1080_D128
        sbs = fish_sbs(cfg.num_rows, cfg.num_cols)
        dev = torch.device("cuda")
        from stereo_to_multiview_tpu_torch.ops.demux import demux_sbs
        img_l, img_r = (t.contiguous() for t in
                        demux_sbs(torch.from_numpy(sbs).to(dev)))
        chk = KernelChecks(reps=10)
        arms_l, arms_r = check_core_kernels(chk, img_l, img_r, cfg)
        torch.cuda.empty_cache()
        check_post_kernels(chk, img_l, img_r, arms_l, arms_r, cfg)
        kres = chk.results
        del img_l, img_r, arms_l, arms_r
        torch.cuda.empty_cache()

        out, launches, frame_ms, stages, peak_gb = run_main_path(sbs, cfg, 3)
        check_outputs(out, cfg)
        report["small_frame"] = check_small_frame()
    except (SmokeFailure, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    rows = []
    for name, (wrapper, source, replaces) in KERNELS.items():
        r = kres[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[wrapper],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         library_ms=r["library_ms"]))
    report.update(kernels=rows, frame_ms=frame_ms, stages_ms=stages,
                  peak_memory_gb=peak_gb, launches=launches)
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    with open(os.path.join(HERE, "out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"frame: {frame_ms:.2f} ms per frame at HD1080_D128 on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
