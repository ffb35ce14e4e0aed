#!/usr/bin/env python
"""Single stereo-pair demo on the GPU -- the reference's image_io
(image_io.cpp:60-486) without OpenCV: every interactive display mode
becomes a file dump under --out-dir.

    python -m stereo_to_multiview_tpu_torch.apps.image_io LEFT RIGHT \\
        AD_COEFF CENSUS_COEFF NDISP ZERODISP UCD LCD USD LSD NVIEWS ANGLE \\
        OUT_W OUT_H THRESH_S THRESH_H [--img-dir DIR] [--out-dir DIR] \\
        [--npy] [--cost-slices] [--cpu]

LEFT/RIGHT are file names without directory or extension, resolved as
<img-dir>/<name>.bmp (image_io.cpp:80-89).  Runs on the CUDA device;
--cpu runs the kernels' plain versions on the CPU instead.
"""

import argparse
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("left"), p.add_argument("right")
    p.add_argument("ad_coeff", type=float)
    p.add_argument("census_coeff", type=float)
    p.add_argument("ndisp", type=int), p.add_argument("zerodisp", type=int)
    p.add_argument("ucd", type=float), p.add_argument("lcd", type=float)
    p.add_argument("usd", type=int), p.add_argument("lsd", type=int)
    p.add_argument("nviews", type=int), p.add_argument("angle", type=float)
    p.add_argument("out_w", type=int), p.add_argument("out_h", type=int)
    p.add_argument("thresh_s", type=int)
    p.add_argument("thresh_h", type=float)
    p.add_argument("--img-dir", default="./img")
    p.add_argument("--out-dir", default="./out")
    p.add_argument("--npy", action="store_true", help="also dump exact NPY")
    p.add_argument("--cost-slices", action="store_true",
                   help="dump per-disparity-level cost slices")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--irv-iterations", type=int, default=1,
                   help="reference image path uses 1 (image_io.cpp:237)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from stereo_to_multiview_tpu_torch.config import PipelineConfig
    from stereo_to_multiview_tpu_torch.models.pipeline import resolve_device
    from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp
    from stereo_to_multiview_tpu_torch.utils.device import (
        enable_compilation_cache, print_device_info)
    from stereo_to_multiview_tpu_torch.utils.dump import (
        DumpWriter, dump_pipeline_intermediates)
    from stereo_to_multiview_tpu_torch.utils.timing import Timer

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"Error! {e}", file=sys.stderr)
        return 1
    print_device_info(device)
    enable_compilation_cache(device)
    print("=======================================")
    print("== STEREO TO MULTIVIEW IMAGE PROCESS ==")
    print("=======================================\n")

    path_l = os.path.join(args.img_dir, f"{args.left}.bmp")
    path_r = os.path.join(args.img_dir, f"{args.right}.bmp")
    print(f"Reading {path_l}...")
    print(f"Reading {path_r}...")
    img_l = read_bmp(path_l)
    img_r = read_bmp(path_r)
    if img_l.shape != img_r.shape:
        print(f"Error! Image shapes differ: {img_l.shape} vs {img_r.shape}")
        return 1
    h, w = img_l.shape[:2]

    cfg = PipelineConfig(
        num_rows=h, num_cols=w, num_rows_out=args.out_h,
        num_cols_out=args.out_w, num_disp=args.ndisp,
        zero_disp=args.zerodisp, ad_coeff=args.ad_coeff,
        census_coeff=args.census_coeff, ucd=args.ucd, lcd=args.lcd,
        usd=args.usd, lsd=args.lsd, num_views=args.nviews, angle=args.angle,
        irv_thresh_s=args.thresh_s, irv_thresh_h=args.thresh_h,
        irv_iterations=args.irv_iterations,
        # image path literals (image_io.cpp:242-243, 257-258; dbm legacy
        # feather 7,10 d_dibr_bwarp.cu:151)
        bilateral_sigma_color=7.0, bilateral_sigma_spatial=7.0,
        feather_radius=7, feather_sigma=10.0)

    for k in ("num_cols", "num_rows", "num_views", "angle", "num_disp",
              "zero_disp", "ad_coeff", "census_coeff", "ucd", "lcd", "usd",
              "lsd", "irv_thresh_s", "irv_thresh_h"):
        print(f"{k:24s} {getattr(cfg, k)}")
    print()

    writer = DumpWriter(args.out_dir, png=True, npy=args.npy)
    with Timer("full pipeline"):
        outs = dump_pipeline_intermediates(writer, img_l, img_r, cfg,
                                           cost_slices=args.cost_slices,
                                           device=device)
    n_out = (np.asarray(outs["outliers_l"]) != 0).mean()
    print(f"outlier fraction (left): {n_out:.2%}")
    print(f"wrote display modes to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
