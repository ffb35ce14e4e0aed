#!/usr/bin/env python
"""Streaming demo on the GPU -- the reference's video_io
(video_io.cpp:42-224) without OpenCV: frames come from a Y4M video file
(*.y4m, `ffmpeg -i in.mp4 out.y4m`), another video container through an
ffmpeg pipe, or a directory of SBS BMPs (or L/R pairs).  Each frame runs
`process_frame`, its time is printed, and selected outputs are written
as PNG.

    python -m stereo_to_multiview_tpu_torch.apps.video_io VIDEO NVIEWS \\
        ANGLE OUT_W OUT_H NDISP ZERODISP AD_COEFF CENSUS_COEFF UCD LCD USD \\
        LSD THRESH_S THRESH_H [--frames N] [--depth D] \\
        [--readback full|sync] [--lowres RxC:SCALE] [--out-dir DIR] \\
        [--preview PORT] [--cpu]

VIDEO is resolved under --vid-dir (default ./vid) unless it exists as
given (video_io.cpp:66-68); it may be a directory or a glob.  Runs on the
CUDA device; --cpu runs the kernels' plain versions on the CPU instead.
"""

import argparse
import glob
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".mov", ".avi", ".m4v", ".mpg",
              ".mpeg", ".ts")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("video")
    p.add_argument("nviews", type=int), p.add_argument("angle", type=float)
    p.add_argument("out_w", type=int), p.add_argument("out_h", type=int)
    p.add_argument("ndisp", type=int), p.add_argument("zerodisp", type=int)
    p.add_argument("ad_coeff", type=float)
    p.add_argument("census_coeff", type=float)
    p.add_argument("ucd", type=float), p.add_argument("lcd", type=float)
    p.add_argument("usd", type=int), p.add_argument("lsd", type=int)
    p.add_argument("thresh_s", type=int)
    p.add_argument("thresh_h", type=float)
    p.add_argument("--vid-dir", default="./vid")
    p.add_argument("--out-dir", default=None,
                   help="write disparity+interlaced PNGs per frame")
    p.add_argument("--pair-mode", action="store_true",
                   help="treat frames as alternating L/R single images")
    p.add_argument("--frames", type=int, default=None, help="stop after N")
    p.add_argument("--no-loop", action="store_true")
    p.add_argument("--preview", type=int, default=None, metavar="PORT",
                   help="serve a live browser preview (interlaced + "
                        "disparity) at http://host:PORT/, with "
                        "pause/resume (video_io.cpp:167-221)")
    p.add_argument("--preview-host", default="127.0.0.1",
                   help="preview bind address (default loopback; pass "
                        "0.0.0.0 to expose it -- /pause is "
                        "unauthenticated and stalls the stream)")
    p.add_argument("--lowres", type=str, default=None, metavar="RxC:SCALE",
                   help="adcensus_stm_2 mode, e.g. 192x320:1.0")
    p.add_argument("--depth", type=int, default=1,
                   help="frames in flight: 1 = serial latency loop; >= 2 "
                        "overlaps uploads and readbacks with compute and "
                        "the printed per-frame time becomes steady-state "
                        "throughput")
    p.add_argument("--readback", choices=("full", "sync"), default="full",
                   help="full = fetch every interlaced frame to the host; "
                        "sync = complete each frame with a corner fetch, "
                        "frames stay on the device")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p


def open_source(args):
    """(source, rows, SBS columns) of the VIDEO argument."""
    from stereo_to_multiview_tpu_torch.models.stream import (
        FFmpegSource, FrameSource, Y4MSource)
    path = args.video
    if not os.path.exists(path) and not glob.glob(path):
        path = os.path.join(args.vid_dir, args.video)
    loop = not args.no_loop
    if path.endswith(".y4m"):
        src = Y4MSource(path, loop=loop, max_frames=args.frames)
        print(f"Y4M reader: {src.reader}")
        return src, src.h, src.w
    if (os.path.splitext(path)[1].lower() in VIDEO_EXTS
            and os.path.isfile(path)):
        src = FFmpegSource(path, loop=loop, max_frames=args.frames)
        return src, src.h, src.w
    src = FrameSource(path, pair_mode=args.pair_mode, loop=loop,
                      max_frames=args.frames)
    first = next(iter(FrameSource(path, pair_mode=args.pair_mode,
                                  loop=False, max_frames=1)))
    return src, first.shape[0], first.shape[1]


def main(argv=None):
    args = build_parser().parse_args(argv)
    from stereo_to_multiview_tpu_torch.config import PipelineConfig
    from stereo_to_multiview_tpu_torch.models.pipeline import resolve_device
    from stereo_to_multiview_tpu_torch.models.stream import stream
    from stereo_to_multiview_tpu_torch.utils.device import (
        enable_compilation_cache, print_device_info)
    from stereo_to_multiview_tpu_torch.utils.imageio import (
        normalize_for_display, write_png)

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"Error! {e}", file=sys.stderr)
        return 1
    print("=======================================")
    print("== STEREO TO MULTIVIEW VIDEO PROCESS ==")
    print("=======================================\n")
    print_device_info(device)
    enable_compilation_cache(device)

    src, h, w_sbs = open_source(args)
    w = w_sbs // 2
    print(f"Input Width (SBS):  {w_sbs}")
    print(f"Input Width:        {w}")
    print(f"Input Height:       {h}\n")

    kw = {}
    if args.lowres:
        dims, scale = args.lowres.split(":")
        rr, cc = dims.split("x")
        kw = dict(num_rows_disp=int(rr), num_cols_disp=int(cc),
                  disp_scale=float(scale))
    cfg = PipelineConfig(
        num_rows=h, num_cols=w, num_rows_out=args.out_h,
        num_cols_out=args.out_w, num_disp=args.ndisp,
        zero_disp=args.zerodisp, ad_coeff=args.ad_coeff,
        census_coeff=args.census_coeff, ucd=args.ucd, lcd=args.lcd,
        usd=args.usd, lsd=args.lsd, irv_thresh_s=args.thresh_s,
        irv_thresh_h=args.thresh_h, num_views=args.nviews,
        angle=args.angle, **kw)

    callbacks = []
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

        def dump_frame(i, dl, dr, il):
            write_png(os.path.join(args.out_dir, f"disp_l_{i:04d}.png"),
                      normalize_for_display(dl.cpu().numpy()))
            write_png(os.path.join(args.out_dir, f"interlaced_{i:04d}.png"),
                      il.cpu().numpy())
        callbacks.append(dump_frame)

    pv = None
    if args.preview is not None:
        import time
        from stereo_to_multiview_tpu_torch.utils.preview import PreviewServer
        pv = PreviewServer(args.preview, host=args.preview_host)
        print(f"live preview: http://{args.preview_host}:{pv.port}/")

        def preview_frame(i, dl, dr, il):
            pv.update(interlaced=il.cpu().numpy(),
                      disp_l=normalize_for_display(dl.cpu().numpy()))
            while pv.paused:            # the reference's 'p' key
                time.sleep(0.1)
        callbacks.append(preview_frame)

    def on_frame(i, dl, dr, il):
        for cb in callbacks:
            cb(i, dl, dr, il)

    try:
        stats = stream(src, cfg, lowres=bool(args.lowres),
                       on_frame=on_frame if callbacks else None,
                       depth=args.depth, readback=args.readback,
                       device=device)
    finally:
        if pv is not None:
            pv.close()
    print(f"\nsteady-state: {stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
