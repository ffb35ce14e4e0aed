"""Streaming driver: the reference's video loop (video_io.cpp:42-224) on
a CUDA device.  Frames are decoded on a host thread while the device
computes; the per-frame or steady-state time is metered; outputs go to a
callback instead of a window.  File sources loop at EOF like the
reference (video_io.cpp:149-153).

`stream(..., depth=1)` is the serial latency loop: upload, compute,
fetch.  With depth >= 2 on a CUDA device up to `depth` frames are in
flight: each frame is copied into one of a ring of pinned host buffers
and uploaded by a non-blocking copy on a side stream, which the compute
stream waits for with an event; the result is read back by a
non-blocking copy into pinned memory, completed by an event before the
meter and the callback see the frame.  `process_frame` reads nothing
back to the host between IRV rounds (each round is queued under the
device-side frontier), so the host queues a whole frame ahead: depth 2
overlaps the uploads, readbacks and decode with the device's work.

While a profiler is on, each step of the loop is a span on the loop's
thread (`utils.profiling.stage_scope`): `stream.pull` (the wait for the
next frame), `stream.stage_in` (the host copy into the pinned slot),
`stream.upload`, `stream.dispatch` (the launch of the frame's stages),
`stream.readback`, `stream.wait` (the host blocked on a frame's
completion) and `stream.emit` (the consumer's callback).
"""

from __future__ import annotations

import glob
import itertools
import os
import queue
import threading
import time
from collections import deque
from typing import Iterator, List, Optional

import numpy as np
import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp
from stereo_to_multiview_tpu_torch.utils.profiling import stage_scope
from stereo_to_multiview_tpu_torch.utils.timing import FrameMeter

CORNER = 8          # readback="sync" fetches an 8x8 corner


def _bmp_files(path: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(path, "*.bmp")) if
                   os.path.isdir(path) else glob.glob(path))
    if not files:
        raise FileNotFoundError(f"no BMP frames at {path}")
    return files


class FrameSource:
    """SBS frame source from files.

    Accepted layouts:
      * directory of SBS frames:     frame_000.bmp, frame_001.bmp, ...
      * directory of L/R pairs:      sorted files taken two at a time as
        non-overlapping (L, R) pairs -- (f0, f1), (f2, f3), ... --
        stitched into SBS (pair mode).
    """

    def __init__(self, path: str, pair_mode: bool = False,
                 loop: bool = True, max_frames: Optional[int] = None):
        self.files = _bmp_files(path)
        self.pair_mode = pair_mode
        self.loop = loop
        self.max_frames = max_frames

    def _frame_list(self) -> List:
        if self.pair_mode:
            return list(zip(self.files[0::2], self.files[1::2]))
        return self.files

    def __iter__(self) -> Iterator[np.ndarray]:
        n = 0
        items = self._frame_list()
        while True:
            for it in items:
                if self.max_frames is not None and n >= self.max_frames:
                    return
                if self.pair_mode:
                    l = read_bmp(it[0])
                    r = read_bmp(it[1])
                    if l.shape != r.shape:
                        continue  # skip mismatched pairs
                    yield np.concatenate([l, r], axis=1)
                else:
                    yield read_bmp(it)
                n += 1
            if not self.loop:
                return


class Y4MSource:
    """SBS frame source from a Y4M video file (the reference's
    cv::VideoCapture loop, video_io.cpp:77,148-153), looping at EOF.
    Uses the native C++ reader when the host compiler built it, the
    NumPy reader otherwise (bit-identical output); `reader` names it."""

    def __init__(self, path: str, loop: bool = True,
                 max_frames: Optional[int] = None):
        self.path = path
        self.loop = loop
        self.max_frames = max_frames
        self._reader = self._open()
        self.h, self.w = self._reader.h, self._reader.w

    def _open(self):
        from stereo_to_multiview_tpu_torch import native
        if native.available():
            self.reader = "native"
            return native.NativeY4M(self.path)
        from stereo_to_multiview_tpu_torch.utils.y4m import Y4MReader
        self.reader = "python"
        return Y4MReader(self.path)

    def __iter__(self) -> Iterator[np.ndarray]:
        n = 0
        r = self._reader
        while True:
            fr = r.read_frame()
            if fr is None:
                if not self.loop or n == 0:
                    return
                r.rewind()
                continue
            yield fr
            n += 1
            if self.max_frames is not None and n >= self.max_frames:
                return


class FFmpegSource:
    """SBS frame source from any container ffmpeg can open (mp4, mkv,
    webm, ...): an `ffmpeg -i X -f yuv4mpegpipe -` subprocess feeds the
    Y4M parser.  Looping at EOF restarts the subprocess (pipes cannot
    rewind).  Requires the `ffmpeg` binary on PATH."""

    def __init__(self, path: str, loop: bool = True,
                 max_frames: Optional[int] = None, ffmpeg: str = "ffmpeg"):
        import shutil
        self.path = path
        self.loop = loop
        self.max_frames = max_frames
        self.ffmpeg = ffmpeg
        if shutil.which(ffmpeg) is None:
            raise FileNotFoundError(
                f"'{ffmpeg}' not on PATH -- install ffmpeg or pre-convert "
                f"with `ffmpeg -i {path} out.y4m` and pass the .y4m")
        self._proc = None
        self._reader = self._spawn()
        self.h, self.w = self._reader.h, self._reader.w

    def _command(self):
        return [self.ffmpeg, "-v", "error", "-nostdin", "-i", self.path,
                "-f", "yuv4mpegpipe", "-pix_fmt", "yuv420p", "-"]

    def _spawn(self):
        import subprocess
        from stereo_to_multiview_tpu_torch.utils.y4m import Y4MReader
        self._close_proc()
        self._proc = subprocess.Popen(self._command(),
                                      stdout=subprocess.PIPE)
        return Y4MReader(self._proc.stdout)

    def _close_proc(self):
        if self._proc is not None:
            self._proc.stdout.close()
            self._proc.wait()
            self._proc = None

    def __iter__(self) -> Iterator[np.ndarray]:
        n = 0
        if self._proc is None:
            # a previous iteration reaped the child: respawn, so the
            # source can be iterated again
            self._reader = self._spawn()
        try:
            while True:
                fr = self._reader.read_frame()
                if fr is None:
                    if not self.loop or n == 0:
                        return
                    self._reader = self._spawn()
                    continue
                yield fr
                n += 1
                if self.max_frames is not None and n >= self.max_frames:
                    return
        finally:
            # a consumer may abandon the iterator early: reap the child
            self._close_proc()

    def close(self) -> None:
        self._close_proc()


def native_source(path: str, pair_mode: bool = False, loops: int = 1,
                  depth: int = 4, threads: int = 2):
    """Frame iterator backed by the native C++ decode queue
    (native/stm_native.cpp): multi-threaded BMP decode and SBS stitch
    ahead of the consumer.  Falls back to FrameSource when the host
    compiler is unavailable."""
    from stereo_to_multiview_tpu_torch import native

    files = _bmp_files(path)
    if not native.available():
        return FrameSource(path, pair_mode=pair_mode, loop=loops > 1,
                           max_frames=None)
    if pair_mode and len(files) % 2:
        files = files[:-1]     # the C side takes files two at a time
    return native.NativeFrameQueue(files, pair_mode=pair_mode, depth=depth,
                                   loops=loops, threads=threads)


class PrefetchingSource:
    """Decode frames on a host thread so I/O overlaps device compute."""

    def __init__(self, source, depth: int = 4):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for frame in self.source:
                self.q.put(frame)
        finally:
            self.q.put(self._done)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._done:
                return
            yield item


class _Transfers:
    """The pipelined loop's host<->device traffic on a CUDA device: rings
    of `depth` pinned input and readback buffers and device input
    buffers; uploads on a side stream.  Slot k serves frames k, k + depth,
    ...; a frame's slot is reused only after that frame completed."""

    def __init__(self, dev: torch.device, depth: int, shape, out_shape,
                 readback: str):
        self.dev = dev
        self.side = torch.cuda.Stream(dev)
        pin = dict(dtype=torch.uint8, pin_memory=True)
        self.host_in = [torch.empty(shape, **pin) for _ in range(depth)]
        self.dev_in = [torch.empty(shape, dtype=torch.uint8, device=dev)
                       for _ in range(depth)]
        back = out_shape if readback == "full" else (CORNER, CORNER, 3)
        self.host_out = [torch.empty(back, **pin) for _ in range(depth)]
        self.readback = readback

    def upload(self, k: int, sbs: np.ndarray) -> torch.Tensor:
        """Frame into slot k, uploaded on the side stream; the current
        (compute) stream waits for it."""
        with stage_scope("stream.stage_in"):
            # torch's copy runs on its intra-op threads: a 1080p frame in
            # ~0.2 ms, where numpy's one thread takes ~1.1 ms
            self.host_in[k].copy_(torch.from_numpy(np.ascontiguousarray(sbs)))
        with stage_scope("stream.upload"):
            done = torch.cuda.Event()
            with torch.cuda.stream(self.side):
                self.dev_in[k].copy_(self.host_in[k], non_blocking=True)
                done.record(self.side)
            torch.cuda.current_stream(self.dev).wait_event(done)
        return self.dev_in[k]

    def fetch(self, k: int, interlaced: torch.Tensor) -> torch.cuda.Event:
        """Readback of the interlaced frame (or its corner) into slot k's
        pinned buffer behind the frame's work; returns its event."""
        src = (interlaced if self.readback == "full"
               else interlaced[:CORNER, :CORNER])
        with stage_scope("stream.readback"):
            self.host_out[k][:src.shape[0], :src.shape[1]].copy_(
                src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.dev))
        return done


def stream(source, cfg: PipelineConfig, lowres: Optional[bool] = None,
           on_frame=None, prefetch: int = 4, verbose: bool = True,
           max_consecutive_failures: int = 3, depth: int = 1,
           readback: str = "full", device=None):
    """Run the pipeline over a frame stream; returns FrameMeter stats.

    on_frame(i, disp_l, disp_r, interlaced) is called with tensors on the
    device, in frame order.

    lowres: the route.  None (the default) takes the configuration's:
    `process_frame_lowres` where cfg sets num_rows_disp and num_cols_disp
    (`cfg.lowres`), else `process_frame`.  True or False picks one; False
    at a lowres configuration runs `process_frame` at it.

    device: the CUDA device unless the caller asks for another
    (`resolve_device`: without a GPU and without `device="cpu"` this
    raises).

    depth: frames in flight.  1 = the serial loop (upload, compute, fetch
    a frame; the metered time is the frame's latency).  >= 2 pipelines
    the transfers against the compute (on a CUDA device: pinned buffers,
    a side stream for uploads, non-blocking readbacks); the metered time
    is then the completion-to-completion delta, the steady-state time
    per frame, not latency.

    readback: "full" fetches the whole interlaced frame to the host each
    frame (the reference display loop's shape, video_io.cpp:167-170);
    "sync" fetches only its 8x8 corner, to complete the frame, and leaves
    the frames on the device (a consumer that displays or encodes from
    device memory).

    Failure policy: a bad frame (decode error, shape mismatch, device
    error) is logged and skipped; more than `max_consecutive_failures`
    in a row abort the stream (a sticky CUDA error fails every later
    frame, and this is what ends the stream then).  An exception raised
    by `on_frame` propagates.
    """
    from stereo_to_multiview_tpu_torch.models.pipeline import (
        check_ported, process_frame, process_frame_lowres, resolve_device)

    if readback not in ("full", "sync"):
        raise ValueError(f"readback must be 'full' or 'sync', not "
                         f"{readback!r}")
    dev = resolve_device(device)
    check_ported(cfg)
    if lowres is None:
        lowres = cfg.lowres
    fn = process_frame_lowres if lowres else process_frame
    meter = FrameMeter(warmup=2)
    src = PrefetchingSource(source, prefetch) if prefetch else source
    pipelined = depth >= 2 and dev.type == "cuda"
    xfer = None

    failures = 0
    inflight = deque()          # (index, t_dispatch, outputs, event)
    last_done = None

    def _dispatch(i, sbs):
        nonlocal xfer
        t0 = time.perf_counter()
        if not pipelined:
            with stage_scope("stream.dispatch"):
                return i, t0, fn(sbs, cfg, device=dev), None
        if tuple(sbs.shape) != cfg.sbs_shape or sbs.dtype != np.uint8:
            raise ValueError(f"expected a {cfg.sbs_shape} uint8 frame, got "
                             f"{tuple(sbs.shape)} {sbs.dtype}")
        if xfer is None:
            xfer = _Transfers(dev, depth, cfg.sbs_shape, cfg.out_shape,
                              readback)
        k = i % depth
        frame = xfer.upload(k, sbs)
        with stage_scope("stream.dispatch"):
            out = fn(frame, cfg, device=dev)
        return i, t0, out, xfer.fetch(k, out[2])

    def _finish(j, t0, out, done):
        """Complete frame j and meter it.  May raise (device errors
        belong to the failure policy)."""
        nonlocal last_done
        with stage_scope("stream.wait"):
            if done is not None:
                done.synchronize()
            elif readback == "full":
                out[2].cpu()
            else:
                out[2][:CORNER, :CORNER].cpu()
        now = time.perf_counter()
        # depth 1: the time around upload, compute and fetch, so the
        # consumer's time never enters the stats; pipelined: completion
        # to completion (a slow consumer does enter these)
        dt = (now - t0) if depth <= 1 or last_done is None \
            else (now - last_done)
        last_done = now
        meter.add(dt)
        if verbose:
            print(f"[[ frame {j} took: {dt * 1e3:.1f} ms ]]")
        return j, out

    def _emit(done):
        if done is not None and on_frame is not None:
            with stage_scope("stream.emit"):
                on_frame(done[0], *done[1])

    frames, end = iter(src), object()
    for i in itertools.count():
        with stage_scope("stream.pull"):
            sbs = next(frames, end)
        if sbs is end:
            break
        try:
            inflight.append(_dispatch(i, sbs))
            done = None
            if len(inflight) >= max(1, depth):
                done = _finish(*inflight.popleft())
        except Exception as e:  # noqa: BLE001 -- a frame may fail alone
            failures += 1
            print(f"[[ frame {i} FAILED: {type(e).__name__}: {e} ]]")
            if failures > max_consecutive_failures:
                raise
            continue
        failures = 0
        _emit(done)
    for item in inflight:
        _emit(_finish(*item))
    return meter.stats()
