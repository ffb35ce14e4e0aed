"""Y4M (YUV4MPEG2) codec, pure NumPy.

The reference ingests real video through cv::VideoCapture
(video_io.cpp:77,148).  The runtime's equivalent is the container-free
Y4M stream format: a one-line header, then "FRAME\\n" + planar YUV per
frame -- trivially seekable, no codec dependency, produced by
`ffmpeg -i in.mp4 out.y4m`.

This module is the fallback / reference implementation; the native C++
reader (native/stm_native.cpp stm_y4m_*, bound by
`stereo_to_multiview_tpu_torch.native`) uses the identical integer
BT.601 limited-range conversion, so both produce bit-identical BGR.
Supported: 8-bit C420* (any cositing tag; nearest chroma upsample),
C422, C444.
"""

from __future__ import annotations

import io
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def _parse_header(line: bytes) -> Tuple[int, int, int]:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a YUV4MPEG2 stream")
    w = h = 0
    cs = 420
    for tok in line.split()[1:]:
        if tok[:1] == b"W":
            w = int(tok[1:])
        elif tok[:1] == b"H":
            h = int(tok[1:])
        elif tok[:1] == b"C":
            if tok[1:4] == b"444":
                cs = 444
            elif tok[1:4] == b"422":
                cs = 422
            else:
                cs = 420
    if w <= 0 or h <= 0:
        raise ValueError("Y4M header missing W/H")
    return w, h, cs


def _chroma_shape(w: int, h: int, cs: int) -> Tuple[int, int]:
    cw = w if cs == 444 else (w + 1) // 2
    ch = (h + 1) // 2 if cs == 420 else h
    return cw, ch


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Integer BT.601 limited-range YUV (full-res planes) -> (H, W, 3) BGR
    uint8.  Bit-identical to the native reader's per-pixel math."""
    c = y.astype(np.int32) - 16
    d = u.astype(np.int32) - 128
    e = v.astype(np.int32) - 128
    b = (298 * c + 516 * d + 128) >> 8
    g = (298 * c - 100 * d - 208 * e + 128) >> 8
    r = (298 * c + 409 * e + 128) >> 8
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def bgr_to_yuv(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) BGR uint8 -> full-res BT.601 limited-range YUV planes."""
    b = img[:, :, 0].astype(np.int32)
    g = img[:, :, 1].astype(np.int32)
    r = img[:, :, 2].astype(np.int32)
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128
    clip = lambda p: np.clip(p, 0, 255).astype(np.uint8)
    return clip(y), clip(u), clip(v)


class Y4MReader:
    """Sequential Y4M frame reader -> BGR uint8 frames.  Accepts a path
    or any binary file object (e.g. an ffmpeg yuv4mpegpipe stdout --
    rewind() is then unavailable; loop by reopening the producer)."""

    def __init__(self, src):
        self.f = open(src, "rb") if isinstance(src, (str, bytes)) else src
        self.w, self.h, self.cs = _parse_header(self.f.readline())
        self._data_start = self.f.tell() if self.f.seekable() else None

    def rewind(self) -> None:
        if self._data_start is None:
            raise io.UnsupportedOperation("pipe source cannot rewind")
        self.f.seek(self._data_start)

    def read_frame(self) -> np.ndarray | None:
        line = self.f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise IOError("corrupt Y4M stream: expected FRAME marker")
        w, h, cs = self.w, self.h, self.cs
        cw, ch = _chroma_shape(w, h, cs)
        n = w * h + 2 * cw * ch
        raw = self.f.read(n)
        if len(raw) != n:
            raise IOError("truncated Y4M frame")
        buf = np.frombuffer(raw, np.uint8)
        y = buf[:w * h].reshape(h, w)
        u = buf[w * h:w * h + cw * ch].reshape(ch, cw)
        v = buf[w * h + cw * ch:].reshape(ch, cw)
        if cs != 444:             # nearest chroma upsample (like the C side)
            u = np.repeat(u, 2, axis=1)[:, :w]
            v = np.repeat(v, 2, axis=1)[:, :w]
        if cs == 420:
            u = np.repeat(u, 2, axis=0)[:h]
            v = np.repeat(v, 2, axis=0)[:h]
        return yuv_to_bgr(y, u, v)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self) -> None:
        if self.f:
            self.f.close()


def write_y4m(path: str, frames: Sequence[np.ndarray] | Iterator[np.ndarray],
              colorspace: str = "C444", fps: Tuple[int, int] = (30, 1)):
    """Write BGR uint8 frames as a Y4M stream (C444 lossless chroma,
    C422 with left-sample horizontal subsampling, or C420jpeg with
    top-left 2x2 subsampling)."""
    it: List[np.ndarray] = list(frames)
    if not it:
        raise ValueError("no frames")
    h, w = it[0].shape[:2]
    if colorspace.startswith("C444"):
        cs, tag = 444, "C444"
    elif colorspace.startswith("C422"):
        cs, tag = 422, "C422"
    else:
        cs, tag = 420, "C420jpeg"
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 "
                f"{tag}\n".encode())
        for img in it:
            if img.shape[:2] != (h, w):
                raise ValueError("inconsistent frame size")
            y, u, v = bgr_to_yuv(img)
            if cs == 420:
                u = u[::2, ::2]
                v = v[::2, ::2]
            elif cs == 422:
                u = u[:, ::2]
                v = v[:, ::2]
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
