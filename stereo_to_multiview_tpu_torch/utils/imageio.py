"""Dependency-free PNG writer + generic image read/write dispatch.

PNG output replaces the reference's interactive OpenCV HighGUI viewer
(image_io.cpp:321-470) -- every display mode becomes a file dump.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp, write_bmp


def png_bytes(img: np.ndarray, level: int = 6) -> bytes:
    """Encode (H, W), (H, W, 1) grayscale or (H, W, 3) BGR uint8 as PNG
    bytes (dependency-free; `level` trades size for speed -- the live
    preview uses 1)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("png_bytes expects uint8 (normalize first)")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color_type, raw = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, raw = 2, img[:, :, ::-1]  # BGR -> RGB for PNG
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    h, w = raw.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    lines = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw.reshape(h, -1)], axis=1)
    idat = zlib.compress(lines.tobytes(), level)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W), (H, W, 1) grayscale or (H, W, 3) BGR uint8 as PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_image(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        return read_bmp(path)
    raise ValueError(f"unsupported input format: {ext} (BMP only; the bundled "
                     "assets are 24bpp BMP)")


def write_image(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        write_bmp(path, img)
    elif ext == ".png":
        write_png(path, img)
    else:
        raise ValueError(f"unsupported output format: {ext}")


def normalize_for_display(arr: np.ndarray) -> np.ndarray:
    """Min-max normalize a float map to uint8, like the reference's
    cv::normalize(CV_MINMAX) display prep (image_io.cpp:295-305)."""
    arr = np.asarray(arr, np.float64)
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= lo:
        return np.zeros(arr.shape, np.uint8)
    return ((arr - lo) * (255.0 / (hi - lo))).astype(np.uint8)
