"""24/32bpp BMP reader and 24bpp writer (numpy only).

Arrays are (H, W, 3) uint8 in BGR channel order, the memory layout of the
bundled fixtures, so per-pixel comparisons line up 1:1.
"""

from __future__ import annotations

import struct

import numpy as np


def read_bmp(path: str) -> np.ndarray:
    """Read an uncompressed 24/32bpp BMP into an (H, W, 3) uint8 BGR array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_sz = struct.unpack_from("<I", data, 14)[0]
    if header_sz < 40:
        raise ValueError(f"{path}: unsupported BMP header size {header_sz}")
    width, height = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression not in (0, 3):  # BI_RGB or BI_BITFIELDS (BGRx masks)
        raise ValueError(f"{path}: compressed BMP not supported")
    if bpp not in (24, 32):
        raise ValueError(f"{path}: {bpp}bpp not supported (need 24/32)")

    bottom_up = height > 0
    height = abs(height)
    bytes_pp = bpp // 8
    row_sz = (width * bytes_pp + 3) & ~3  # rows padded to 4 bytes

    raw = np.frombuffer(data, np.uint8, count=row_sz * height,
                        offset=pixel_offset)
    raw = raw.reshape(height, row_sz)[:, : width * bytes_pp]
    img = raw.reshape(height, width, bytes_pp)[:, :, :3]  # BGR(A) -> BGR
    if bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img)



def write_bmp(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR array (or an (H, W) gray one) as a
    24bpp bottom-up BMP."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("expected (H, W, 3) BGR")
    row_sz = (w * 3 + 3) & ~3
    pad = row_sz - w * 3
    pixel_bytes = row_sz * h
    header = struct.pack("<2sIHHI", b"BM", 14 + 40 + pixel_bytes, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, pixel_bytes,
                       2835, 2835, 0, 0)
    rows = img[::-1].reshape(h, w * 3)                # bottom-up
    if pad:
        rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(header)
        f.write(info)
        f.write(rows.tobytes())
