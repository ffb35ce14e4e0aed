"""24/32bpp BMP reader (numpy only).

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

