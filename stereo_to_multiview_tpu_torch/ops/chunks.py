"""Row chunking shared by the stereo cores and the IRV rounds."""

from __future__ import annotations


def chunk_bounds(h: int, chunk: int, halo: int):
    """Uniform-size extended slices [(start, lo_off)] covering [0, h) in
    `chunk`-row steps: rows [start, start + ext) with start clamped to
    the image; lo_off = where the chunk's first output row sits inside."""
    ext = min(h, -(-(chunk + 2 * halo) // 8) * 8)
    out = []
    for c0 in range(0, h, chunk):
        start = min(max(0, c0 - halo), h - ext)
        out.append((start, c0 - start))
    return ext, out
