"""Census transform and Hamming distance for the AD-census cost.

Census codes are 48 bits held as two int32 words of 24 bits each (the
JAX package's two-u32 layout), so the cost kernel can popcount them with
two 32-bit `__popc`s.
"""

from __future__ import annotations

import torch


def clamp_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices lo..hi-1 clamped into [0, n) (clamp-to-edge reads)."""
    return torch.arange(lo, hi, device=device).clamp_(0, n - 1)


def census_transform_9x7(gray: torch.Tensor) -> torch.Tensor:
    """Census code of (H, W) uint8 grayscale over a 9(w) x 7(h) window.

    Returns (H, W, 2) int32: word 0 packs the 24 comparisons of rows
    dy in {-3, -2, -1}, word 1 the rows dy in {1, 2, 3} (dx in
    {-4..4} minus 0 each, raster order, shift-then-set).  The anchor row
    and anchor column are excluded.  Bit set iff neighbor < center;
    clamp-to-edge reads."""
    h, w = gray.shape
    g = gray.to(torch.int32)
    rows = clamp_index(h, -3, h + 3, g.device)
    cols = clamp_index(w, -4, w + 4, g.device)
    gp = g[rows][:, cols]                               # (h+6, w+8)
    words = []
    for dys in ((-3, -2, -1), (1, 2, 3)):
        word = torch.zeros((h, w), dtype=torch.int32, device=g.device)
        for dy in dys:
            for dx in (-4, -3, -2, -1, 1, 2, 3, 4):
                nb = gp[3 + dy:3 + dy + h, 4 + dx:4 + dx + w]
                word = (word << 1) + (nb < g).to(torch.int32)
        words.append(word)
    return torch.stack(words, dim=-1)


_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int32)


def popcount24(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 values below 2^24."""
    lut = _POP8.to(x.device)
    x = x.to(torch.int64)
    return (lut[x & 255] + lut[(x >> 8) & 255] + lut[(x >> 16) & 255])


def hamming48(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between (..., 2)-int32 census codes -> (...)."""
    pc = popcount24(a ^ b)
    return pc[..., 0] + pc[..., 1]
