"""Input demultiplexing."""

from __future__ import annotations

import torch


def demux_sbs(sbs: torch.Tensor):
    """Split an (H, 2W, 3) side-by-side frame into left/right (H, W, 3)
    views (columns [0, W) -> left)."""
    w = sbs.shape[1] // 2
    return sbs[:, :w], sbs[:, w:2 * w]


def demux_rgb(img: torch.Tensor):
    """Split an (H, W, 3) BGR image into its (r, g, b) planes."""
    return img[:, :, 2], img[:, :, 1], img[:, :, 0]
