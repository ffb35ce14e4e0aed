"""The frame ring a cell streams, made from its seed on the run's device,
and what a frame source (`sources/<name>.py`) hands the run.

The bundled bud pair (left `bud_2`, right `bud_3`, 384x640) is upscaled
3x bilinearly and tiled over each eye.  Frame j of the ring pans the tiled
pair by its own offset, the same for both eyes; the offsets are stratified
(one in each sixteenth of the tile's height and width, in a seeded order,
at a seeded place inside it), so every seed streams the same spread of
content.  Each eye then gets its own Gaussian sensor noise of `sigma` grey
levels, rounded and clipped to u8.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

DATA = Path(__file__).resolve().parent.parent / "data" / "bud.npz"
RING_FRAMES = 16      # distinct frames a ring holds


@dataclass
class Frames:
    """A frame source's frames: `items`, what the stream is handed in
    turn (the window cycles through them; the first ones also warm up),
    and `frame_of(i)`, the (H, 2W, 3) u8 SBS input of item i (modulo
    their number) on the run's device, which the reference reads."""
    items: list
    frame_of: Callable


def bud_pair(device) -> tuple:
    """(left, right) (384, 640, 3) u8 tensors on `device`."""
    with np.load(DATA) as d:
        return (torch.from_numpy(d["left"]).to(device),
                torch.from_numpy(d["right"]).to(device))


def up3(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 3x upscale of an (H, W, 3) u8 image in float32, rounded."""
    out = img.to(torch.float32)
    for ax in (0, 1):
        n = img.shape[ax]
        s = torch.clamp(torch.arange(3 * n, dtype=torch.float32,
                                     device=img.device) / 3.0, max=n - 1)
        i0 = torch.floor(s).to(torch.int64)
        i1 = torch.clamp(i0 + 1, max=n - 1)
        f = (s - i0.to(torch.float32)).reshape((-1, 1, 1) if ax == 0
                                               else (1, -1, 1))
        out = (out.index_select(ax, i0) * (1.0 - f)
               + out.index_select(ax, i1) * f)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def pan_offsets(n: int, tile: tuple, gen: torch.Generator, device):
    """n (row, column) offsets inside a (rows, cols) tile: one per n-th of
    each axis, the strata taken in a seeded order, each offset at a
    seeded place inside its stratum."""
    out = []
    for size in tile:
        order = torch.randperm(n, generator=gen, device=device)
        jitter = torch.rand(n, generator=gen, device=device)
        out.append(((order.to(torch.float64) + jitter.to(torch.float64))
                    * (size / n)).floor().to(torch.int64).tolist())
    return list(zip(*out))


def make_ring(seed: int, rows: int, cols: int, sigma: float, device,
              n: int = RING_FRAMES) -> list:
    """n distinct (rows, 2 cols, 3) u8 SBS frames on `device`, a function
    of `seed` (and the device's generator)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    left, right = (up3(x) for x in bud_pair(dev))
    tile = tuple(left.shape[:2])
    frames = []
    for oy, ox in pan_offsets(n, tile, gen, dev):
        ys = (torch.arange(rows, device=dev) + oy) % tile[0]
        xs = (torch.arange(cols, device=dev) + ox) % tile[1]
        sbs = torch.cat([eye[ys][:, xs] for eye in (left, right)], dim=1)
        noise = torch.randn(sbs.shape, generator=gen, device=dev) * sigma
        frames.append(torch.clamp(torch.round(sbs.to(torch.float32) + noise),
                                  0, 255).to(torch.uint8))
    return frames
