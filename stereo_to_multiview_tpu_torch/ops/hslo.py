"""Horizontal scanline optimisation (semi-global DP along rows) on the
band engine's (H, W, D) volume: the plain PyTorch version.

    C_r(p, d) = C(p, d) - min_k C_r(p-r, k)
                + min(C_r(p-r, d), C_r(p-r, d-1) + P1, C_r(p-r, d+1) + P1,
                      min_k C_r(p-r, k) + P2)

scanned left-to-right and right-to-left, the two directions averaged.
Each direction's first column is its own cost.  P1/P2 come in three
tiers keyed on the colour gradients of both images: both below T ->
(H1, H2); exactly one -> a quarter; neither -> a tenth.  Every step is a
float32 add, subtract or minimum in the JAX package's order
(`ops/hslo.py` `dc_hslo_hwd`), so the two agree to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_to_multiview_tpu_torch.ops.cost import clamp_index

F32 = torch.float32
BIG = 1e30
TIER_SCALES = (0.1, 0.25, 1.0)      # by the count of small gradients


def tier_penalties(H1: float, H2: float):
    """((p1 of tier 0, 1, 2), (p2 ...)): float32(H) * float32(scale),
    rounded once, as Python floats."""
    return tuple(tuple(float(np.float32(h) * np.float32(s))
                       for s in TIER_SCALES) for h in (H1, H2))


def small_gradients(gray: torch.Tensor, T: float) -> torch.Tensor:
    """(H, W) bool: |g(x) - g(x-1)| < T, with column -1 read as column
    0."""
    g = gray.to(F32)
    prev = g[:, clamp_index(g.shape[1], -1, g.shape[1] - 1, g.device)]
    return (g - prev).abs() < T


def tiers_hwd(gray_a: torch.Tensor, gray_b: torch.Tensor, num_disp: int,
              zero_disp: int, T: float, sign: int) -> torch.Tensor:
    """(H, W, D) int64 count of small gradients in {0, 1, 2}: the own
    image's at x, the other image's at x' = clamp(x + sign * (d -
    zero_disp), 0, W - 1)."""
    w = gray_a.shape[1]
    dev = gray_a.device
    x = torch.arange(w, device=dev)[:, None]
    d = torch.arange(num_disp, device=dev)[None, :]
    xp = (x + sign * (d - zero_disp)).clamp(0, w - 1)          # (W, D)
    s1 = small_gradients(gray_a, T).to(torch.int64)
    s2 = small_gradients(gray_b, T).to(torch.int64)
    return s1[:, :, None] + s2[:, xp]


def penalties_hwd(gray_a, gray_b, num_disp: int, zero_disp: int, T: float,
                  H1: float, H2: float, sign: int):
    """(p1, p2), each (H, W, D) float32."""
    tier = tiers_hwd(gray_a, gray_b, num_disp, zero_disp, T, sign)
    t1, t2 = tier_penalties(H1, H2)
    dev = gray_a.device
    return (torch.tensor(t1, dtype=F32, device=dev)[tier],
            torch.tensor(t2, dtype=F32, device=dev)[tier])


def scan_dir_hwd(cost: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 reverse: bool) -> torch.Tensor:
    """One direction of the DP over the columns of an (H, W, D) float32
    volume: a loop over W of (H, D) blocks."""
    h, w, _ = cost.shape
    big = torch.full((h, 1), BIG, dtype=F32, device=cost.device)
    out = torch.empty_like(cost)
    cols = range(w - 1, -1, -1) if reverse else range(w)
    prev = None
    for x in cols:
        if prev is None:
            prev = cost[:, x]
        else:
            mn = prev.min(dim=1, keepdim=True).values
            up = torch.cat([prev[:, 1:], big], dim=1)
            dn = torch.cat([big, prev[:, :-1]], dim=1)
            best = torch.minimum(torch.minimum(prev, mn + p2[:, x]),
                                 torch.minimum(up, dn) + p1[:, x])
            prev = cost[:, x] + best - mn
        out[:, x] = prev
    return out


def dc_hslo_hwd(cost: torch.Tensor, gray_l: torch.Tensor,
                gray_r: torch.Tensor, num_disp: int, zero_disp: int,
                T: float = 15.0, H1: float = 1.0, H2: float = 3.0,
                sign: int = +1) -> torch.Tensor:
    """Scanline-optimised (H, W, D) float32 volume, the average of the
    two directions.  `sign` selects the matching convention: +1 for the
    left eye's volume, -1 for the right's (the grays are always passed
    left, right).  For the quantized integer aggregate, scale H1/H2 by
    `ops.band.agg_cost_scale`."""
    ga, gb = (gray_r, gray_l) if sign < 0 else (gray_l, gray_r)
    p1, p2 = penalties_hwd(ga, gb, num_disp, zero_disp, T, H1, H2,
                           -1 if sign < 0 else +1)
    c = cost.to(F32)
    return (scan_dir_hwd(c, p1, p2, False)
            + scan_dir_hwd(c, p1, p2, True)) * 0.5


def dc_hslo(cost: torch.Tensor, gray_l: torch.Tensor, gray_r: torch.Tensor,
            num_disp: int, zero_disp: int, T: float = 15.0, H1: float = 1.0,
            H2: float = 3.0, sign: int = +1) -> torch.Tensor:
    """`dc_hslo_hwd` on a (D, H, W) volume, the XLA engine's layout: the
    same float32 steps, so the same values (each direction's first
    column is its own cost)."""
    out = dc_hslo_hwd(cost.permute(1, 2, 0), gray_l, gray_r, num_disp,
                      zero_disp, T, H1, H2, sign)
    return out.permute(2, 0, 1).contiguous()
