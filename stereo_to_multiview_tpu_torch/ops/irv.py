"""Iterative region voting: kernels B8 (row spans) and B9 (vote), with
their plain PyTorch versions.

Each round builds, for every pixel, the histogram of reliable
disparities over its cross region (vertical arms of the pixel,
horizontal arms of each covered row), separably: an inclusive row span
of the one-hot volume (`irv_rowspan`, u8 counts), then an inclusive
column span reduced to the vote (`irv_vote`).  The span volume has
B + 1 channels: one per disparity bin and a last one counting every
reliable pixel, the vote's total.  Vote rule, with the reference's quirk
of dividing the winning *disparity* (not its count): an outlier accepts
max_d iff total > thresh_s and (max_d + zero_disp) / total > thresh_h.

The port runs the fixed `iterations` rounds.  The band engine stops at
the first round that changes no label; every later round is then the
identity, so the outcome is the same.  The wrappers take the plain
version only for CPU tensors; on a CUDA tensor they launch the kernel or
raise.  Arms are clamped to [0, usd] by kernel and plain version alike
(cross arms never exceed usd).
"""

from __future__ import annotations

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT
from stereo_to_multiview_tpu_torch.ops.mux import f32


def span_sum_inclusive(vol: torch.Tensor, arm_neg: torch.Tensor,
                       arm_pos: torch.Tensor, axis: int) -> torch.Tensor:
    """out[p] = sum vol[p - arm_neg .. p + arm_pos] (both ends included)
    along axis 0 or 1 of an (H, W) or (H, W, B) integer volume; the
    endpoints clamp into the axis."""
    n = vol.shape[axis]
    cs = torch.cumsum(vol, dim=axis, dtype=torch.int32)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    shape = [1, 1]
    shape[axis] = n
    pos = torch.arange(n, device=vol.device).reshape(shape)
    hi = (pos + arm_pos + 1).clamp(0, n)
    lo = (pos - arm_neg).clamp(0, n)
    if vol.dim() == 3:
        hi = hi[:, :, None].expand(vol.shape)
        lo = lo[:, :, None].expand(vol.shape)
    return cs.gather(axis, hi) - cs.gather(axis, lo)


def irv_rowspan_plain(disp, outliers, left, right, num_disp: int,
                      zero_disp: int, usd: int) -> torch.Tensor:
    """Plain version of `irv_rowspan`: the one-hot volume, then a
    prefix-sum span along the row."""
    reliable = outliers == 0
    bins = torch.arange(num_disp, device=disp.device, dtype=torch.int32)
    onehot = reliable[:, :, None] & (disp.to(torch.int32)[:, :, None]
                                     + zero_disp == bins)
    vol = torch.cat([onehot, reliable[:, :, None]], dim=2).to(torch.int32)
    return span_sum_inclusive(vol, left.clamp(0, usd), right.clamp(0, usd),
                              axis=1).to(torch.uint8)


def irv_vote_plain(cnt, disp, outliers, up, down, thresh_s: int,
                   thresh_h: float, zero_disp: int, usd: int):
    """Plain version of `irv_vote`: a prefix-sum span along the column,
    then argmax and the vote rule."""
    span = span_sum_inclusive(cnt.to(torch.int32), up.clamp(0, usd),
                              down.clamp(0, usd), axis=0)
    hist, total = span[:, :, :-1], span[:, :, -1]
    dint = disp.to(torch.int32)                     # trunc toward zero
    max_bin = hist.amax(dim=2)
    winner = torch.argmax(hist, dim=2).to(torch.int32)   # first max
    max_d = torch.where(max_bin > 0, winner - zero_disp, dint)
    ratio = ((max_d + zero_disp).to(torch.float32)
             / total.clamp(min=1).to(torch.float32))
    accept = (outliers != 0) & (total > thresh_s) & (ratio > f32(thresh_h))
    return (torch.where(accept, max_d.to(torch.float32), disp),
            torch.where(accept, 0, outliers))


def _check_planes(disp, outliers, arms, names, what):
    kernels.require(disp, "disp", torch.float32, 2, disp.device)
    kernels.require(outliers, "outliers", torch.uint8, 2, disp.device)
    for name, a in zip(names, arms):
        kernels.require(a, name, torch.int32, 2, disp.device)
    if any(t.shape != disp.shape for t in (outliers, *arms)):
        raise ValueError(f"{what}: plane shapes differ")


@kernels.kernel_wrapper
def irv_rowspan(disp: torch.Tensor, outliers: torch.Tensor,
                left: torch.Tensor, right: torch.Tensor, num_disp: int,
                zero_disp: int, usd: int) -> torch.Tensor:
    """(H, W, B + 1) u8 row spans of one IRV round: channel b < B counts
    the reliable pixels of bin b (trunc(disp) + zero_disp == b) in
    [x - LEFT, x + RIGHT], channel B every reliable pixel there.  Kernel
    B8 (csrc/irv.cu)."""
    if kernels.on_cpu(disp):
        return irv_rowspan_plain(disp, outliers, left, right, num_disp,
                                 zero_disp, usd)
    _check_planes(disp, outliers, (left, right), ("left", "right"),
                  "irv_rowspan")
    if not 0 <= usd <= 127:
        raise ValueError("irv_rowspan: u8 counts need usd <= 127")
    h, w = disp.shape
    cnt = torch.empty((h, w, num_disp + 1), dtype=torch.uint8,
                      device=disp.device)
    rc = kernels.lib("irv").stm_irv_rowspan(
        disp.data_ptr(), outliers.data_ptr(), left.data_ptr(),
        right.data_ptr(), cnt.data_ptr(), h, w, num_disp, zero_disp, usd,
        kernels.stream_of(cnt))
    kernels.check_launch(rc, "irv_rowspan")
    irv_rowspan.launches += 1
    return cnt


@kernels.kernel_wrapper
def irv_vote(cnt: torch.Tensor, disp: torch.Tensor, outliers: torch.Tensor,
             up: torch.Tensor, down: torch.Tensor, thresh_s: int,
             thresh_h: float, zero_disp: int, usd: int):
    """The vote of one IRV round from its row spans: (disp, outliers)
    after the round.  Kernel B9 (csrc/irv.cu)."""
    if kernels.on_cpu(cnt):
        return irv_vote_plain(cnt, disp, outliers, up, down, thresh_s,
                              thresh_h, zero_disp, usd)
    _check_planes(disp, outliers, (up, down), ("up", "down"), "irv_vote")
    kernels.require(cnt, "cnt", torch.uint8, 3, disp.device)
    h, w = disp.shape
    if cnt.shape[:2] != (h, w) or cnt.shape[2] < 2:
        raise ValueError("irv_vote: cnt must be (H, W, B + 1)")
    if not 0 <= usd <= 127:
        raise ValueError("irv_vote: usd must be <= 127")
    disp_out = torch.empty_like(disp)
    out_out = torch.empty_like(outliers)
    rc = kernels.lib("irv").stm_irv_vote(
        cnt.data_ptr(), disp.data_ptr(), outliers.data_ptr(), up.data_ptr(),
        down.data_ptr(), disp_out.data_ptr(), out_out.data_ptr(), h, w,
        cnt.shape[2] - 1, zero_disp, usd, thresh_s, float(f32(thresh_h)),
        kernels.stream_of(disp_out))
    kernels.check_launch(rc, "irv_vote")
    irv_vote.launches += 1
    return disp_out, out_out


def dr_irv(disp: torch.Tensor, outliers: torch.Tensor, arms: torch.Tensor,
           thresh_s: int, thresh_h: float, num_disp: int, zero_disp: int,
           usd: int, iterations: int):
    """(disp, outliers) after `iterations` synchronous voting rounds."""
    for _ in range(iterations):
        cnt = irv_rowspan(disp, outliers, arms[LEFT], arms[RIGHT], num_disp,
                          zero_disp, usd)
        disp, outliers = irv_vote(cnt, disp, outliers, arms[UP], arms[DOWN],
                                  thresh_s, thresh_h, zero_disp, usd)
    return disp, outliers
