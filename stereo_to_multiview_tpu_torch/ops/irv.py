"""Iterative region voting: kernels B8 (row spans), B9 (vote) and G3 (the
frontier between rounds), with their plain PyTorch versions.

Each round builds, for every pixel, the histogram of reliable
disparities over its cross region (vertical arms of the pixel,
horizontal arms of each covered row), separably: an inclusive row span
of the one-hot volume (`irv_rowspan`, u8 counts), then an inclusive
column span reduced to the vote (`irv_vote`).  The span volume has
B + 1 channels: one per disparity bin and a last one counting every
reliable pixel, the vote's total.  Vote rule, with the reference's quirk
of dividing the winning *disparity* (not its count): an outlier accepts
max_d iff total > thresh_s and (max_d + zero_disp) / total > thresh_h.

A round takes an optional `need` plane: only outliers at need pixels
vote, every other pixel keeps its disparity and label.  `dr_irv` runs the
fixed `iterations` rounds; `dr_irv_early_stop`, the pipeline's, hands
each round the dilated frontier of the previous round's changes as its
`need` (`irv_frontier`), which is exact: a vote can only change when a
pixel inside its cross region did.  After the first round that changes
no label the frontier is empty and every later round is the identity, at
the cost of its launches alone, so the loop queues every round without
reading the device.  With a row chunk each round streams over chunks of
rows with a halo of `usd` rows (`irv_round_chunked`), bit-equal to the
whole-frame round.

The wrappers take the plain version only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.  Arms are clamped to [0, usd] by
kernel and plain version alike (cross arms never exceed usd).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.chunks import chunk_bounds
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


TILE = 64        # rows of a vote tile (the live map's grain)


@functools.lru_cache(maxsize=None)
def _vote_staged(num_disp: int, usd: int) -> bool:
    """Whether B9 at B = num_disp bins and reach usd takes its staged
    path: the plan its launch makes (`stm_irv_vote_stages`, csrc/irv.cu),
    which depends on B and the reach alone."""
    return kernels.lib("irv").stm_irv_vote_stages(num_disp, usd) > 0


def irv_rowspan_plain(disp, outliers, left, right, num_disp: int,
                      zero_disp: int, usd: int) -> torch.Tensor:
    """Plain version of `irv_rowspan` (every span, whatever `need`): the
    one-hot volume, then a prefix-sum span along the row."""
    reliable = outliers == 0
    bins = torch.arange(num_disp, device=disp.device, dtype=torch.int32)
    onehot = reliable[:, :, None] & (disp.to(torch.int32)[:, :, None]
                                     + zero_disp == bins)
    vol = torch.cat([onehot, reliable[:, :, None]], dim=2).to(torch.int32)
    return span_sum_inclusive(vol, left.clamp(0, usd), right.clamp(0, usd),
                              axis=1).to(torch.uint8)


def irv_vote_plain(cnt, disp, outliers, up, down, thresh_s: int,
                   thresh_h: float, zero_disp: int, usd: int, need=None):
    """Plain version of `irv_vote`: a prefix-sum span along the column,
    then argmax and the vote rule, applied at need pixels only."""
    span = span_sum_inclusive(cnt.to(torch.int32), up.clamp(0, usd),
                              down.clamp(0, usd), axis=0)
    return vote_rule(span[:, :, :-1], span[:, :, -1], disp, outliers,
                     thresh_s, thresh_h, zero_disp, need)


def vote_rule(hist, total, disp, outliers, thresh_s: int, thresh_h: float,
              zero_disp: int, need=None):
    """(disp, outliers) after the vote of each pixel's (H, W, B) histogram
    (integer counts, any dtype) with its (H, W) int total of reliable
    pixels: the first-max bin, applied at need pixels only if given."""
    dint = disp.to(torch.int32)                     # trunc toward zero
    max_bin = hist.amax(dim=2)
    winner = torch.argmax(hist, dim=2).to(torch.int32)   # first max
    max_d = torch.where(max_bin > 0, winner - zero_disp, dint)
    ratio = ((max_d + zero_disp).to(torch.float32)
             / total.clamp(min=1).to(torch.float32))
    accept = (outliers != 0) & (total > thresh_s) & (ratio > f32(thresh_h))
    if need is not None:
        accept = accept & need.to(torch.bool)
    return (torch.where(accept, max_d.to(torch.float32), disp),
            torch.where(accept, 0, outliers))


def _check_planes(disp, outliers, arms, names, what, need=None):
    """Validate a round's planes; returns `need` as a u8 plane (or
    None)."""
    kernels.require(disp, "disp", torch.float32, 2, disp.device)
    kernels.require(outliers, "outliers", torch.uint8, 2, disp.device)
    for name, a in zip(names, arms):
        kernels.require(a, name, torch.int32, 2, disp.device)
    if need is not None:
        if need.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"{what}: need must be bool or uint8")
        need = need.view(torch.uint8) if need.dtype == torch.bool else need
        kernels.require(need, "need", torch.uint8, 2, disp.device)
        arms = (*arms, need)
    if any(t.shape != disp.shape for t in (outliers, *arms)):
        raise ValueError(f"{what}: plane shapes differ")
    return need


@kernels.kernel_wrapper
def irv_rowspan(disp: torch.Tensor, outliers: torch.Tensor,
                left: torch.Tensor, right: torch.Tensor, num_disp: int,
                zero_disp: int, usd: int, need=None) -> torch.Tensor:
    """(H, W, B + 1) u8 row spans of one IRV round: channel b < B counts
    the reliable pixels of bin b (trunc(disp) + zero_disp == b) in
    [x - LEFT, x + RIGHT], channel B every reliable pixel there.  With a
    `need` plane (bool or u8) the kernel computes at least the spans that
    `irv_vote` with the same `need` streams: in each column, the rows
    from the first voting row (an outlier at a need pixel) of a TILE-row
    tile minus `usd` to its last plus `usd`.  The others may be left
    undefined; that vote never reads them.
    Kernel B8 (csrc/irv.cu): a warp streams each row segment."""
    if kernels.on_cpu(disp):
        return irv_rowspan_plain(disp, outliers, left, right, num_disp,
                                 zero_disp, usd)
    need = _check_planes(disp, outliers, (left, right), ("left", "right"),
                         "irv_rowspan", need)
    if not 0 <= usd <= 127:
        raise ValueError("irv_rowspan: u8 counts need usd <= 127")
    h, w = disp.shape
    cnt = torch.empty((h, w, num_disp + 1), dtype=torch.uint8,
                      device=disp.device)
    live = None if need is None else torch.empty(
        (-(-h // TILE), w), dtype=torch.int16, device=disp.device)
    rc = kernels.lib("irv").stm_irv_rowspan(
        disp.data_ptr(), outliers.data_ptr(), left.data_ptr(),
        right.data_ptr(), None if need is None else need.data_ptr(),
        None if live is None else live.data_ptr(), cnt.data_ptr(), h, w,
        num_disp, zero_disp, usd, kernels.stream_of(cnt))
    kernels.check_launch(rc, "irv_rowspan")
    irv_rowspan.launches += 1
    return cnt


@kernels.kernel_wrapper(counters=("staged",))
def irv_vote(cnt: torch.Tensor, disp: torch.Tensor, outliers: torch.Tensor,
             up: torch.Tensor, down: torch.Tensor, thresh_s: int,
             thresh_h: float, zero_disp: int, usd: int, need=None):
    """The vote of one IRV round from its row spans: (disp, outliers)
    after the round.  With a `need` plane (bool or u8) the vote is
    applied at need pixels only; every other pixel keeps its disparity
    and label.  Kernel B9 (csrc/irv.cu): each column streams only the
    span rows within reach of a pixel that votes, brought into shared
    memory by bulk copies for a strip of columns (`irv_vote.staged` counts
    those launches) or, where no two stages fit beside the rings, by
    register loads."""
    if kernels.on_cpu(cnt):
        return irv_vote_plain(cnt, disp, outliers, up, down, thresh_s,
                              thresh_h, zero_disp, usd, need)
    need = _check_planes(disp, outliers, (up, down), ("up", "down"),
                         "irv_vote", need)
    kernels.require(cnt, "cnt", torch.uint8, 3, disp.device)
    h, w = disp.shape
    if cnt.shape[:2] != (h, w) or cnt.shape[2] < 2:
        raise ValueError("irv_vote: cnt must be (H, W, B + 1)")
    if not 0 <= usd <= 127:
        raise ValueError("irv_vote: usd must be <= 127")
    if cnt.data_ptr() % 4 or cnt.shape[2] > 1024 or h > 65535:
        raise ValueError("irv_vote: cnt must be 4-byte aligned, with at "
                         "most 1024 channels and 65535 rows")
    disp_out = torch.empty_like(disp)
    out_out = torch.empty_like(outliers)
    live = torch.empty((-(-h // TILE), w), dtype=torch.int16,
                       device=disp.device)
    rc = kernels.lib("irv").stm_irv_vote(
        cnt.data_ptr(), disp.data_ptr(), outliers.data_ptr(), up.data_ptr(),
        down.data_ptr(), None if need is None else need.data_ptr(),
        live.data_ptr(), disp_out.data_ptr(),
        out_out.data_ptr(), h, w, cnt.shape[2] - 1, zero_disp, usd,
        thresh_s, float(f32(thresh_h)), kernels.stream_of(disp_out))
    kernels.check_launch(rc, "irv_vote")
    irv_vote.launches += 1
    if _vote_staged(cnt.shape[2] - 1, usd):
        irv_vote.staged += 1
    return disp_out, out_out


def irv_round(disp, outliers, arms, thresh_s: int, thresh_h: float,
              num_disp: int, zero_disp: int, usd: int, need=None):
    """One synchronous voting round: (disp, outliers) after it."""
    cnt = irv_rowspan(disp, outliers, arms[LEFT], arms[RIGHT], num_disp,
                      zero_disp, usd, need)
    return irv_vote(cnt, disp, outliers, arms[UP], arms[DOWN], thresh_s,
                    thresh_h, zero_disp, usd, need)


def dr_irv(disp: torch.Tensor, outliers: torch.Tensor, arms: torch.Tensor,
           thresh_s: int, thresh_h: float, num_disp: int, zero_disp: int,
           usd: int, iterations: int):
    """(disp, outliers) after `iterations` synchronous voting rounds."""
    for _ in range(iterations):
        disp, outliers = irv_round(disp, outliers, arms, thresh_s, thresh_h,
                                   num_disp, zero_disp, usd)
    return disp, outliers


def dilate_frontier(changed: torch.Tensor, usd: int,
                    grain: int = 8) -> torch.Tensor:
    """Block-granular Chebyshev dilation of a change mask: every
    grain x grain block within ceil(usd / grain) + 1 blocks (either
    axis) of a block holding a changed pixel.  It covers every pixel
    whose cross region (reach usd) holds a changed pixel; the extra
    pixels only re-vote to their previous outcome."""
    h, w = changed.shape
    r = -(-usd // grain) + 1
    blocks = F.max_pool2d(changed[None, None].to(torch.float32), grain,
                          ceil_mode=True)
    blocks = F.max_pool2d(blocks, 2 * r + 1, stride=1, padding=r)
    full = blocks[0, 0].repeat_interleave(grain, 0).repeat_interleave(
        grain, 1)
    return full[:h, :w] > 0


@kernels.kernel_wrapper
def irv_frontier(before: torch.Tensor, after: torch.Tensor,
                 usd: int) -> torch.Tensor:
    """The next round's `need` from a round's (H, W) u8 labels before and
    after it: `dilate_frontier(after != before, usd)`, a bool plane (one
    byte a pixel).  Kernel G3 (csrc/irv.cu): one launch reads both planes
    and writes the plane."""
    if kernels.on_cpu(before):
        return dilate_frontier(after != before, usd)
    kernels.require(before, "before", torch.uint8, 2, before.device)
    kernels.require(after, "after", torch.uint8, 2, before.device)
    if after.shape != before.shape:
        raise ValueError("irv_frontier: plane shapes differ")
    if not 0 <= usd <= 127:
        raise ValueError("irv_frontier: usd must be in [0, 127]")
    h, w = before.shape
    need = torch.empty((h, w), dtype=torch.bool, device=before.device)
    rc = kernels.lib("irv").stm_irv_frontier(
        before.data_ptr(), after.data_ptr(), need.data_ptr(), h, w, usd,
        kernels.stream_of(need))
    kernels.check_launch(rc, "irv_frontier")
    irv_frontier.launches += 1
    return need


def irv_round_chunked(disp, outliers, arms, thresh_s: int, thresh_h: float,
                      num_disp: int, zero_disp: int, usd: int, need=None,
                      row_chunk: int = 0):
    """`irv_round` over chunks of `row_chunk` rows (0: the whole frame at
    once), which bounds the span volume.  A vote reads the rows within
    `usd` of its own, so each chunk runs with a halo of `usd` rows of the
    round's input state and keeps its own rows: bit-equal to the
    whole-frame round."""
    h = disp.shape[0]
    ext, bounds = chunk_bounds(h, row_chunk or h, usd)
    if len(bounds) == 1:
        return irv_round(disp, outliers, arms, thresh_s, thresh_h, num_disp,
                         zero_disp, usd, need)
    parts = []
    for start, lo in bounds:
        sl = slice(start, start + ext)
        d, o = irv_round(disp[sl], outliers[sl], arms[:, sl], thresh_s,
                         thresh_h, num_disp, zero_disp, usd,
                         None if need is None else need[sl])
        n_valid = min(row_chunk, h - (start + lo))
        parts.append((d[lo:lo + n_valid], o[lo:lo + n_valid]))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def dr_irv_early_stop(disp: torch.Tensor, outliers: torch.Tensor,
                      arms: torch.Tensor, thresh_s: int, thresh_h: float,
                      num_disp: int, zero_disp: int, usd: int,
                      iterations: int, rounds_run: list | None = None,
                      row_chunk: int = 0):
    """`dr_irv` with the band engine's round loop: each round after the
    first votes under the dilated frontier of the previous round's
    changes (its `need`, from `irv_frontier`).  Once a round changes no
    label (a vote only turns an outlier reliable) the frontier is empty
    and the later rounds pass their state through, so all `iterations`
    rounds are queued and nothing is read on the host.  Bit-equal to
    `dr_irv`.  `rounds_run`, if given, gets appended the rounds up to and
    including the first that changed no label, at most `iterations`: a
    device tally of the rounds that changed a label, read once after the
    last round.  With `row_chunk` every round streams over row chunks
    (`irv_round_chunked`); the frontier stays frame-wide."""
    need = None
    tally = (None if rounds_run is None else
             torch.zeros((), dtype=torch.int32, device=disp.device))
    for k in range(iterations):
        before = outliers
        disp, outliers = irv_round_chunked(
            disp, outliers, arms, thresh_s, thresh_h, num_disp, zero_disp,
            usd, need, row_chunk)
        if k + 1 == iterations:
            break
        if tally is not None:
            tally += (outliers != before).any()
        need = irv_frontier(before, outliers, usd)
    if rounds_run is not None:
        # the rounds that change a label come first: once one changes
        # none, its frontier is empty and so is every later change
        rounds_run.append(min(iterations, 1 + int(tally)))
    return disp, outliers
