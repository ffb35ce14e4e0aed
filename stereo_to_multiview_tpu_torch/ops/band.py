"""The band engine's stereo core: quantized cost, four-pass cross
aggregation (H, V, V, H) and first-min WTA, on kernels B2-B6; with
cfg.use_hslo, the scanline optimisation (kernel B13) before the WTA.
A second, complete core in the disparity-major (2D, H, W) layout runs on
kernels B16 and B18a-c (`band_stereo_core_dm`).

Every aggregate is an exact integer: the quantized cost q = rint(qscale *
cost) (u8 at the default qscale 127, int16 above 127.5: cfg.band_qscale)
is summed over half-open windows [p - arm_neg, p + arm_pos) and rescaled
after passes 1-3 by power-of-2 shifts (`agg_rescale_shifts`) that keep
each pass's input below (2^24 - 1) / (2 * usd + 1).  The TPU kernels get
these integers from bf16 digit dots on the MXU; here they are int32 sums,
bit-identical, so row chunking changes nothing.  cfg.band_digits picks
the shifts (1, 2 or 3); the lane-major kernels keep int32 volumes at
every setting, the disparity-major ones int16 (they always run at
digits=2 and qscale 127, as the JAX package's do).  cfg.band_lossy_wta
rounds each pass-4 input to bf16 before the WTA's window sums, as the
JAX package's single bf16 dot does; those sums stay exact integers too.

Wrappers take the plain version only for CPU tensors; on a CUDA tensor
they launch the kernel or raise.  Arms are clamped to [0, max_arm] by
kernel and plain version alike (cross arms never exceed usd).
"""

from __future__ import annotations

import math
import warnings

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.chunks import chunk_bounds
from stereo_to_multiview_tpu_torch.ops.costkern import (
    QSCALE, cost_dm, cost_dtype, cost_pair, pair_margin, shear_right)
from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT
from stereo_to_multiview_tpu_torch.ops.hslokern import dc_hslo_wta_lr
from stereo_to_multiview_tpu_torch.ops.irv import dr_irv_early_stop, vote_rule
from stereo_to_multiview_tpu_torch.ops.mux import f32, mux_average
from stereo_to_multiview_tpu_torch.utils.profiling import stage_scope

_HALO = 64


def _halo_for(max_arm: int) -> int:
    """Smallest 8-aligned window halo covering arms <= max_arm; the band
    engine supports max_arm (usd) <= 64."""
    if max_arm > _HALO:
        raise ValueError("band kernels require max_arm (usd) <= 64")
    return max(8, -(-max_arm // 8) * 8)


def _qmax(qscale: float) -> int:
    """Largest quantized cost value (cost <= 2.0)."""
    return int(round(2.0 * qscale))


def agg_rescale_shifts(max_arm: int, digits: int = 2,
                       qscale: float = QSCALE):
    """Power-of-2 rescale shifts (s1, s2, s3) applied after passes 1, 2
    and 3.  digits=3: inputs bounded by (2^24 - 1) / wmax; digits=2 (the
    default, as the JAX package's): below 2^15; digits=1: below 2^8.  At
    usd=34, qscale=127 they are (0, 6, 6), (0, 3, 6) at digits=3."""
    wmax = 2 * max_arm + 1
    if digits >= 3:
        bound = float((1 << 24) - 1) / wmax
    else:
        bound = 32767.0 if digits == 2 else 255.0
    v = _qmax(qscale)
    shifts = []
    for _ in range(3):
        raw = v * wmax
        s = max(0, math.ceil(math.log2(raw / bound)))
        shifts.append(s)
        v = math.floor(raw * 2.0 ** -s + 0.5)
    return tuple(shifts)


def _rescale(y: torch.Tensor, shift: int) -> torch.Tensor:
    """floor(y * 2^-shift + 0.5) for y >= 0."""
    return (y + (1 << (shift - 1))) >> shift if shift else y


def window_sum_plain(vol: torch.Tensor, arm_neg: torch.Tensor,
                     arm_pos: torch.Tensor, axis: int, max_arm: int,
                     shift: int = 0) -> torch.Tensor:
    """Plain half-open window sum of an (H, W, D) volume along axis 0 or
    1: out[p] = sum vol[max(p - an, 0) : min(p + ap, n)], arms (H, W)
    clamped to [0, max_arm], then the rescale.  int32 prefix differences
    (exact: every window sum is below 2^31)."""
    n = vol.shape[axis]
    cs = torch.cumsum(vol, dim=axis, dtype=torch.int32)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    shape = [1, 1]
    shape[axis] = n
    pos = torch.arange(n, device=vol.device).reshape(shape)
    an = arm_neg.clamp(0, max_arm)
    ap = arm_pos.clamp(0, max_arm)
    lo = (pos - an).clamp(min=0)[:, :, None].expand(vol.shape)
    hi = (pos + ap).clamp(max=n)[:, :, None].expand(vol.shape)
    return _rescale(cs.gather(axis, hi) - cs.gather(axis, lo), shift)


def h_pass_sum_plain(vol, arm_neg, arm_pos, shift: int, max_arm: int):
    return window_sum_plain(vol, arm_neg, arm_pos, 1, max_arm, shift)


def vv_pass_plain(vol, up, down, s2: int, s3: int, max_arm: int):
    a = window_sum_plain(vol, up, down, 0, max_arm, s2)
    return window_sum_plain(a, up, down, 0, max_arm, s3)


def round_bf16(vol: torch.Tensor) -> torch.Tensor:
    """Each int32 element rounded to bf16 (round to nearest, ties to even)
    and back to int32: exact integers for inputs below 2^24."""
    return vol.to(torch.float32).to(torch.bfloat16).to(torch.float32).to(
        torch.int32)


def h_pass_wta_plain(vol, arm_neg, arm_pos, zero_disp: int, max_arm: int,
                     lossy: bool = False):
    if lossy:
        vol = round_bf16(vol)
    agg = window_sum_plain(vol, arm_neg, arm_pos, 1, max_arm)
    return (torch.argmin(agg, dim=2) - zero_disp).to(torch.float32)


def _check_arms(vol, arms, names):
    for name, a in zip(names, arms):
        kernels.require(a, name, torch.int32, 2, vol.device)
        if a.shape != vol.shape[:2]:
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not "
                             f"match the volume's {tuple(vol.shape[:2])}")


@kernels.kernel_wrapper
def h_pass_sum(vol: torch.Tensor, arm_neg: torch.Tensor,
               arm_pos: torch.Tensor, shift: int,
               max_arm: int) -> torch.Tensor:
    """Horizontal window sum of an (H, W, D) volume, rescaled by `shift`,
    as (H, W, D) int32.  Pass 1 takes the u8 cost volume, or the int16
    one of band_qscale > 127.5, which may have any row stride (x stride
    D, d stride 1): kernel B4.  Pass 4 without the WTA (the volume the
    scanline optimisation reads) takes the contiguous int32 volume of the
    vertical passes: kernel B6's sum-only entry.  Both in
    csrc/hpass.cu."""
    if kernels.on_cpu(vol):
        return h_pass_sum_plain(vol, arm_neg, arm_pos, shift, max_arm)
    entry = {torch.uint8: "stm_hpass_sum_u8", torch.int16: "stm_hpass_sum_i16",
             torch.int32: "stm_hpass_sum_i32"}.get(vol.dtype)
    if entry is None:
        raise TypeError(f"h_pass_sum: dtype {vol.dtype}, expected uint8, "
                        f"int16 or int32")
    cost = vol.dtype != torch.int32
    kernels.require(vol, "vol", vol.dtype, 3, vol.device,
                    contiguous=not cost)
    h, w, nd = vol.shape
    if vol.stride(2) != 1 or vol.stride(1) != nd:
        raise ValueError("h_pass_sum: volume must have d stride 1 and "
                         "x stride D")
    _check_arms(vol, (arm_neg, arm_pos), ("arm_neg", "arm_pos"))
    out = torch.empty((h, w, nd), dtype=torch.int32, device=vol.device)
    head = (vol.data_ptr(), vol.stride(0)) if cost else (vol.data_ptr(),)
    rc = getattr(kernels.lib("hpass"), entry)(
        *head, arm_neg.data_ptr(), arm_pos.data_ptr(), out.data_ptr(), h, w,
        nd, max_arm, shift, kernels.stream_of(out))
    kernels.check_launch(rc, "h_pass_sum")
    h_pass_sum.launches += 1
    return out


# B5's launch (csrc/vpass.cu `vp_plan`): shared memory of a block and of
# an SM, the part an SM holds back for each block, the bytes of the
# stages' barriers, rows of a register batch and of a stage, stages at
# most, rows of a column's slot ring
VV_SMEM_BLOCK, VV_SMEM_SM, VV_BLOCK_RESERVED = 227 * 1024, 228 * 1024, 1024
VV_BARS, VV_STEP, VV_ROWS, VV_KMAX, VV_SLOTS = 128, 8, 16, 8, 256


def vv_plan(nd: int, reach: int, aligned: bool):
    """B5's launch at D = nd, as `vp_plan` in csrc/vpass.cu makes it:
    (K, N, TD, threads), or None where no launch fits.  K: the stages of
    the staged path, whose input rows come by tensor copies, K batches of
    VV_ROWS rows in flight; 0 for the register path.  N: the ring slots, a
    multiple of the path's batch of rows.  TD threads over d for each of
    threads // TD columns; each thread holds 2 N u32 ring slots, so long
    reaches take fewer threads.  `aligned`: D % 4 == 0 and the volume's
    base 16-byte aligned (a tensor copy's rows and strides are 16-byte
    multiples).  K is as many stages (at most VV_KMAX) as fit beside the
    rings, the barriers and the columns' slot rings in half an SM's shared
    memory (two blocks an SM), else in a whole block's, and as a slot ring
    of VV_SLOTS rows allows (the rows of K + 3 batches and both lags);
    fewer than two take the register path."""
    for staged in ((True, False) if aligned else (False,)):
        step = VV_ROWS if staged else VV_STEP
        n = -(-(2 * reach + 2) // step) * step
        per_thread = 8 * n
        t = 128
        while t > 32 and t * per_thread > VV_SMEM_BLOCK:
            t //= 2
        if t * per_thread > VV_SMEM_BLOCK:
            continue
        td = min(-(-nd // 32) * 32, t)
        threads = td * (t // td)
        if not staged:
            return 0, n, td, threads
        rings = threads * per_thread
        stage = VV_ROWS * threads * 4
        fixed = VV_BARS + threads // td * (VV_SLOTS + VV_ROWS) * 16
        k = (VV_SMEM_SM // 2 - VV_BLOCK_RESERVED - fixed - rings) // stage
        if k < 2:
            k = (VV_SMEM_BLOCK - fixed - rings) // stage
        k = min(k, VV_KMAX, (VV_SLOTS - 2 * reach) // VV_ROWS - 3)
        if k >= 2:
            return k, n, td, threads
    return None


def vv_stages(nd: int, reach: int, aligned: bool) -> int:
    """The stages K of B5's staged path at D = nd (`vv_plan`), 0 where it
    takes its register path, -1 where no launch fits: the path
    `vv_pass.staged` counts.  Mirrors `stm_vv_stages` in csrc/vpass.cu."""
    plan = vv_plan(nd, reach, aligned)
    return -1 if plan is None else plan[0]


@kernels.kernel_wrapper(counters=("staged",))
def vv_pass(vol: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
            s2: int, s3: int, max_arm: int) -> torch.Tensor:
    """Passes 2 and 3: two vertical window sums of an (H, W, D) int32
    volume over [y - UP, y + DOWN), rescaled by s2 then s3.  Kernel B5
    (csrc/vpass.cu), one launch: each column streams down the frame once
    through two prefix rings, its input rows brought into shared memory by
    tensor copies (`vv_pass.staged` counts those launches: `vv_stages`)
    or, where the rows or the reach do not allow them, by register loads."""
    if kernels.on_cpu(vol):
        return vv_pass_plain(vol, up, down, s2, s3, max_arm)
    kernels.require(vol, "vol", torch.int32, 3, vol.device)
    _check_arms(vol, (up, down), ("up", "down"))
    h, w, nd = vol.shape
    if nd > 1024 or h > 65535:
        raise ValueError("vv_pass: the kernel takes D <= 1024 and H <= "
                         "65535")
    out = torch.empty_like(vol)
    rc = kernels.lib("vpass").stm_vv_pass(
        vol.data_ptr(), up.data_ptr(), down.data_ptr(), out.data_ptr(), h,
        w, nd, max_arm, s2, s3, kernels.stream_of(out))
    kernels.check_launch(rc, "vv_pass")
    vv_pass.launches += 1
    if vv_stages(nd, max_arm, nd % 4 == 0 and vol.data_ptr() % 16 == 0) > 0:
        vv_pass.staged += 1
    return out


@kernels.kernel_wrapper
def h_pass_wta(vol: torch.Tensor, arm_neg: torch.Tensor,
               arm_pos: torch.Tensor, zero_disp: int, max_arm: int,
               lossy: bool = False) -> torch.Tensor:
    """Pass 4 + WTA: horizontal window sum of an (H, W, D) int32 volume,
    then the first-min argmin over D; returns (H, W) float32
    disparities argmin - zero_disp.  `lossy` (band_lossy_wta) rounds each
    element to bf16 first (`round_bf16`).  Kernel B6 (csrc/hpass.cu)."""
    if kernels.on_cpu(vol):
        return h_pass_wta_plain(vol, arm_neg, arm_pos, zero_disp, max_arm,
                                lossy)
    kernels.require(vol, "vol", torch.int32, 3, vol.device)
    _check_arms(vol, (arm_neg, arm_pos), ("arm_neg", "arm_pos"))
    h, w, nd = vol.shape
    disp = torch.empty((h, w), dtype=torch.float32, device=vol.device)
    rc = kernels.lib("hpass").stm_hpass_wta_i32(
        vol.data_ptr(), arm_neg.data_ptr(), arm_pos.data_ptr(),
        disp.data_ptr(), h, w, nd, max_arm, zero_disp, int(lossy),
        kernels.stream_of(disp))
    kernels.check_launch(rc, "h_pass_wta")
    h_pass_wta.launches += 1
    return disp


def band_aggregate_q(cost_q: torch.Tensor, arms: torch.Tensor, max_arm: int,
                     zero_disp: int | None = None, digits: int = 2,
                     qscale: float = QSCALE,
                     lossy_wta: bool = False) -> torch.Tensor:
    """Four-pass cross aggregation (H, V, V, H) of an (H, W, D) quantized
    cost volume (u8, or int16 at qscale > 127.5: `quantize_cost`) with
    arms (4, H, W) int32; `qscale` fixes the rescale shifts.  With
    zero_disp the first-min WTA is fused into pass 4 and the (H, W)
    float32 disparities are returned, each pass-4 input rounded to bf16
    first with `lossy_wta`; with zero_disp None, the (H, W, D) int32
    aggregated volume (exact integers at `agg_cost_scale` of the cost's
    unit; `lossy_wta` is then ignored, as in the JAX package)."""
    if digits not in (1, 2, 3):
        raise ValueError("band_digits must be 1, 2 or 3")
    _halo_for(max_arm)
    s1, s2, s3 = agg_rescale_shifts(max_arm, digits, qscale)
    a = h_pass_sum(cost_q, arms[LEFT], arms[RIGHT], s1, max_arm)
    a = vv_pass(a, arms[UP], arms[DOWN], s2, s3, max_arm)
    if zero_disp is None:
        return h_pass_sum(a, arms[LEFT], arms[RIGHT], 0, max_arm)
    return h_pass_wta(a, arms[LEFT], arms[RIGHT], zero_disp, max_arm,
                      lossy_wta)


def agg_cost_scale(max_arm: int, digits: int = 2,
                   qscale: float = QSCALE) -> float:
    """Cost-unit scale of the quantized aggregate: `band_aggregate_q`'s
    volume is about the float aggregate * qscale / 2^(s1+s2+s3).  Terms
    added to that volume (the scanline optimisation's penalties) are
    multiplied by it to keep their strength."""
    s1, s2, s3 = agg_rescale_shifts(max_arm, digits, qscale)
    return qscale / float(2 ** (s1 + s2 + s3))


def quantize_cost(cost: torch.Tensor, qscale: float = QSCALE) -> torch.Tensor:
    """A float32 cost volume (values in [0, 2]) -> rint(cost * qscale), the
    quantized engine's one lossy step: u8 for qscale <= 127.5 (the JAX
    package stores the same integers as bf16), int16 above (the
    band_qscale dial; qscale <= 16383, as `cost_dtype`)."""
    cost_dtype(qscale)
    q = torch.round(cost.to(torch.float32) * f32(qscale)).to(torch.int32)
    return q.to(torch.uint8 if qscale <= 127.5 else torch.int16)


def cross_aggregate_band(cost_hwd: torch.Tensor, arms: torch.Tensor,
                         nsplit: int = 2, max_arm: int = _HALO):
    """Quantized four-pass cross aggregation of an (H, W, D) float32 cost
    volume: `quantize_cost`, then `band_aggregate_q` at its defaults
    (digits=2); returns the (H, W, D) int32 aggregated volume.  `nsplit`
    is deprecated and ignored, as in the JAX package: a value other than 2
    warns."""
    if nsplit != 2:
        warnings.warn(
            "cross_aggregate_band(nsplit=...) is deprecated and ignored: "
            "the aggregation is exact quantized-integer; output scale is "
            "QSCALE / 2^(s2+s3)", DeprecationWarning, stacklevel=2)
    return band_aggregate_q(quantize_cost(cost_hwd), arms, max_arm)


def cross_aggregate_band_lr(cost_l, cost_r, arms_l, arms_r, nsplit: int = 2):
    """`cross_aggregate_band` of both eyes stacked along H (arms stop at
    their own image's border, so no window crosses the eye boundary);
    returns (agg_l, agg_r)."""
    h = cost_l.shape[0]
    a = cross_aggregate_band(torch.cat([cost_l, cost_r]),
                             torch.cat([arms_l, arms_r], dim=1), nsplit)
    return a[:h], a[h:]


def band_stereo_core_chunked(img_l, img_r, arms_l, arms_r, cfg):
    """Cost init + 4-pass quantized aggregation + WTA for both eyes, over
    row chunks of cfg.band_row_chunk output rows (0 = whole frame).  Each
    chunk recomputes a halo of 2*usd rows (the reach of the two V
    passes); B2 takes the whole frame's images and the chunk's rows and
    computes the census itself, clamped at the frame's edges only, so it
    is the whole frame's.  Exact integer aggregation makes the result
    independent of the chunking.

    cfg.use_hslo puts the horizontal scanline optimisation (kernel B13,
    both eyes of a chunk in one launch, inside the span `dc_hslo`)
    between the aggregation and the WTA, its penalties scaled into the
    aggregate's cost units; rows are independent in it, so chunking
    stays exact.  cfg.band_qscale sets the cost's scale (int16 costs
    above 127.5) and the shifts; cfg.band_lossy_wta rounds the WTA's
    inputs to bf16 (not read under use_hslo, as in the JAX package).
    Returns (disp_l, disp_r) float32 (H, W)."""
    h, w = img_l.shape[:2]
    usd = cfg.usd
    if usd > _HALO:
        raise ValueError("band engine requires usd <= 64")
    nd, zd = cfg.num_disp, cfg.zero_disp
    chunk = cfg.band_row_chunk or h
    ext, bounds = chunk_bounds(h, chunk, 2 * usd)
    margin = pair_margin(nd, zd)
    if cfg.use_hslo:
        gray_l, gray_r = mux_average(img_l), mux_average(img_r)
        kappa = agg_cost_scale(usd, cfg.band_digits, cfg.band_qscale)

    parts_l, parts_r = [], []
    for start, lo in bounds:
        sl = slice(start, start + ext)
        pair = cost_pair(img_l, img_r, cfg.ad_coeff, cfg.census_coeff, nd,
                         zd, cfg.band_qscale, rows=(start, ext))
        cost_l = pair[:, margin:margin + w]
        cost_r = shear_right(pair, zd)
        n_valid = min(chunk, h - (start + lo))
        if cfg.use_hslo:
            vols = [band_aggregate_q(cost, arms[:, sl], usd, None,
                                     cfg.band_digits, cfg.band_qscale)
                    for cost, arms in ((cost_l, arms_l), (cost_r, arms_r))]
            del pair, cost_l, cost_r
            with stage_scope("dc_hslo"):
                disps = dc_hslo_wta_lr(*vols, gray_l[sl], gray_r[sl], nd,
                                       zd, cfg.hslo_T, cfg.hslo_H1 * kappa,
                                       cfg.hslo_H2 * kappa)
            del vols
        else:
            disps = [band_aggregate_q(cost, arms[:, sl], usd, zd,
                                      cfg.band_digits, cfg.band_qscale,
                                      cfg.band_lossy_wta)
                     for cost, arms in ((cost_l, arms_l), (cost_r, arms_r))]
        for disp, parts in zip(disps, (parts_l, parts_r)):
            parts.append(disp[lo:lo + n_valid])
    if len(parts_l) == 1:
        return parts_l[0], parts_r[0]
    return torch.cat(parts_l, dim=0), torch.cat(parts_r, dim=0)


# ---- the disparity-major core: (2D, H, W), int16 between the passes -----
#
# Left eye on planes [0, D), right eye on [D, 2D); each eye's windows come
# from its own arms.  The shifts are those of digits=2 whatever the config
# says (the JAX package's `band_aggregate_q_dm` does the same), so pass 1
# is not rescaled and every stored value stays below 2^15.

def _span_dm(vol, arm_neg, arm_pos, axis: int, max_arm: int):
    """int32 half-open window sums of one eye's (D, H, W) planes along
    axis 1 (rows) or 2 (columns), arms (H, W) clamped to [0, max_arm]."""
    n = vol.shape[axis]
    cs = torch.cumsum(vol, dim=axis, dtype=torch.int32)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    pos = torch.arange(n, device=vol.device)
    pos = pos[:, None] if axis == 1 else pos[None, :]
    lo = (pos - arm_neg.clamp(0, max_arm)).clamp(min=0)
    hi = (pos + arm_pos.clamp(0, max_arm)).clamp(max=n)
    return (cs.gather(axis, hi.expand(vol.shape))
            - cs.gather(axis, lo.expand(vol.shape)))


def _eyes(vol, arms_l, arms_r):
    """((D, H, W) planes, arms) of the left and the right eye."""
    nd = vol.shape[0] // 2
    return (vol[:nd], arms_l), (vol[nd:], arms_r)


def pass1_dm_plain(vol, arms_l, arms_r, max_arm: int) -> torch.Tensor:
    """Plain version of `pass1_dm`, an eye at a time."""
    return torch.cat([
        _span_dm(v, a[LEFT], a[RIGHT], 2, max_arm).to(torch.int16)
        for v, a in _eyes(vol, arms_l, arms_r)])


def vv_dm_plain(vol, arms_l, arms_r, s2: int, s3: int,
                max_arm: int) -> torch.Tensor:
    """Plain version of `vv_dm`, an eye at a time, int16 after each
    rescale."""
    out = []
    for v, a in _eyes(vol, arms_l, arms_r):
        for shift in (s2, s3):
            v = _rescale(_span_dm(v, a[UP], a[DOWN], 1, max_arm),
                         shift).to(torch.int16)
        out.append(v)
    return torch.cat(out)


def pass4_wta_dm_plain(vol, arms_l, arms_r, zero_disp: int, max_arm: int):
    """Plain version of `pass4_wta_dm`: the int32 sums of an eye, then
    torch.argmin over d (the first minimum)."""
    return tuple(
        (torch.argmin(_span_dm(v, a[LEFT], a[RIGHT], 2, max_arm), dim=0)
         - zero_disp).to(torch.float32)
        for v, a in _eyes(vol, arms_l, arms_r))


def _check_dm(what, vol, dtype, arms_l, arms_r, max_arm):
    kernels.require(vol, "vol", dtype, 3, vol.device)
    if vol.shape[0] % 2:
        raise ValueError(f"{what}: the volume must hold both eyes, (2D, H, "
                         f"W)")
    for name, a in (("arms_l", arms_l), ("arms_r", arms_r)):
        kernels.require(a, name, torch.int32, 3, vol.device,
                        contiguous=False)     # a row chunk's slice
        if a.shape != (4, *vol.shape[1:]):
            raise ValueError(f"{what}: {name} {tuple(a.shape)} does not "
                             f"match the volume's rows and columns")
    _halo_for(max_arm)
    return vol.shape[0] // 2, vol.shape[1], vol.shape[2]


def _arm_planes(arms_l, arms_r, neg: int, pos: int):
    """The four contiguous (H, W) arm planes of a pass, in the C entry
    points' order."""
    return [a.contiguous() for a in (arms_l[neg], arms_l[pos], arms_r[neg],
                                     arms_r[pos])]


@kernels.kernel_wrapper
def pass1_dm(vol: torch.Tensor, arms_l: torch.Tensor, arms_r: torch.Tensor,
             max_arm: int) -> torch.Tensor:
    """Pass 1 of both eyes: sums of a (2D, H, W) u8 cost volume over
    [x - LEFT, x + RIGHT) as (2D, H, W) int16, arms (4, H, W) int32 per
    eye.  Kernel B18a (csrc/band_dm.cu)."""
    if kernels.on_cpu(vol):
        return pass1_dm_plain(vol, arms_l, arms_r, max_arm)
    nd, h, w = _check_dm("pass1_dm", vol, torch.uint8, arms_l, arms_r,
                         max_arm)
    planes = _arm_planes(arms_l, arms_r, LEFT, RIGHT)
    out = torch.empty(vol.shape, dtype=torch.int16, device=vol.device)
    rc = kernels.lib("band_dm").stm_pass1_dm(
        vol.data_ptr(), *(a.data_ptr() for a in planes), out.data_ptr(), h, w, nd, max_arm,
        kernels.stream_of(out))
    kernels.check_launch(rc, "pass1_dm")
    pass1_dm.launches += 1
    return out


@kernels.kernel_wrapper
def vv_dm(vol: torch.Tensor, arms_l: torch.Tensor, arms_r: torch.Tensor,
          s2: int, s3: int, max_arm: int) -> torch.Tensor:
    """Passes 2 and 3 of both eyes: two sums of a (2D, H, W) int16 volume
    over [y - UP, y + DOWN), rescaled by s2 then s3, as int16.  Kernel
    B18b (csrc/vvdm.cu), one launch."""
    if kernels.on_cpu(vol):
        return vv_dm_plain(vol, arms_l, arms_r, s2, s3, max_arm)
    nd, h, w = _check_dm("vv_dm", vol, torch.int16, arms_l, arms_r, max_arm)
    planes = _arm_planes(arms_l, arms_r, UP, DOWN)
    out = torch.empty_like(vol)
    rc = kernels.lib("vvdm").stm_vv_dm(
        vol.data_ptr(), *(a.data_ptr() for a in planes), out.data_ptr(), h,
        w, nd, max_arm, s2, s3, kernels.stream_of(out))
    kernels.check_launch(rc, "vv_dm")
    vv_dm.launches += 1
    return out


@kernels.kernel_wrapper
def pass4_wta_dm(vol: torch.Tensor, arms_l: torch.Tensor,
                 arms_r: torch.Tensor, zero_disp: int, max_arm: int):
    """Pass 4 + WTA of both eyes: the horizontal sums of a (2D, H, W)
    int16 volume, then each eye's first-min argmin over d; returns
    (disp_l, disp_r) (H, W) float32, argmin - zero_disp.  Kernel B18c
    (csrc/band_dm.cu)."""
    if kernels.on_cpu(vol):
        return pass4_wta_dm_plain(vol, arms_l, arms_r, zero_disp, max_arm)
    nd, h, w = _check_dm("pass4_wta_dm", vol, torch.int16, arms_l, arms_r,
                         max_arm)
    planes = _arm_planes(arms_l, arms_r, LEFT, RIGHT)
    disp_l = torch.empty((h, w), dtype=torch.float32, device=vol.device)
    disp_r = torch.empty_like(disp_l)
    rc = kernels.lib("band_dm").stm_pass4_wta_dm(
        vol.data_ptr(), *(a.data_ptr() for a in planes), disp_l.data_ptr(), disp_r.data_ptr(), h, w,
        nd, max_arm, zero_disp, kernels.stream_of(disp_l))
    kernels.check_launch(rc, "pass4_wta_dm")
    pass4_wta_dm.launches += 1
    return disp_l, disp_r


def band_aggregate_q_dm(cost2: torch.Tensor, arms_l: torch.Tensor,
                        arms_r: torch.Tensor, *, num_disp: int,
                        zero_disp: int, max_arm: int):
    """Four-pass cross aggregation + first-min WTA of a (2D, H, W) u8
    cost volume (`cost_dm`), arms (4, H, W) int32 per eye.  Returns
    (disp_l, disp_r) (H, W) float32, equal to `band_aggregate_q` at
    digits=2 on each eye's (H, W, D) volume."""
    if cost2.shape[0] != 2 * num_disp:
        raise ValueError("band_aggregate_q_dm: cost2 must be (2 * num_disp, "
                         "H, W)")
    _, s2, s3 = agg_rescale_shifts(max_arm, 2)
    a = pass1_dm(cost2, arms_l, arms_r, max_arm)
    a = vv_dm(a, arms_l, arms_r, s2, s3, max_arm)
    return pass4_wta_dm(a, arms_l, arms_r, zero_disp, max_arm)


def band_stereo_core_dm(img_l, img_r, arms_l, arms_r, cfg):
    """The stereo core in the disparity-major layout: the stacked cost
    (kernel B16, on the chunk's row range of the whole frame: its census
    is the whole frame's) and `band_aggregate_q_dm` (B18a-c) over row
    chunks of cfg.band_row_chunk output rows with a halo of 2*usd rows.
    No (H, W, D) volume, pair volume or shear exists.  It aggregates u8
    costs at digits=2 whatever cfg.band_digits and cfg.band_qscale say,
    as the JAX package's does, and equals
    `band_stereo_core_chunked` at band_digits=2 and the default qscale;
    cfg.use_hslo and cfg.band_lossy_wta are not read.  Returns (disp_l,
    disp_r) float32 (H, W)."""
    h = img_l.shape[0]
    usd = cfg.usd
    if usd > _HALO:
        raise ValueError("band engine requires usd <= 64")
    chunk = cfg.band_row_chunk or h
    ext, bounds = chunk_bounds(h, chunk, 2 * usd)
    parts_l, parts_r = [], []
    for start, lo in bounds:
        sl = slice(start, start + ext)
        cost2 = cost_dm(img_l, img_r, cfg.ad_coeff, cfg.census_coeff,
                        cfg.num_disp, cfg.zero_disp, rows=(start, ext))
        dl, dr = band_aggregate_q_dm(
            cost2, arms_l[:, sl], arms_r[:, sl], num_disp=cfg.num_disp,
            zero_disp=cfg.zero_disp, max_arm=usd)
        n_valid = min(chunk, h - (start + lo))
        parts_l.append(dl[lo:lo + n_valid])
        parts_r.append(dr[lo:lo + n_valid])
    if len(parts_l) == 1:
        return parts_l[0], parts_r[0]
    return torch.cat(parts_l, dim=0), torch.cat(parts_r, dim=0)


# ---- B15: window sums of a float volume, in bf16 terms --------------------

def split_bf16_terms(vol: torch.Tensor, nsplit: int) -> torch.Tensor:
    """The float32 recombination of each element's `nsplit` successive
    bf16 remainders: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
    mid), summed (hi + mid) + lo (round to nearest even, each add rounded
    on its own).  nsplit=1 rounds the volume to bf16."""
    r = vol.to(torch.float32)
    part = r.to(torch.bfloat16).to(torch.float32)
    t = part
    for _ in range(nsplit - 1):
        r = r - part
        part = r.to(torch.bfloat16).to(torch.float32)
        t = t + part
    return t


def span_sum_float_plain(vol: torch.Tensor, arm_neg: torch.Tensor,
                         arm_pos: torch.Tensor, axis: int, inclusive: bool,
                         nsplit: int, max_arm: int) -> torch.Tensor:
    """Plain version of `band_span_sum_h` (axis 1) and `band_span_sum_v`
    (axis 0): the `split_bf16_terms` volume summed over each window in
    float32, one shifted plane per offset in ascending order (positions
    outside the window or the axis add +0.0, which changes no sum)."""
    t = split_bf16_terms(vol, nsplit)
    n = t.shape[axis]
    an = arm_neg.clamp(0, max_arm)[:, :, None]
    ap = arm_pos.clamp(0, max_arm)[:, :, None] + int(inclusive)
    pad = [0, 0] * (3 - axis)
    pad[-2:] = [max_arm, max_arm + 1]
    tp = torch.nn.functional.pad(t, pad)
    acc = torch.zeros_like(t)
    for k in range(-max_arm, max_arm + int(inclusive)):
        keep = (k >= -an) & (k < ap)
        acc = acc + torch.where(keep, tp.narrow(axis, max_arm + k, n), 0.0)
    return acc


def _span_sum(fn, vol, arm_neg, arm_pos, axis, inclusive, nsplit, max_arm):
    """`band_span_sum_h` (axis 1) or `_v` (axis 0), `fn` the wrapper whose
    launches count."""
    _halo_for(max_arm)
    if nsplit not in (1, 2, 3):
        raise ValueError("nsplit must be 1, 2 or 3")
    if kernels.on_cpu(vol):
        return span_sum_float_plain(vol, arm_neg, arm_pos, axis, inclusive,
                                    nsplit, max_arm)
    kernels.require(vol, "vol", torch.float32, 3, vol.device)
    _check_arms(vol, (arm_neg, arm_pos), ("arm_neg", "arm_pos"))
    h, w, nd = vol.shape
    out = torch.empty_like(vol)
    rc = kernels.lib("span").stm_span_sum(
        vol.data_ptr(), arm_neg.data_ptr(), arm_pos.data_ptr(),
        out.data_ptr(), h, w, nd, axis, max_arm, int(inclusive), nsplit,
        kernels.stream_of(out))
    kernels.check_launch(rc, fn.__name__)
    fn.launches += 1
    return out


@kernels.kernel_wrapper
def band_span_sum_h(vol: torch.Tensor, arm_neg: torch.Tensor,
                    arm_pos: torch.Tensor, inclusive: bool = False,
                    nsplit: int = 2, max_arm: int = _HALO) -> torch.Tensor:
    """Window sum along axis 1 of an (H, W, D) float32 volume over [x -
    arm_neg, x + arm_pos) (`inclusive` closes the right end), ends clamped
    into the row, arms (H, W) int32 clamped to [0, max_arm <= 64]; each
    element counts as its `nsplit` bf16 terms (1: exact for small-integer
    volumes).  Kernel B15 (csrc/span.cu)."""
    return _span_sum(band_span_sum_h, vol, arm_neg, arm_pos, 1, inclusive,
                     nsplit, max_arm)


@kernels.kernel_wrapper
def band_span_sum_v(vol: torch.Tensor, arm_neg: torch.Tensor,
                    arm_pos: torch.Tensor, inclusive: bool = False,
                    nsplit: int = 2, max_arm: int = _HALO) -> torch.Tensor:
    """`band_span_sum_h` along axis 0 (windows [y - arm_neg, y +
    arm_pos)), natively on the (H, W, D) volume.  Kernel B15
    (csrc/span.cu)."""
    return _span_sum(band_span_sum_v, vol, arm_neg, arm_pos, 0, inclusive,
                     nsplit, max_arm)


def irv_onehot(disp: torch.Tensor, outliers: torch.Tensor, num_disp: int,
               zero_disp: int) -> torch.Tensor:
    """(H, W, num_disp) float32 one-hot of each reliable pixel's truncated
    disp + zero_disp: the volume whose window sums are the IRV histogram."""
    bins = torch.arange(num_disp, dtype=torch.int32, device=disp.device)
    dint = disp.to(torch.int32)                     # trunc toward zero
    return ((outliers == 0)[:, :, None]
            & (dint[:, :, None] + zero_disp == bins)).to(torch.float32)


def dr_irv_band(disp: torch.Tensor, outliers: torch.Tensor,
                arms: torch.Tensor, thresh_s: int, thresh_h: float,
                num_disp: int, zero_disp: int, usd: int, iterations: int):
    """Iterative region voting with the histogram as two span sums of the
    float32 one-hot volume (B15, inclusive, nsplit=1: exact counts): a row
    pass over [x - LEFT, x + RIGHT], a column pass over [y - min(UP, usd),
    y + DOWN]; the first-max vote of `irv.vote_rule`.  `iterations` fixed
    rounds, no early stop.  Equals `irv.dr_irv`."""
    if usd > _HALO:
        raise ValueError("dr_irv_band requires usd <= 64 (256-wide kernel "
                         "windows); use ops.irv.dr_irv for larger arms")
    up = arms[UP].clamp(max=usd).contiguous()
    down, left, right = (arms[i].contiguous() for i in (DOWN, LEFT, RIGHT))
    for _ in range(iterations):
        onehot = irv_onehot(disp, outliers, num_disp, zero_disp)
        row = band_span_sum_h(onehot, left, right, True, 1, usd)
        del onehot
        hist = band_span_sum_v(row, up, down, True, 1, usd)
        del row
        total = hist.sum(dim=2).to(torch.int32)
        disp, outliers = vote_rule(hist, total, disp, outliers, thresh_s,
                                   thresh_h, zero_disp)
        del hist
    return disp, outliers


def dr_irv_band_lr(disp_l, outl_l, disp_r, outl_r, arms_l, arms_r,
                   thresh_s: int, thresh_h: float, num_disp: int,
                   zero_disp: int, usd: int, iterations: int):
    """`dr_irv_band` of both eyes stacked along H (arms stop at their own
    image's border, so no window crosses the eye boundary); returns
    ((disp_l, outl_l), (disp_r, outl_r))."""
    h = disp_l.shape[0]
    d, o = dr_irv_band(torch.cat([disp_l, disp_r]),
                       torch.cat([outl_l, outl_r]),
                       torch.cat([arms_l, arms_r], dim=1), thresh_s,
                       thresh_h, num_disp, zero_disp, usd, iterations)
    return (d[:h], o[:h]), (d[h:], o[h:])


def dr_irv_band_chunked(disp_l, outl_l, disp_r, outl_r, arms_l, arms_r,
                        cfg, interpret: bool = False):
    """The JAX package's IRV of the band engine under its entry name:
    cfg.irv_iterations rounds of B8 and B9 over row chunks of
    cfg.irv_row_chunk rows, each after the first under the frontier of
    the previous round's changes (`ops.irv.dr_irv_early_stop`, one eye at
    a time: the JAX entry stacks the eyes along H, which no vote window
    crosses).  Returns ((disp_l, outl_l), (disp_r, outl_r)); `interpret`
    has no effect."""
    return tuple(
        dr_irv_early_stop(d, o, a, cfg.irv_thresh_s, cfg.irv_thresh_h,
                          cfg.num_disp, cfg.zero_disp, cfg.usd,
                          cfg.irv_iterations, row_chunk=cfg.irv_row_chunk)
        for d, o, a in ((disp_l, outl_l, arms_l), (disp_r, outl_r, arms_r)))
