"""The band engine's stereo core: quantized cost, four-pass cross
aggregation (H, V, V, H) and first-min WTA, on kernels B2-B6; with
cfg.use_hslo, the scanline optimisation (kernel B13) before the WTA.

Every aggregate is an exact integer: the u8 cost q = rint(127 * cost) is
summed over half-open windows [p - arm_neg, p + arm_pos) and rescaled
after passes 1-3 by power-of-2 shifts (`agg_rescale_shifts`) that keep
each pass's input below (2^24 - 1) / (2 * usd + 1).  The TPU kernels get
these integers from bf16 digit dots on the MXU; here they are int32 sums,
bit-identical, so row chunking changes nothing.

Wrappers take the plain version only for CPU tensors; on a CUDA tensor
they launch the kernel or raise.  Arms are clamped to [0, max_arm] by
kernel and plain version alike (cross arms never exceed usd).
"""

from __future__ import annotations

import math

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.cost import census_transform_9x7
from stereo_to_multiview_tpu_torch.ops.costkern import (
    cost_pair, device_cost_table, pair_margin, shear_right)
from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT
from stereo_to_multiview_tpu_torch.ops.hslokern import dc_hslo_wta
from stereo_to_multiview_tpu_torch.ops.mux import mux_average

QSCALE = 127.0
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


def agg_rescale_shifts(max_arm: int, digits: int = 3,
                       qscale: float = QSCALE):
    """Power-of-2 rescale shifts (s1, s2, s3) applied after passes 1, 2
    and 3.  digits=3: inputs bounded by (2^24 - 1) / wmax; digits=2:
    below 2^15; digits=1: below 2^8.  At usd=34, qscale=127, digits=3
    they are (0, 3, 6)."""
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


def h_pass_wta_plain(vol, arm_neg, arm_pos, zero_disp: int, max_arm: int):
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
    as (H, W, D) int32.  Pass 1 takes the u8 cost volume, which may have
    any row stride (x stride D, d stride 1): kernel B4.  Pass 4 without
    the WTA (the volume the scanline optimisation reads) takes the
    contiguous int32 volume of the vertical passes: kernel B6's sum-only
    entry.  Both in csrc/hpass.cu."""
    if kernels.on_cpu(vol):
        return h_pass_sum_plain(vol, arm_neg, arm_pos, shift, max_arm)
    if vol.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"h_pass_sum: dtype {vol.dtype}, expected uint8 or "
                        f"int32")
    u8 = vol.dtype == torch.uint8
    kernels.require(vol, "vol", vol.dtype, 3, vol.device, contiguous=not u8)
    h, w, nd = vol.shape
    if vol.stride(2) != 1 or vol.stride(1) != nd:
        raise ValueError("h_pass_sum: volume must have d stride 1 and "
                         "x stride D")
    _check_arms(vol, (arm_neg, arm_pos), ("arm_neg", "arm_pos"))
    out = torch.empty((h, w, nd), dtype=torch.int32, device=vol.device)
    tail = (arm_neg.data_ptr(), arm_pos.data_ptr(), out.data_ptr(), h, w, nd,
            max_arm, shift, kernels.stream_of(out))
    if u8:
        rc = kernels.lib("hpass").stm_hpass_sum_u8(
            vol.data_ptr(), vol.stride(0), *tail)
    else:
        rc = kernels.lib("hpass").stm_hpass_sum_i32(vol.data_ptr(), *tail)
    kernels.check_launch(rc, "h_pass_sum")
    h_pass_sum.launches += 1
    return out


@kernels.kernel_wrapper
def vv_pass(vol: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
            s2: int, s3: int, max_arm: int) -> torch.Tensor:
    """Passes 2 and 3: two vertical window sums of an (H, W, D) int32
    volume over [y - UP, y + DOWN), rescaled by s2 then s3.  Kernel B5
    (csrc/vpass.cu), launched twice with an int32 scratch between."""
    if kernels.on_cpu(vol):
        return vv_pass_plain(vol, up, down, s2, s3, max_arm)
    kernels.require(vol, "vol", torch.int32, 3, vol.device)
    _check_arms(vol, (up, down), ("up", "down"))
    h, w, nd = vol.shape
    scratch = torch.empty_like(vol)
    out = torch.empty_like(vol)
    rc = kernels.lib("vpass").stm_vv_pass(
        vol.data_ptr(), up.data_ptr(), down.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), h, w, nd, max_arm, s2, s3, kernels.stream_of(out))
    kernels.check_launch(rc, "vv_pass")
    vv_pass.launches += 2
    return out


@kernels.kernel_wrapper
def h_pass_wta(vol: torch.Tensor, arm_neg: torch.Tensor,
               arm_pos: torch.Tensor, zero_disp: int,
               max_arm: int) -> torch.Tensor:
    """Pass 4 + WTA: horizontal window sum of an (H, W, D) int32 volume,
    then the first-min argmin over D; returns (H, W) float32
    disparities argmin - zero_disp.  Kernel B6 (csrc/hpass.cu)."""
    if kernels.on_cpu(vol):
        return h_pass_wta_plain(vol, arm_neg, arm_pos, zero_disp, max_arm)
    kernels.require(vol, "vol", torch.int32, 3, vol.device)
    _check_arms(vol, (arm_neg, arm_pos), ("arm_neg", "arm_pos"))
    h, w, nd = vol.shape
    disp = torch.empty((h, w), dtype=torch.float32, device=vol.device)
    rc = kernels.lib("hpass").stm_hpass_wta_i32(
        vol.data_ptr(), arm_neg.data_ptr(), arm_pos.data_ptr(),
        disp.data_ptr(), h, w, nd, max_arm, zero_disp,
        kernels.stream_of(disp))
    kernels.check_launch(rc, "h_pass_wta")
    h_pass_wta.launches += 1
    return disp


def band_aggregate_q(cost_q: torch.Tensor, arms: torch.Tensor, max_arm: int,
                     zero_disp: int | None = None, digits: int = 3,
                     qscale: float = QSCALE) -> torch.Tensor:
    """Four-pass cross aggregation (H, V, V, H) of an (H, W, D) u8
    quantized cost volume with arms (4, H, W) int32.  With zero_disp the
    first-min WTA is fused into pass 4 and the (H, W) float32
    disparities are returned; with zero_disp None, the (H, W, D) int32
    aggregated volume (exact integers at `agg_cost_scale` of the cost's
    unit)."""
    if digits != 3 or qscale != QSCALE:
        raise NotImplementedError(
            "band_digits != 3 / band_qscale != 127 are ROADMAP queue A "
            "item 14 (dials), not ported yet")
    _halo_for(max_arm)
    s1, s2, s3 = agg_rescale_shifts(max_arm, digits, qscale)
    a = h_pass_sum(cost_q, arms[LEFT], arms[RIGHT], s1, max_arm)
    a = vv_pass(a, arms[UP], arms[DOWN], s2, s3, max_arm)
    if zero_disp is None:
        return h_pass_sum(a, arms[LEFT], arms[RIGHT], 0, max_arm)
    return h_pass_wta(a, arms[LEFT], arms[RIGHT], zero_disp, max_arm)


def agg_cost_scale(max_arm: int, digits: int = 3,
                   qscale: float = QSCALE) -> float:
    """Cost-unit scale of the quantized aggregate: `band_aggregate_q`'s
    volume is about the float aggregate * qscale / 2^(s1+s2+s3).  Terms
    added to that volume (the scanline optimisation's penalties) are
    multiplied by it to keep their strength."""
    s1, s2, s3 = agg_rescale_shifts(max_arm, digits, qscale)
    return qscale / float(2 ** (s1 + s2 + s3))


def _chunk_bounds(h: int, chunk: int, halo: int):
    """Uniform-size extended slices [(start, lo_off)] covering [0, h) in
    `chunk`-row steps: rows [start, start + ext) with start clamped to
    the image; lo_off = where the chunk's first output row sits inside."""
    ext = min(h, -(-(chunk + 2 * halo) // 8) * 8)
    out = []
    for c0 in range(0, h, chunk):
        start = min(max(0, c0 - halo), h - ext)
        out.append((start, c0 - start))
    return ext, out


def band_stereo_core_chunked(img_l, img_r, arms_l, arms_r, cfg):
    """Cost init + 4-pass quantized aggregation + WTA for both eyes, over
    row chunks of cfg.band_row_chunk output rows (0 = whole frame).  Each
    chunk recomputes a halo of 2*usd rows (the reach of the two V
    passes); the census codes come from the whole frame.  Exact integer
    aggregation makes the result independent of the chunking.

    cfg.use_hslo puts the horizontal scanline optimisation (kernel B13)
    between the aggregation and the WTA, its penalties scaled into the
    aggregate's cost units; rows are independent in it, so chunking
    stays exact.  Returns (disp_l, disp_r) float32 (H, W)."""
    h, w = img_l.shape[:2]
    usd = cfg.usd
    if usd > _HALO:
        raise ValueError("band engine requires usd <= 64")
    nd, zd = cfg.num_disp, cfg.zero_disp
    chunk = cfg.band_row_chunk or h
    ext, bounds = _chunk_bounds(h, chunk, 2 * usd)
    margin = pair_margin(nd, zd)
    table = device_cost_table(cfg.ad_coeff, cfg.census_coeff, img_l.device)
    gray_l, gray_r = mux_average(img_l), mux_average(img_r)
    cen_l = census_transform_9x7(gray_l)
    cen_r = census_transform_9x7(gray_r)
    if cfg.use_hslo:
        kappa = agg_cost_scale(usd, cfg.band_digits, cfg.band_qscale)

    parts_l, parts_r = [], []
    for start, lo in bounds:
        sl = slice(start, start + ext)
        pair = cost_pair(img_l[sl], img_r[sl], cen_l[sl], cen_r[sl], table,
                         nd, zd)
        cost_l = pair[:, margin:margin + w]
        cost_r = shear_right(pair, zd)
        n_valid = min(chunk, h - (start + lo))
        for cost, arms, sign, parts in ((cost_l, arms_l, +1, parts_l),
                                        (cost_r, arms_r, -1, parts_r)):
            if cfg.use_hslo:
                vol = band_aggregate_q(cost, arms[:, sl], usd, None,
                                       cfg.band_digits, cfg.band_qscale)
                ga, gb = ((gray_l, gray_r) if sign > 0
                          else (gray_r, gray_l))
                disp = dc_hslo_wta(vol, ga[sl], gb[sl], nd, zd, cfg.hslo_T,
                                   cfg.hslo_H1 * kappa, cfg.hslo_H2 * kappa,
                                   sign)
            else:
                disp = band_aggregate_q(cost, arms[:, sl], usd, zd,
                                        cfg.band_digits, cfg.band_qscale)
            parts.append(disp[lo:lo + n_valid])
    if len(parts_l) == 1:
        return parts_l[0], parts_r[0]
    return torch.cat(parts_l, dim=0), torch.cat(parts_r, dim=0)
