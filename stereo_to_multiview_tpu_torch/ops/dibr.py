"""Depth-image-based rendering: occlusion masks (kernels B7 and B11, one
fused launch on the synthesis' path), mask feather (G1), and the
backward (gather) warp: merged into the
interlaced frame in one kernel (B12's interlace mode, the synthesis of
`process_frame`), merged into every view (B12), or as the float warp
volumes of every view (B14), with the kernels' plain PyTorch versions;
and the forward (scatter) warp, plain PyTorch on every device as in the
JAX package.

The wrappers take the plain version only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.dcc import launch_dcc, scatter_hit
from stereo_to_multiview_tpu_torch.ops.fastmath import fma
from stereo_to_multiview_tpu_torch.ops.filters import (
    filter_bleed, filter_gaussian_lift, gaussian_lift_constants)
from stereo_to_multiview_tpu_torch.ops.mux import (
    f32, mux_geometry, mux_merge_ab, mux_multiview)
from stereo_to_multiview_tpu_torch.ops.scale import lerp_taps

F32 = torch.float32


def op_invertnormf(v: torch.Tensor) -> torch.Tensor:
    """v -> 1 - v."""
    return 1.0 - v.to(F32)


def dibr_occl_plain(disp_l: torch.Tensor, disp_r: torch.Tensor):
    """Plain version of `dibr_occl`: one scatter per eye."""
    hit_r = scatter_hit(disp_l.to(torch.int64))
    hit_l = scatter_hit(-disp_r.to(torch.int64))
    return hit_l.to(torch.uint8), hit_r.to(torch.uint8)


@kernels.kernel_wrapper
def dibr_occl(disp_l: torch.Tensor, disp_r: torch.Tensor):
    """Visibility masks by forward scatter: occl_r[clamp(x + trunc(d_l))]
    = 1 and occl_l[clamp(x - trunc(d_r))] = 1; returns (occl_l, occl_r)
    u8.  Kernel B7 (csrc/occl.cu) in its hits mode."""
    if kernels.on_cpu(disp_l):
        return dibr_occl_plain(disp_l, disp_r)
    out = launch_dcc(disp_l, disp_r, 0.0, False, "dibr_occl")
    dibr_occl.launches += 1
    return out


def dibr_occl_to_mask(occl: torch.Tensor) -> torch.Tensor:
    """u8 mask -> float {0, 1}; only the value 1 maps to 1.0."""
    return (occl == 1).to(F32)


@functools.lru_cache(maxsize=64)
def bleed_thresh(radius: int) -> float:
    """The bleed's float32 threshold on the neighbourhood count."""
    return float(np.float32(((2 * radius + 1) ** 2 - 1) * 0.30))


@functools.lru_cache(maxsize=64)
def _occl_rmax(width: int) -> int:
    """The largest radius the fused occlusion stage runs in one launch."""
    return kernels.lib("occl").stm_occl_masks_rmax(width)


def _check_radius(what: str, radius: int, h: int, w: int):
    if not 0 <= radius < min(h, w):
        raise ValueError(f"{what}: radius must be below the plane's sides")


def dibr_bleed_mask_plain(occl: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of `dibr_bleed_mask`."""
    return dibr_occl_to_mask(filter_bleed(occl, radius))


@kernels.kernel_wrapper
def dibr_bleed_mask(occl: torch.Tensor, radius: int) -> torch.Tensor:
    """dibr_occl_to_mask(filter_bleed(occl, radius)): (H, W) u8 occlusion
    hits -> float32 {0, 1} mask.  Kernel B11 (csrc/occl.cu): the fused
    stage's count and store, its hits read from the u8 plane."""
    if kernels.on_cpu(occl):
        return dibr_bleed_mask_plain(occl, radius)
    kernels.require(occl, "occl", torch.uint8, 2, occl.device)
    h, w = occl.shape
    _check_radius("dibr_bleed_mask", radius, h, w)
    mask = torch.empty((h, w), dtype=F32, device=occl.device)
    rc = kernels.lib("occl").stm_bleed_mask(
        occl.data_ptr(), mask.data_ptr(), h, w, radius, bleed_thresh(radius),
        kernels.stream_of(mask))
    kernels.check_launch(rc, "dibr_bleed_mask")
    dibr_bleed_mask.launches += 1
    return mask


def dibr_occl_masks_plain(disp_l: torch.Tensor, disp_r: torch.Tensor,
                          radius: int):
    """Plain version of `dibr_occl_masks`: the hits, then each eye's
    bleed mask."""
    return tuple(dibr_bleed_mask_plain(o, radius)
                 for o in dibr_occl_plain(disp_l, disp_r))


@kernels.kernel_wrapper
def dibr_occl_masks(disp_l: torch.Tensor, disp_r: torch.Tensor,
                    radius: int):
    """The synthesis' masks from the disparities, (mask_l, mask_r) float32
    {0, 1}: `dibr_bleed_mask` of each eye's `dibr_occl` hits.  Kernels B7
    and B11 fused (csrc/occl.cu): one launch for both eyes, the hits kept
    in shared memory; above the radius whose window fits a block
    (`stm_occl_masks_rmax`), B7's hits into two u8 planes, then B11 on
    both: two launches."""
    if kernels.on_cpu(disp_l):
        return dibr_occl_masks_plain(disp_l, disp_r, radius)
    dev = disp_l.device
    for name, t in (("disp_l", disp_l), ("disp_r", disp_r)):
        kernels.require(t, name, F32, 2, dev)
    if disp_r.shape != disp_l.shape:
        raise ValueError("dibr_occl_masks: disparity shapes differ")
    h, w = disp_l.shape
    _check_radius("dibr_occl_masks", radius, h, w)
    mask_l = torch.empty((h, w), dtype=F32, device=dev)
    mask_r = torch.empty_like(mask_l)
    scratch = ([] if radius <= _occl_rmax(w) else
               [torch.empty((h, w), dtype=torch.uint8, device=dev)
                for _ in range(2)])
    hits = [t.data_ptr() for t in scratch] or [None, None]
    rc = kernels.lib("occl").stm_occl_masks(
        disp_l.data_ptr(), disp_r.data_ptr(), *hits, mask_l.data_ptr(),
        mask_r.data_ptr(), h, w, radius, bleed_thresh(radius),
        kernels.stream_of(mask_l))
    kernels.check_launch(rc, "dibr_occl_masks")
    dibr_occl_masks.launches += 1
    return mask_l, mask_r


def dibr_feather_mask_plain(mask_r: torch.Tensor, feather_radius: int,
                            feather_sigma: float) -> torch.Tensor:
    """Plain version of `dibr_feather_mask`."""
    return filter_gaussian_lift(op_invertnormf(mask_r), feather_radius,
                                feather_sigma)


@functools.lru_cache(maxsize=16)
def _feather_args(radius: int, sigma: float):
    """G1's host arguments for each setting: the taps as a host float32
    array (the kernel copies them into its parameters at each call) and
    the factor `post`."""
    taps, post = gaussian_lift_constants(radius, sigma)
    return kernels.host_f32(taps), float(post)


@functools.lru_cache(maxsize=16)
def _feather_dev_taps(radius: int, sigma: float, device: torch.device):
    """G1's taps in device memory: its two-launch passes read them."""
    taps, _ = gaussian_lift_constants(radius, sigma)
    return torch.from_numpy(taps).to(device)


@kernels.kernel_wrapper
def dibr_feather_mask(mask_r: torch.Tensor, feather_radius: int,
                      feather_sigma: float) -> torch.Tensor:
    """Blend weight of the view merge: the inverted right-eye mask,
    feathered with the lifting Gaussian, (H, W) float32.  Kernel G1
    (csrc/feather.cu): one launch, two through a scratch plane above its
    largest one-launch radius."""
    if kernels.on_cpu(mask_r):
        return dibr_feather_mask_plain(mask_r, feather_radius, feather_sigma)
    kernels.require(mask_r, "mask_r", F32, 2, mask_r.device)
    if feather_radius < 0:
        raise ValueError("dibr_feather_mask: the radius must be >= 0")
    h, w = mask_r.shape
    r, sigma = int(feather_radius), float(feather_sigma)
    lib = kernels.lib("feather")
    taps, post = _feather_args(r, sigma)
    dev_taps = scratch = None
    if r > lib.stm_feather_rmax():
        dev_taps = _feather_dev_taps(r, sigma, mask_r.device).data_ptr()
        scratch = torch.empty_like(mask_r)
    out = torch.empty_like(mask_r)
    rc = lib.stm_feather(
        mask_r.data_ptr(), taps, dev_taps,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), h,
        w, r, post, kernels.stream_of(out))
    kernels.check_launch(rc, "dibr_feather_mask")
    dibr_feather_mask.launches += 1
    return out


def warp_interp_u8(img_in: torch.Tensor, disp: torch.Tensor,
                   shift: float, bounds=None, contract: bool = False,
                   first: int | None = None) -> torch.Tensor:
    """The un-masked part of the gather warp: sample img_in at c =
    clamp(x + disp*shift, 0, W-1) with x-only linear interpolation and
    truncate to u8.  The two weights are the triangle weights
    max(1 - |c - x0|, 0) and max(1 - |c - (x0 + 1)|, 0) at x0 = floor(c),
    each evaluated in float32 exactly as the JAX package does, and the
    two terms are added in that order.  With bounds=(lo, hi), a term
    whose offset (its column minus x) lies outside [lo, hi + 1] is
    dropped: the JAX package's bounded sum over a static offset range,
    which gives part of a sample just outside that range.  With
    `contract` (bounds required) the arithmetic is that of the JAX
    package's jitted CPU executable, whose loops contract a product into
    the add that consumes it: c = fma(disp, shift, x), and the sum over
    the range fuses each product into the running sum, the first two as
    fma(t0, t1); otherwise each product is rounded, as its op-by-op
    evaluation and the warp kernels do.  `first` is the offset at which
    the contracted sum starts (default: bounds[0])."""
    h, w, _ = img_in.shape
    xs = torch.arange(w, dtype=F32, device=img_in.device)
    if contract:
        c = fma(disp.to(F32), f32(shift), xs[None, :])
    else:
        c = xs[None, :] + disp.to(F32) * f32(shift)
    c = c.clamp(0.0, float(w - 1))
    x0 = torch.floor(c)
    w0 = (1.0 - (c - x0).abs()).clamp(min=0.0)
    w1 = (1.0 - (c - (x0 + 1.0)).abs()).clamp(min=0.0)
    k0 = x0 - xs[None, :]
    if bounds is not None:
        lo, hi = float(bounds[0]), float(bounds[1] + 1)
        w0 = torch.where((k0 >= lo) & (k0 <= hi), w0, 0.0)
        w1 = torch.where((k0 + 1.0 >= lo) & (k0 + 1.0 <= hi), w1, 0.0)
    i0 = x0.to(torch.int64)
    i1 = (i0 + 1).clamp(max=w - 1)
    img = img_in.to(F32)
    v0 = torch.gather(img, 1, i0[:, :, None].expand(h, w, 3))
    v1 = torch.gather(img, 1, i1[:, :, None].expand(h, w, 3))
    w0, w1 = w0[:, :, None], w1[:, :, None]
    if not contract:
        return (w0 * v0 + w1 * v1).to(torch.uint8)
    # the executable's sum over the offset range fuses each product into
    # the running sum, except the first pair: fma(t0, t1 rounded)
    at_first = (k0 == float(bounds[0] if first is None else first))
    return torch.where(at_first[:, :, None], fma(w0, v0, w1 * v1),
                       fma(w1, v1, w0 * v0)).to(torch.uint8)


def dibr_backward_warp(img_in: torch.Tensor, mask: torch.Tensor,
                       disp: torch.Tensor, shift: float,
                       num_disp: int | None = None,
                       zero_disp: int | None = None,
                       contract: bool = False) -> torch.Tensor:
    """Gather warp of the XLA engine's synthesis: `warp_interp_u8`
    bounded by the `offset_range` of the disparity range [-zero_disp,
    num_disp - zero_disp] (without one, [-(W - 1), W - 1]), multiplied
    by mask, truncated again; `contract` as there.  Plain torch on every
    device, as in the JAX package."""
    w = img_in.shape[1]
    if num_disp is None or zero_disp is None:
        bounds = offset_range(-(w - 1), w - 1, shift)
    else:
        bounds = offset_range(-zero_disp, num_disp - zero_disp, shift)
    return masked(warp_interp_u8(img_in, disp, shift, bounds, contract),
                  mask)


def dibr_backward_warp_dyn(img_in: torch.Tensor, mask: torch.Tensor,
                           disp: torch.Tensor, shift: float, num_disp: int,
                           zero_disp: int,
                           contract: bool = False) -> torch.Tensor:
    """`dibr_backward_warp` with the bound of the JAX package's view-axis
    warp, whose shift depends on the device: the whole disparity range
    both ways, [-dmax - 1, dmax + 1] with dmax = max(zero_disp, num_disp
    - zero_disp), whatever the shift.  On disparities inside the range
    no term falls outside either bound, so the two warps agree; with
    `contract` the sum starts its contraction at this shift's own first
    offset (`offset_range`), where `dibr_backward_warp` starts it, so
    they agree there too.  Plain torch on every device."""
    dmax = max(zero_disp, num_disp - zero_disp)
    first = offset_range(-zero_disp, num_disp - zero_disp, shift)[0]
    return masked(warp_interp_u8(img_in, disp, shift, (-dmax - 1, dmax + 1),
                                 contract, first), mask)


def dibr_dbm(img_l, img_r, disp_l, disp_r, mask_l, mask_r, shift: float,
             feather_radius: int = 10, feather_sigma: float = 15.0,
             feathered_mask=None) -> torch.Tensor:
    """Backward-mapped intermediate view at fraction `shift` from the
    right: the LEFT image warped with the RIGHT eye's disparity and mask
    at -shift and the right image with the left eye's at 1 - shift
    (`dibr_backward_warp`, unbounded), merged with the feathered
    inverted right mask (`dibr_feather_mask`, G1, unless
    `feathered_mask` is given)."""
    view_from_l = dibr_backward_warp(img_l, mask_r, disp_r, -shift)
    view_from_r = dibr_backward_warp(img_r, mask_l, disp_l, 1.0 - shift)
    m = feathered_mask
    if m is None:
        m = dibr_feather_mask(mask_r, feather_radius, feather_sigma)
    return mux_merge_ab(view_from_l, view_from_r, m)


def masked(interp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """u8 warp times a float mask, truncated to u8."""
    return (interp.to(F32) * mask.to(F32)[:, :, None]).to(torch.uint8)


def synth_shifts(v: int):
    """Intermediate-view fractions 1 - v_i/(V-1), in float32."""
    return tuple(float(np.float32(1.0) - np.float32(v_i) / np.float32(v - 1.0))
                 for v_i in range(1, v - 1))


def merge_shifts(shifts):
    """(shifts_l, shifts_r) float32 of the two warps of each intermediate
    view: -shift for the left image, 1 - shift for the right one (the
    difference taken in float64 and rounded once, as float32 constants
    are made everywhere in the port)."""
    return ([float(np.float32(-s)) for s in shifts],
            [float(np.float32(1.0 - s)) for s in shifts])


def warp_merge_views_plain(img_l, img_r, disp_l, disp_r, mask_l, mask_r,
                           feathered, shifts, out=None) -> torch.Tensor:
    """Plain version of `warp_merge_views`: two warps (unbounded, as the
    kernel) and a merge per view."""
    sl, sr = merge_shifts(shifts)
    views = [mux_merge_ab(masked(warp_interp_u8(img_l, disp_r, a), mask_r),
                          masked(warp_interp_u8(img_r, disp_l, b), mask_l),
                          feathered)
             for a, b in zip(sl, sr)]
    if out is None:
        return torch.stack(views)
    return torch.stack(views, out=out)


@functools.lru_cache(maxsize=16)
def _stack_shifts(shifts: tuple, device: torch.device):
    """B12's view-stack shift array on the device: sl, then sr."""
    sl, sr = merge_shifts(shifts)
    return torch.tensor(sl + sr, dtype=F32, device=device)


def _views_out(out, nv: int, h: int, w: int, dev) -> torch.Tensor:
    """The (nv, H, W, 3) u8 volume `warp_merge_views` writes: `out` if
    given (checked), else a new one."""
    if out is None:
        return torch.empty((nv, h, w, 3), dtype=torch.uint8, device=dev)
    if (tuple(out.shape) != (nv, h, w, 3) or out.dtype != torch.uint8
            or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"warp_merge_views: out must be a contiguous "
                         f"({nv}, {h}, {w}, 3) uint8 volume on {dev}")
    return out


@kernels.kernel_wrapper
def warp_merge_views(img_l, img_r, disp_l, disp_r, mask_l, mask_r,
                     feathered, shifts, out=None) -> torch.Tensor:
    """Every intermediate view, (nv, H, W, 3) u8: for each shift, the
    left image warped with disp_r at -shift (masked by mask_r) and the
    right image warped with disp_l at 1 - shift (masked by mask_l),
    merged with the feathered weight (`mux_merge_ab`).  Written into
    `out`, a contiguous (nv, H, W, 3) u8 volume, when given (the view
    stack's middle views, in place), and returned.  Kernel B12
    (csrc/warp.cu), one launch for every view."""
    dev = img_l.device
    h, w = img_l.shape[:2]
    if not shifts:
        return _views_out(out, 0, h, w, dev)
    if kernels.on_cpu(img_l):
        return warp_merge_views_plain(
            img_l, img_r, disp_l, disp_r, mask_l, mask_r, feathered, shifts,
            _views_out(out, len(shifts), h, w, dev))
    for name, t in (("img_l", img_l), ("img_r", img_r)):
        kernels.require(t, name, torch.uint8, 3, dev)
        if t.shape != (h, w, 3):
            raise ValueError(f"warp_merge_views: {name} is not (H, W, 3)")
    for name, t in (("disp_l", disp_l), ("disp_r", disp_r),
                    ("mask_l", mask_l), ("mask_r", mask_r),
                    ("feathered", feathered)):
        kernels.require(t, name, F32, 2, dev)
        if t.shape != (h, w):
            raise ValueError(f"warp_merge_views: {name} is not (H, W)")
    nv = len(shifts)
    out = _views_out(out, nv, h, w, dev)
    rc = kernels.lib("warp").stm_warp_merge(
        img_l.data_ptr(), img_r.data_ptr(), disp_l.data_ptr(),
        disp_r.data_ptr(), mask_l.data_ptr(), mask_r.data_ptr(),
        feathered.data_ptr(),
        _stack_shifts(tuple(float(x) for x in shifts), dev).data_ptr(),
        out.data_ptr(), h, w, nv, kernels.stream_of(out))
    kernels.check_launch(rc, "warp_merge_views")
    warp_merge_views.launches += 1
    return out


def warp_merge_interlace_plain(img_l, img_r, disp_l, disp_r, mask_l, mask_r,
                               feathered, num_views: int, rows_out: int,
                               cols_out: int, angle: float) -> torch.Tensor:
    """Plain version of `warp_merge_interlace`: the view stack (B12's
    plain version between the two source images), then `mux_multiview`."""
    shifts = synth_shifts(num_views)
    mids = (warp_merge_views_plain(img_l, img_r, disp_l, disp_r, mask_l,
                                   mask_r, feathered, shifts) if shifts
            else img_l.new_empty((0, *img_l.shape)))
    views = torch.cat([img_r[None], mids, img_l[None]])
    return mux_multiview(views, rows_out, cols_out, angle)


@functools.lru_cache(maxsize=16)
def _interlace_shifts(num_views: int, device: torch.device):
    """B12's interlace mode's shift array on the device: sl, then sr."""
    sl, sr = merge_shifts(synth_shifts(num_views))
    return torch.tensor(sl + sr, dtype=F32, device=device)


@functools.lru_cache(maxsize=16)
def _interlace_taps(n_out: int, n_in: int, device: torch.device):
    """`lerp_taps` of one output axis on the device, the indices as
    int32."""
    i0, i1, w = lerp_taps(n_out, n_in, device)
    return i0.to(torch.int32), i1.to(torch.int32), w


@kernels.kernel_wrapper
def warp_merge_interlace(img_l, img_r, disp_l, disp_r, mask_l, mask_r,
                         feathered, num_views: int, rows_out: int,
                         cols_out: int, angle: float) -> torch.Tensor:
    """The interlaced frame, (rows_out, cols_out, 3) u8, of the view
    stack [img_r, the merged intermediate views of `warp_merge_views`,
    img_l]: `mux_multiview` of that stack, each output subpixel computed
    from the one view it selects (sampled bilinearly at the four input
    points of a resampled output).  Kernel B12 in its interlace mode
    (csrc/warp.cu), the JAX `synthesize_interlace` chain."""
    if kernels.on_cpu(img_l):
        return warp_merge_interlace_plain(
            img_l, img_r, disp_l, disp_r, mask_l, mask_r, feathered,
            num_views, rows_out, cols_out, angle)
    dev = img_l.device
    h, w = img_l.shape[:2]
    for name, t in (("img_l", img_l), ("img_r", img_r)):
        kernels.require(t, name, torch.uint8, 3, dev)
        if t.shape != (h, w, 3):
            raise ValueError(f"warp_merge_interlace: {name} is not "
                             f"(H, W, 3)")
    for name, t in (("disp_l", disp_l), ("disp_r", disp_r),
                    ("mask_l", mask_l), ("mask_r", mask_r),
                    ("feathered", feathered)):
        kernels.require(t, name, F32, 2, dev)
        if t.shape != (h, w):
            raise ValueError(f"warp_merge_interlace: {name} is not (H, W)")
    if num_views < 2 or rows_out <= 0 or cols_out <= 0:
        raise ValueError("warp_merge_interlace: need num_views >= 2 and an "
                         "output of at least one pixel")
    y_mod, inv_y = mux_geometry(num_views, angle)
    shifts = _interlace_shifts(num_views, dev) if num_views > 2 else None
    if (rows_out, cols_out) == (h, w):
        tables = (None,) * 6
    else:
        tables = tuple(t.data_ptr() for t in (
            *_interlace_taps(rows_out, h, dev),
            *_interlace_taps(cols_out, w, dev)))
    out = torch.empty((rows_out, cols_out, 3), dtype=torch.uint8,
                      device=dev)
    rc = kernels.lib("warp").stm_warp_merge_interlace(
        img_l.data_ptr(), img_r.data_ptr(), disp_l.data_ptr(),
        disp_r.data_ptr(), mask_l.data_ptr(), mask_r.data_ptr(),
        feathered.data_ptr(), None if shifts is None else shifts.data_ptr(),
        *tables, out.data_ptr(), h, w, num_views, y_mod, rows_out, cols_out,
        float(inv_y), kernels.stream_of(out))
    kernels.check_launch(rc, "warp_merge_interlace")
    warp_merge_interlace.launches += 1
    return out


def warp_views_plain(img_l, img_r, disp_l, disp_r, shifts):
    """Plain version of `warp_views`: two un-masked warps per view."""
    sl, sr = merge_shifts(shifts)
    va = torch.stack([warp_interp_u8(img_l, disp_r, a).to(F32) for a in sl])
    vb = torch.stack([warp_interp_u8(img_r, disp_l, b).to(F32) for b in sr])
    return va, vb


@kernels.kernel_wrapper
def warp_views(img_l, img_r, disp_l, disp_r, shifts):
    """The two directional warps of every intermediate view, without mask
    and merge: (va, vb), each (nv, H, W, 3) float32 with integral values;
    va[v] = the left image warped with disp_r at -shifts[v], vb[v] = the
    right image warped with disp_l at 1 - shifts[v].  Kernel B14
    (csrc/warp.cu)."""
    if not shifts:
        empty = img_l.new_empty((0, *img_l.shape), dtype=F32)
        return empty, empty.clone()
    if kernels.on_cpu(img_l):
        return warp_views_plain(img_l, img_r, disp_l, disp_r, shifts)
    dev = img_l.device
    h, w = img_l.shape[:2]
    for name, t in (("img_l", img_l), ("img_r", img_r)):
        kernels.require(t, name, torch.uint8, 3, dev)
        if t.shape != (h, w, 3):
            raise ValueError(f"warp_views: {name} is not (H, W, 3)")
    for name, t in (("disp_l", disp_l), ("disp_r", disp_r)):
        kernels.require(t, name, F32, 2, dev)
        if t.shape != (h, w):
            raise ValueError(f"warp_views: {name} is not (H, W)")
    nv = len(shifts)
    sl, sr = merge_shifts(shifts)
    va = torch.empty((nv, h, w, 3), dtype=F32, device=dev)
    vb = torch.empty_like(va)
    rc = kernels.lib("warp").stm_warp_views(
        img_l.data_ptr(), img_r.data_ptr(), disp_l.data_ptr(),
        disp_r.data_ptr(), kernels.host_f32(sl), kernels.host_f32(sr),
        va.data_ptr(), vb.data_ptr(), h, w, nv, kernels.stream_of(va))
    kernels.check_launch(rc, "warp_views")
    warp_views.launches += 1
    return va, vb


def offset_range(dmin: int, dmax: int, shift: float):
    """(lo, hi): floor and ceil of disp * shift over disp in [dmin, dmax],
    in float64 as the JAX package's warps bound their static loops."""
    c = (dmin * float(shift), dmax * float(shift))
    return int(math.floor(min(c))), int(math.ceil(max(c)))


def dibr_forward_warp(img_in: torch.Tensor, disp: torch.Tensor, shift: float,
                      num_disp: int | None = None,
                      zero_disp: int | None = None) -> torch.Tensor:
    """Forward scatter warp out[clamp(x + trunc(disp * shift))] = in[x],
    (H, W, C) of img_in's dtype.  Where several sources hit one target the
    largest source x wins; unhit targets are 0; a source whose target
    offset (target - x, after the clamp) lies outside the `offset_range`
    of the disparity range [-zero_disp, num_disp - zero_disp] (without
    one, [-(W - 1), W - 1]) writes nothing.  One amax scatter of source
    indices and one gather: exact and deterministic."""
    h, w, c = img_in.shape
    if num_disp is None or zero_disp is None:
        lo, hi = offset_range(-(w - 1), w - 1, shift)
    else:
        lo, hi = offset_range(-zero_disp, num_disp - zero_disp, shift)
    off = (disp.to(F32) * f32(shift)).to(torch.int32)     # trunc toward 0
    pos = torch.arange(w, device=img_in.device)
    tgt = (pos + off).clamp(0, w - 1).to(torch.int64)
    k = tgt - pos
    src = torch.where((k >= lo) & (k <= hi), pos, -1)
    won = torch.full((h, w), -1, dtype=torch.int64, device=img_in.device)
    won = won.scatter_reduce(1, tgt, src, "amax")
    out = torch.gather(img_in, 1, won.clamp(min=0)[:, :, None].expand(h, w, c))
    return torch.where((won >= 0)[:, :, None], out, 0)


def dibr_dfm(img_l, img_r, disp_l, disp_r, mask_l, mask_r, shift: float):
    """Forward-mapped intermediate view at fraction `shift`: img_l
    forward-warped by shift * disp_l and img_r by (shift - 1) * disp_r,
    merged with the inverted right mask feathered (radius 10, sigma 15).
    `mask_l` is not read, as in the JAX package."""
    view_from_l = dibr_forward_warp(img_l, disp_l, shift)
    view_from_r = dibr_forward_warp(img_r, disp_r, shift - 1.0)
    m = dibr_feather_mask(mask_r, 10, 15.0)
    return mux_merge_ab(view_from_l, view_from_r, m)
