"""The row-major bounded backward warps of the JAX package's
`ops/warpkern.py`: kernels B19 (`dibr_warp_views_kern`, every view) and
B20 (`dibr_warp_pair_kern`, one view), with their plain PyTorch versions.

Each view's two warps sample as B14 does (`dibr.warp_interp_u8`), but
only within a static range of sample
offsets: k = floor(c) - x must lie in [lo, hi], the floor/ceil of the
disparity range [-zero_disp, num_disp - zero_disp] times the warp's
shift (`dibr.offset_range`).  Outside it the TPU kernels select no sample
and write 0, so this port does too.  Inside it B14, B19 and B20 agree.

The wrappers take the plain version only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.dibr import (
    merge_shifts, offset_range, warp_interp_u8)
from stereo_to_multiview_tpu_torch.ops.mux import f32

F32 = torch.float32
MAX_REACH = 128      # the TPU kernels' padding: one 128-lane chunk


def _view_bounds(shifts, num_disp: int, zero_disp: int):
    """Each view's (lo, hi) for its left-image warp (shift -s) and its
    right-image warp (1 - s); raises where the JAX entries do."""
    d = (-zero_disp, num_disp - zero_disp)
    bl = [offset_range(*d, -float(s)) for s in shifts]
    br = [offset_range(*d, 1.0 - float(s)) for s in shifts]
    if max(max(abs(lo), abs(hi)) for lo, hi in bl + br) + 1 > MAX_REACH:
        raise ValueError("disparity reach exceeds one 128-lane chunk")
    return bl, br


def bounded_warp_plain(img_in: torch.Tensor, disp: torch.Tensor,
                       shift: float, lo: int, hi: int) -> torch.Tensor:
    """`warp_interp_u8` as float32 where lo <= floor(c) - x <= hi (c the
    clamped sample coordinate, computed as there), else 0."""
    w = img_in.shape[1]
    xs = torch.arange(w, dtype=F32, device=img_in.device)
    c = (xs[None, :] + disp.to(F32) * f32(shift)).clamp(0.0, float(w - 1))
    k = torch.floor(c) - xs[None, :]
    keep = ((k >= lo) & (k <= hi))[:, :, None]
    return torch.where(keep, warp_interp_u8(img_in, disp, shift).to(F32),
                       0.0)


def warp_views_bounded_plain(img_l, img_r, disp_l, disp_r, shifts,
                             num_disp: int, zero_disp: int):
    """Plain version of `dibr_warp_views_kern`: two bounded warps a
    view."""
    bl, br = _view_bounds(shifts, num_disp, zero_disp)
    sl, sr = merge_shifts(shifts)
    va = torch.stack([bounded_warp_plain(img_l, disp_r, s, *b)
                      for s, b in zip(sl, bl)])
    vb = torch.stack([bounded_warp_plain(img_r, disp_l, s, *b)
                      for s, b in zip(sr, br)])
    return va, vb


@functools.lru_cache(maxsize=16)
def _view_args(shifts: tuple, num_disp: int, zero_disp: int,
               device: torch.device):
    """B19's per-view arguments on the device: the shifts (shifts_l, then
    shifts_r, float32) and each view's (lo_l, hi_l, lo_r, hi_r) (int32)."""
    bl, br = _view_bounds(shifts, num_disp, zero_disp)
    sl, sr = merge_shifts(shifts)
    bounds = [v for a, b in zip(bl, br) for v in (*a, *b)]
    return (torch.tensor(sl + sr, dtype=F32, device=device),
            torch.tensor(bounds, dtype=torch.int32, device=device))


def _launch(what, img_l, img_r, disp_l, disp_r, shifts, num_disp: int,
            zero_disp: int):
    """The bounded warps of every view in `shifts` on the card, in one
    launch (B19's and B20's C entry point)."""
    dev = img_l.device
    h, w = img_l.shape[:2]
    for name, t in (("img_l", img_l), ("img_r", img_r)):
        kernels.require(t, name, torch.uint8, 3, dev)
        if t.shape != (h, w, 3):
            raise ValueError(f"{what}: {name} is not (H, W, 3)")
    for name, t in (("disp_l", disp_l), ("disp_r", disp_r)):
        kernels.require(t, name, F32, 2, dev)
        if t.shape != (h, w):
            raise ValueError(f"{what}: {name} is not (H, W)")
    shift_arr, bounds = _view_args(tuple(float(s) for s in shifts), num_disp,
                                   zero_disp, dev)
    va = torch.empty((len(shifts), h, w, 3), dtype=F32, device=dev)
    vb = torch.empty_like(va)
    rc = kernels.lib("warp").stm_warp_views_bounded(
        img_l.data_ptr(), img_r.data_ptr(), disp_l.data_ptr(),
        disp_r.data_ptr(), shift_arr.data_ptr(), bounds.data_ptr(),
        va.data_ptr(), vb.data_ptr(), h, w, len(shifts),
        kernels.stream_of(va))
    kernels.check_launch(rc, what)
    return va, vb


@kernels.kernel_wrapper
def dibr_warp_views_kern(img_l, img_r, disp_l, disp_r, shifts,
                         num_disp: int, zero_disp: int):
    """Every intermediate view's warp pair: (va, vb), each (nv, H, W, 3)
    float32 with integral values; va[v] = img_l warped with disp_r at
    -shifts[v], vb[v] = img_r warped with disp_l at 1 - shifts[v], each
    bounded to its view's offset range (0 outside it).  Kernel B19
    (csrc/warp.cu `stm_warp_views_bounded`)."""
    if not shifts:
        empty = img_l.new_empty((0, *img_l.shape), dtype=F32)
        return empty, empty.clone()
    if kernels.on_cpu(img_l):
        return warp_views_bounded_plain(img_l, img_r, disp_l, disp_r, shifts,
                                        num_disp, zero_disp)
    out = _launch("dibr_warp_views_kern", img_l, img_r, disp_l, disp_r,
                  shifts, num_disp, zero_disp)
    dibr_warp_views_kern.launches += 1
    return out


@kernels.kernel_wrapper
def dibr_warp_pair_kern(img_l, img_r, disp_l, disp_r, shift: float,
                        num_disp: int, zero_disp: int):
    """The intermediate view at fraction `shift` from the right, before
    mask and merge: (from_l, from_r), each (H, W, 3) float32, the
    `dibr_warp_views_kern` pair of that one view.  Kernel B20 (the same C
    entry point with one view)."""
    if kernels.on_cpu(img_l):
        va, vb = warp_views_bounded_plain(img_l, img_r, disp_l, disp_r,
                                          (shift,), num_disp, zero_disp)
    else:
        va, vb = _launch("dibr_warp_pair_kern", img_l, img_r, disp_l, disp_r,
                         (shift,), num_disp, zero_disp)
        dibr_warp_pair_kern.launches += 1
    return va[0], vb[0]
