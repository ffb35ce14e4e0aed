"""Rescale transforms of the low-resolution disparity path and of the
interlace's output-resolution resampling, and kernel G2: the lowres
route's rescales of both eyes, one launch each way (`csrc/scale.cu`).

A resize has static sampling coordinates s_i = clamp(i / n_out * n_in,
0, n_in - 1), computed in float32 on the host.  Each axis is two
`index_select`s (the samples at floor(s) and at floor(s) + 1, the latter
clamped to the far edge) and an elementwise lerp (1 - w) * a + w * b;
the x axis runs first, then y, which is the reference's association
(top and bottom x-lerps, then the y-lerp).  The JAX package computes the
same two-term sums as matmuls with mostly-zero weight matrices.

The G2 wrappers take these functions as their plain versions for CPU
tensors; on a CUDA tensor they launch the kernel, which computes the
taps from the indices on the device, bit-equal to them.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_to_multiview_tpu_torch import kernels

F32 = torch.float32


def samp_coords(n_out: int, n_in: int) -> np.ndarray:
    """Sampling coordinates in float32: clamp(i / n_out * n_in, 0,
    n_in - 1)."""
    i = np.arange(n_out, dtype=np.float32)
    return np.clip(i / np.float32(n_out) * np.float32(n_in),
                   np.float32(0.0), np.float32(n_in - 1))


def lerp_taps(n_out: int, n_in: int, device):
    """(i0, i1, w) of one axis: the two sample indices (int64 tensors)
    and the float32 weight of the second."""
    s = samp_coords(n_out, n_in)
    i0 = np.floor(s).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = (s - i0.astype(np.float32)).astype(np.float32)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(w).to(device))


def lerp_axis(a: torch.Tensor, axis: int, n_out: int,
              contract: bool = False) -> torch.Tensor:
    """Linear resample of float32 `a` along `axis` to n_out samples:
    a0 * (1 - w) + a1 * w, each product rounded, or with `contract` the
    first fused into the add, fma(a0, 1 - w, a1 * w), as the JAX
    package's jitted CPU executable computes its interlace's resample."""
    return lerp_gather(a, axis, *lerp_taps(n_out, a.shape[axis], a.device),
                       contract)


def lerp_gather(a: torch.Tensor, axis: int, i0: torch.Tensor,
                i1: torch.Tensor, w: torch.Tensor,
                contract: bool = False) -> torch.Tensor:
    """`lerp_axis` from given taps: the samples of `a` at i0 and i1 along
    `axis` and the second's float32 weight w (a row shard's slice of an
    axis' `lerp_taps`, its indices moved into the shard's rows)."""
    shape = [1] * a.dim()
    shape[axis] = len(w)
    w = w.reshape(shape)
    a0, a1 = a.index_select(axis, i0), a.index_select(axis, i1)
    if contract:
        from stereo_to_multiview_tpu_torch.ops.fastmath import fma
        return fma(a0, 1.0 - w, a1 * w)
    return a0 * (1.0 - w) + a1 * w


def resize_bilinear_f32(img: torch.Tensor, out_rows: int,
                        out_cols: int) -> torch.Tensor:
    """Float bilinear resize of an (H, W) or (H, W, C) image; the input
    cast to float32 when the shapes already match."""
    a = img.to(F32)
    if tuple(img.shape[:2]) == (out_rows, out_cols):
        return a
    return lerp_axis(lerp_axis(a, 1, out_cols), 0, out_rows)


def tx_scale_bilinear(img: torch.Tensor, out_rows: int,
                      out_cols: int) -> torch.Tensor:
    """Bilinear image resize with a truncating u8 store."""
    return resize_bilinear_f32(img, out_rows, out_cols).to(torch.uint8)


def tx_scale_nearest(img: torch.Tensor, out_rows: int,
                     out_cols: int) -> torch.Tensor:
    """Nearest resize: the sample at the truncated coordinate."""
    h, w = img.shape[:2]
    if (h, w) == (out_rows, out_cols):
        return img
    sy = torch.from_numpy(samp_coords(out_rows, h).astype(np.int64))
    sx = torch.from_numpy(samp_coords(out_cols, w).astype(np.int64))
    return img.index_select(0, sy.to(img.device)).index_select(
        1, sx.to(img.device))


def tx_disp_scale(disp: torch.Tensor, out_rows: int, out_cols: int,
                  disp_scale: float) -> torch.Tensor:
    """Bilinear disparity resize with the values multiplied by
    disp_scale (float32)."""
    scale = torch.tensor(np.float32(disp_scale), dtype=F32)
    return resize_bilinear_f32(disp, out_rows, out_cols) * scale


def _eyes(a: torch.Tensor, b: torch.Tensor, dtype, ndim: int):
    """Raise unless both eyes are contiguous tensors of `dtype` and
    `ndim` dimensions, of one shape, on one CUDA device."""
    kernels.require(a, "left eye", dtype, ndim, a.device)
    kernels.require(b, "right eye", dtype, ndim, a.device)
    if a.shape != b.shape:
        raise ValueError(f"the eyes' shapes differ: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")


def _out_shape(out_rows: int, out_cols: int):
    if out_rows <= 0 or out_cols <= 0 or out_rows > 65535:
        raise ValueError(f"output of {out_rows}x{out_cols}: need 0 < rows "
                         f"<= 65535 and 0 < columns")
    return int(out_rows), int(out_cols)


@kernels.kernel_wrapper
def tx_scale_bilinear_lr(img_l: torch.Tensor, img_r: torch.Tensor,
                         out_rows: int, out_cols: int):
    """Both eyes' `tx_scale_bilinear`, (out_rows, out_cols, C) u8 each, of
    (H, W, C) u8 images (C <= 4).  Kernel G2 (csrc/scale.cu
    `tx_scale_bilinear_kernel`), one launch."""
    if kernels.on_cpu(img_l):
        return (tx_scale_bilinear(img_l, out_rows, out_cols).contiguous(),
                tx_scale_bilinear(img_r, out_rows, out_cols).contiguous())
    _eyes(img_l, img_r, torch.uint8, 3)
    rows, cols = _out_shape(out_rows, out_cols)
    h, w, c = img_l.shape
    out_l, out_r = (torch.empty((rows, cols, c), dtype=torch.uint8,
                                device=img_l.device) for _ in range(2))
    rc = kernels.lib("scale").stm_tx_scale_u8(
        img_l.data_ptr(), img_r.data_ptr(), out_l.data_ptr(),
        out_r.data_ptr(), h, w, c, rows, cols, kernels.stream_of(out_l))
    kernels.check_launch(rc, "tx_scale_bilinear_lr")
    tx_scale_bilinear_lr.launches += 1
    return out_l, out_r


@kernels.kernel_wrapper
def tx_disp_scale_lr(disp_l: torch.Tensor, disp_r: torch.Tensor,
                     out_rows: int, out_cols: int, disp_scale: float):
    """Both eyes' `tx_disp_scale`, (out_rows, out_cols) float32 each, of
    (H, W) float32 disparities.  Kernel G2 (csrc/scale.cu
    `tx_disp_scale_kernel`), one launch."""
    if kernels.on_cpu(disp_l):
        return (tx_disp_scale(disp_l, out_rows, out_cols, disp_scale),
                tx_disp_scale(disp_r, out_rows, out_cols, disp_scale))
    _eyes(disp_l, disp_r, F32, 2)
    rows, cols = _out_shape(out_rows, out_cols)
    h, w = disp_l.shape
    out_l, out_r = (torch.empty((rows, cols), dtype=F32,
                                device=disp_l.device) for _ in range(2))
    rc = kernels.lib("scale").stm_tx_disp_scale(
        disp_l.data_ptr(), disp_r.data_ptr(), out_l.data_ptr(),
        out_r.data_ptr(), h, w, rows, cols, float(np.float32(disp_scale)),
        kernels.stream_of(out_l))
    kernels.check_launch(rc, "tx_disp_scale_lr")
    tx_disp_scale_lr.launches += 1
    return out_l, out_r
