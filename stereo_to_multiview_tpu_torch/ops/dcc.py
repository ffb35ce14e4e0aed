"""Disparity cross-check + disocclusion labels, kernel B7 and its plain
PyTorch version.

Outlier labels: 0 ok, 1 mismatch, 2 mismatch & disoccluded.  The same
kernel gives the occlusion hits of the view synthesis (`dibr_occl`).
The wrappers take the plain version only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.mux import f32


def scatter_hit(off: torch.Tensor) -> torch.Tensor:
    """hit[y, j] = any x with clamp(x + off[y, x], 0, W-1) == j."""
    w = off.shape[1]
    pos = torch.arange(w, device=off.device)
    tgt = (pos + off).clamp(0, w - 1)
    hit = torch.zeros(off.shape, dtype=torch.bool, device=off.device)
    return hit.scatter_(1, tgt, True)


def dr_dcc_plain(disp_l: torch.Tensor, disp_r: torch.Tensor,
                 thresh: float = 1.0):
    """Plain version of `dr_dcc`: gathers and a scatter per eye."""
    w = disp_l.shape[1]
    pos = torch.arange(w, device=disp_l.device)

    def mismatch(d_a, d_b, sign):
        idx = (pos + sign * d_a.to(torch.int64)).clamp(0, w - 1)
        d_ref = torch.gather(d_b, 1, idx)
        return ((d_a - d_ref).abs() > f32(thresh)).to(torch.uint8)

    out_l = mismatch(disp_l, disp_r, +1)
    out_r = mismatch(disp_r, disp_l, -1)
    dis_r = ~scatter_hit(disp_l.to(torch.int64))
    dis_l = ~scatter_hit(-disp_r.to(torch.int64))
    out_l = torch.where((out_l == 1) & dis_l, 2, out_l)
    out_r = torch.where((out_r == 1) & dis_r, 2, out_r)
    return out_l, out_r


def launch_dcc(disp_l: torch.Tensor, disp_r: torch.Tensor, thresh: float,
               labels: bool, what: str):
    """Kernel B7 (csrc/occl.cu) on two (H, W) float32 CUDA planes: labels
    or occlusion hits, (out_l, out_r) u8."""
    for name, t in (("disp_l", disp_l), ("disp_r", disp_r)):
        kernels.require(t, name, torch.float32, 2, disp_l.device)
    if disp_r.shape != disp_l.shape:
        raise ValueError(f"{what}: disparity shapes differ")
    h, w = disp_l.shape
    out_l = torch.empty((h, w), dtype=torch.uint8, device=disp_l.device)
    out_r = torch.empty_like(out_l)
    rc = kernels.lib("occl").stm_dcc(
        disp_l.data_ptr(), disp_r.data_ptr(), out_l.data_ptr(),
        out_r.data_ptr(), h, w, float(f32(thresh)), int(labels),
        kernels.stream_of(out_l))
    kernels.check_launch(rc, what)
    return out_l, out_r


@kernels.kernel_wrapper
def dr_dcc(disp_l: torch.Tensor, disp_r: torch.Tensor, thresh: float = 1.0):
    """Left-right consistency |d - d_other(x + trunc(d))| > thresh (the
    lookup column clamped to the image) and forward-scatter disocclusion
    (a mismatched pixel no other-eye pixel maps onto becomes 2).
    Disparities truncate toward zero.  Kernel B7 (csrc/occl.cu)."""
    if kernels.on_cpu(disp_l):
        return dr_dcc_plain(disp_l, disp_r, thresh)
    out = launch_dcc(disp_l, disp_r, thresh, True, "dr_dcc")
    dr_dcc.launches += 1
    return out
