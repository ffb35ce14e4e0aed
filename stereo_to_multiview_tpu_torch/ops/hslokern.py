"""Kernel B13: the two-direction scanline optimisation fused with the
first-min WTA, and its plain PyTorch version.

`dc_hslo_wta` takes the band aggregation's (H, W, D) int32 volume and
the two gray images and returns the (H, W) float32 disparities
argmin_d((fwd + bwd) / 2) - zero_disp of `ops.hslo.dc_hslo_hwd`.  The
wrapper takes the plain version only for a CPU tensor; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.hslo import (
    dc_hslo_hwd, tier_penalties)

F32 = torch.float32


def dc_hslo_wta_plain(vol, gray_a, gray_b, num_disp: int, zero_disp: int,
                      T: float, H1: float, H2: float,
                      sign: int) -> torch.Tensor:
    """Plain version of `dc_hslo_wta`: the scan over the columns, then
    the first-min argmin."""
    gl, gr = (gray_b, gray_a) if sign < 0 else (gray_a, gray_b)
    a = dc_hslo_hwd(vol, gl, gr, num_disp, zero_disp, T, H1, H2, sign)
    return (torch.argmin(a, dim=2) - zero_disp).to(F32)


@kernels.kernel_wrapper
def dc_hslo_wta(vol: torch.Tensor, gray_a: torch.Tensor,
                gray_b: torch.Tensor, num_disp: int, zero_disp: int,
                T: float, H1: float, H2: float, sign: int) -> torch.Tensor:
    """(H, W, D) int32 aggregated volume (non-negative) -> (H, W) float32
    disparities after the scanline optimisation.  gray_a is the volume's
    own eye, gray_b the other (u8); sign = +1 for the left eye's volume,
    -1 for the right's.  H1/H2 are in the volume's cost units
    (`ops.band.agg_cost_scale`).  Kernel B13 (csrc/hslo.cu); it needs an
    (H, W, D) float32 scratch volume for the forward direction."""
    if sign not in (1, -1):
        raise ValueError("dc_hslo_wta: sign must be +1 or -1")
    if kernels.on_cpu(vol):
        return dc_hslo_wta_plain(vol, gray_a, gray_b, num_disp, zero_disp,
                                 T, H1, H2, sign)
    dev = vol.device
    kernels.require(vol, "vol", torch.int32, 3, dev)
    h, w, nd = vol.shape
    if nd != num_disp or not 0 < nd <= 256:
        raise ValueError("dc_hslo_wta: the volume's last axis must be "
                         "num_disp <= 256")
    for name, g in (("gray_a", gray_a), ("gray_b", gray_b)):
        kernels.require(g, name, torch.uint8, 2, dev)
        if g.shape != (h, w):
            raise ValueError(f"dc_hslo_wta: {name} is not (H, W)")
    p1, p2 = tier_penalties(H1, H2)
    fwd = torch.empty((h, w, nd), dtype=F32, device=dev)
    disp = torch.empty((h, w), dtype=F32, device=dev)
    rc = kernels.lib("hslo").stm_hslo_wta(
        vol.data_ptr(), gray_a.data_ptr(), gray_b.data_ptr(), fwd.data_ptr(),
        disp.data_ptr(), h, w, nd, zero_disp, sign, float(T),
        kernels.host_f32(p1), kernels.host_f32(p2), kernels.stream_of(disp))
    kernels.check_launch(rc, "dc_hslo_wta")
    dc_hslo_wta.launches += 1
    return disp
