"""Kernel B13: the two-direction scanline optimisation fused with the
first-min WTA, and its plain PyTorch version.

`dc_hslo_wta` takes the band aggregation's (H, W, D) int32 volume and
the two gray images and returns the (H, W) float32 disparities
argmin_d((fwd + bwd) / 2) - zero_disp of `ops.hslo.dc_hslo_hwd`;
`dc_hslo_wta_lr` does so for both eyes in one launch.  The wrapper
(`dc_hslo_wta_eyes`, which counts the launches) takes the plain version
only for a CPU tensor; on a CUDA tensor it launches the kernel or
raises.
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
def dc_hslo_wta_eyes(vols, gray_a: torch.Tensor, gray_b: torch.Tensor,
                     num_disp: int, zero_disp: int, T: float, H1: float,
                     H2: float, sign: int) -> tuple:
    """`dc_hslo_wta` of one or two eyes in one launch of kernel B13
    (csrc/hslo.cu).  vols[0] is the volume of gray_a's eye (gray_b the
    other image, `sign` its convention); vols[1], if given, the other
    eye's, with the grays swapped and -sign.  Returns a tuple of (H, W)
    float32 disparities.  The kernel keeps forward checkpoints every few
    columns in a scratch buffer (1/8 of a float32 volume an eye)."""
    if sign not in (1, -1):
        raise ValueError("dc_hslo_wta: sign must be +1 or -1")
    if not 1 <= len(vols) <= 2:
        raise ValueError("dc_hslo_wta: one or two volumes")
    if kernels.on_cpu(vols[0]):
        grays = ((gray_a, gray_b), (gray_b, gray_a))
        return tuple(dc_hslo_wta_plain(v, *g, num_disp, zero_disp, T, H1,
                                       H2, s)
                     for v, g, s in zip(vols, grays, (sign, -sign)))
    dev = vols[0].device
    for name, vol in zip(("vol", "vol_r"), vols):
        kernels.require(vol, name, torch.int32, 3, dev)
        if vol.shape != vols[0].shape:
            raise ValueError("dc_hslo_wta: the two volumes differ in shape")
    h, w, nd = vols[0].shape
    if nd != num_disp or not 0 < nd <= 256:
        raise ValueError("dc_hslo_wta: the volume's last axis must be "
                         "num_disp <= 256")
    for name, g in (("gray_a", gray_a), ("gray_b", gray_b)):
        kernels.require(g, name, torch.uint8, 2, dev)
        if g.shape != (h, w):
            raise ValueError(f"dc_hslo_wta: {name} is not (H, W)")
    eyes = len(vols)
    lib = kernels.lib("hslo")
    n_ckpt = lib.stm_hslo_scratch(eyes, h, w, nd)
    if n_ckpt < 0:
        raise ValueError("dc_hslo_wta: the frame is too large")
    p1, p2 = tier_penalties(H1, H2)
    ckpt = torch.empty(n_ckpt, dtype=F32, device=dev)
    disp = [torch.empty((h, w), dtype=F32, device=dev) for _ in vols]
    rc = lib.stm_hslo_wta(
        vols[0].data_ptr(), vols[-1].data_ptr(), gray_a.data_ptr(),
        gray_b.data_ptr(), disp[0].data_ptr(), disp[-1].data_ptr(),
        ckpt.data_ptr(), eyes, h, w, nd, zero_disp, sign, float(T),
        kernels.host_f32(p1), kernels.host_f32(p2), kernels.stream_of(ckpt))
    kernels.check_launch(rc, "dc_hslo_wta")
    dc_hslo_wta_eyes.launches += 1
    return tuple(disp)


def dc_hslo_wta(vol: torch.Tensor, gray_a: torch.Tensor,
                gray_b: torch.Tensor, num_disp: int, zero_disp: int,
                T: float, H1: float, H2: float, sign: int) -> torch.Tensor:
    """(H, W, D) int32 aggregated volume (non-negative) -> (H, W) float32
    disparities after the scanline optimisation.  gray_a is the volume's
    own eye, gray_b the other (u8); sign = +1 for the left eye's volume,
    -1 for the right's.  H1/H2 are in the volume's cost units
    (`ops.band.agg_cost_scale`).  Kernel B13 (csrc/hslo.cu), one eye."""
    return dc_hslo_wta_eyes((vol,), gray_a, gray_b, num_disp, zero_disp, T,
                            H1, H2, sign)[0]


def dc_hslo_wta_lr(vol_l: torch.Tensor, vol_r: torch.Tensor,
                   gray_l: torch.Tensor, gray_r: torch.Tensor,
                   num_disp: int, zero_disp: int, T: float, H1: float,
                   H2: float):
    """(disp_l, disp_r): `dc_hslo_wta` of the left eye's volume (sign +1)
    and of the right eye's (sign -1, the grays swapped), in one launch of
    kernel B13."""
    return dc_hslo_wta_eyes((vol_l, vol_r), gray_l, gray_r, num_disp,
                            zero_disp, T, H1, H2, +1)


def dc_hslo_wta_kern(vol_whd: torch.Tensor, gray_a: torch.Tensor,
                     gray_b: torch.Tensor, num_disp: int, zero_disp: int,
                     T: float = 15.0, H1: float = 1.0, H2: float = 3.0,
                     sign: int = +1, interpret: bool = False) -> torch.Tensor:
    """The JAX package's entry name of B13: a (W, H, D) W-major
    aggregated volume -> (H, W) float32 disparities (`dc_hslo_wta` of its
    (H, W, D) view, copied only where that view is not contiguous).
    `interpret` has no effect."""
    vol = vol_whd.transpose(0, 1)
    return dc_hslo_wta(vol if vol.is_contiguous() else vol.contiguous(),
                       gray_a, gray_b, num_disp, zero_disp, T, H1, H2, sign)
