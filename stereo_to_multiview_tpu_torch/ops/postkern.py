"""The JAX package's entry names of its post-aggregation Pallas kernels
(stereo_to_multiview_tpu/ops/postkern.py), as thin wrappers over the
port's kernels: B1 (`cross_arms_kern(_lr)`), B7 (`dcc_occl_kern`), B11
(`filter_bleed_mask_kern`) and B10 (`filter_bilateral_kern(_lr)`).

Each takes the JAX entry's arguments.  `interpret` is accepted for that
signature and has no effect: the tensor's device chooses, as in every
wrapper of the port (the plain version for a CPU tensor, the kernel or
an error for a CUDA tensor).  The TPU-layout option `transposed` is
refused: the layouts were the TPU's means, not the contract.
"""

from __future__ import annotations

import torch

from stereo_to_multiview_tpu_torch.ops.cross import cross_arms, cross_arms_lr
from stereo_to_multiview_tpu_torch.ops.dcc import dr_dcc
from stereo_to_multiview_tpu_torch.ops.dibr import dibr_bleed_mask, dibr_occl
from stereo_to_multiview_tpu_torch.ops.filters import filter_bilateral

ARM_ROWS = 64       # the JAX kernel's bound on usd
BILATERAL_RMAX = 8  # the JAX kernel's bound on the radius
DCC_REACH = 128     # the JAX kernel's bound on the disparity reach


def _check_usd(usd: int):
    if usd > ARM_ROWS:
        raise ValueError(f"cross_arms_kern supports usd <= {ARM_ROWS}")


def cross_arms_kern(img: torch.Tensor, ucd: float, lcd: float, usd: int,
                    lsd: int, row_offset: int | None = None,
                    global_h: int | None = None,
                    interpret: bool = False) -> torch.Tensor:
    """(4, H, W) int32 cross arms (UP, DOWN, LEFT, RIGHT) of one image,
    with the halo-shard contract row_offset/global_h: `ops.cross.
    cross_arms` (B1)."""
    _check_usd(usd)
    return cross_arms(img, ucd, lcd, usd, lsd, row_offset, global_h)


def cross_arms_kern_lr(img_l: torch.Tensor, img_r: torch.Tensor, ucd: float,
                       lcd: float, usd: int, lsd: int,
                       row_offset: int | None = None,
                       global_h: int | None = None,
                       interpret: bool = False):
    """(arms_l, arms_r) of both eyes in one launch of B1, each equal to
    `cross_arms_kern` of its image."""
    _check_usd(usd)
    return cross_arms_lr(img_l, img_r, ucd, lcd, usd, lsd, row_offset,
                         global_h)


def dcc_occl_kern(disp_l: torch.Tensor, disp_r: torch.Tensor,
                  thresh: float = 1.0, with_labels: bool = True,
                  num_disp: int | None = None, zero_disp: int | None = None,
                  transposed: bool = False, interpret: bool = False):
    """with_labels=True: the outlier labels (u8 0/1/2) of both eyes
    (`ops.dcc.dr_dcc`); False: the occlusion hits (u8 0/1,
    `ops.dibr.dibr_occl`); both kernel B7.  num_disp/zero_disp bound the
    disparity reach, refused above 128 columns as the JAX kernel does;
    the port's kernel reaches any disparity, so the bound changes no
    value of a disparity inside it."""
    if transposed:
        raise ValueError("dcc_occl_kern: the transposed (W, H) layout is "
                         "the TPU kernel's; the port returns (H, W)")
    if (num_disp is not None and zero_disp is not None
            and max(zero_disp, num_disp - zero_disp) > DCC_REACH):
        raise ValueError("disparity reach exceeds 128 columns")
    if with_labels:
        return dr_dcc(disp_l, disp_r, thresh)
    return dibr_occl(disp_l, disp_r)


def filter_bleed_mask_kern(occl_l: torch.Tensor, occl_r: torch.Tensor,
                           radius: int = 1, interpret: bool = False):
    """(mask_l, mask_r) float32 {0, 1}: the bleed filter and the mask of
    each eye's occlusion hits (`ops.dibr.dibr_bleed_mask`, B11).  The JAX
    kernel takes radius 1 only; B11 takes any radius below the plane's
    sides."""
    return dibr_bleed_mask(occl_l, radius), dibr_bleed_mask(occl_r, radius)


def _check_radius(radius: int, what: str):
    if radius > BILATERAL_RMAX:
        raise ValueError(f"{what} supports radius <= {BILATERAL_RMAX}")


def filter_bilateral_kern(img: torch.Tensor, radius: int, sigma_color: float,
                          sigma_spatial: float, num_disp: int,
                          interpret: bool = False) -> torch.Tensor:
    """The bilateral filter of an (H, W) float32 disparity map in the band
    engine's tap order, radius <= 8 (`ops.filters.filter_bilateral`,
    B10).  `num_disp` is not read, as in the JAX kernel."""
    _check_radius(radius, "filter_bilateral_kern")
    return filter_bilateral(img, radius, sigma_color, sigma_spatial)


def filter_bilateral_kern_lr(disp_l: torch.Tensor, disp_r: torch.Tensor,
                             radius: int, sigma_color: float,
                             sigma_spatial: float, num_disp: int,
                             interpret: bool = False):
    """`filter_bilateral_kern` of both eyes."""
    _check_radius(radius, "filter_bilateral_kern_lr")
    return (filter_bilateral(disp_l, radius, sigma_color, sigma_spatial),
            filter_bilateral(disp_r, radius, sigma_color, sigma_spatial))
