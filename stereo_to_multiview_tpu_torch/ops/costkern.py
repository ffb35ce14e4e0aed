"""AD-census cost init: kernels B2 (pair volume), B3 (right-eye shear),
B16 (both eyes, disparity-major) and B17 (its right eye as per-plane
shifts of the left), with their plain PyTorch versions.

cost_l(x, d) = C(L(x), R(clamp(x + d - zd)))      (left eye)
cost_r(x, d) = C(L(clamp(x - (d - zd))), R(x))    (right eye)

Both eyes come out of ONE pair volume P(x', d) = C(L(clamp(x')),
R(clamp(x' + d - zd))) computed over x' in [-M, W + M), M = max(zd,
D - zd): the left eye is the slice P[:, M:M+W] and the right eye the
per-d shear P[:, x - (d - zd) + M, d].  C is looked up in the quantized
cost table (`cost_table`), so the kernel and the plain version agree by
construction.

Layout: (H, W, D) with D innermost, the layout the lane-major
aggregation reads.

B16 (`cost_dm`) computes both eyes directly, every other-eye read clamped
to the row, into ONE disparity-major (2D, H, W) volume: the left eye on
planes [0, D), the right eye on [D, 2D); u8 costs from the same table, or
float32 costs as the sum of the table's two float32 terms.  Its other
modes give one eye's (D, H, W) planes, the right eye's over a column
range.  `ci_adcensus_kern_stacked` and `ci_adcensus_kern` are the JAX
package's entry points on it; with shift_extract=True the latter takes
the right eye from the left by per-plane shifts (B17, `shear_right_dm`).

The wrappers take the plain version only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.cost import (
    census_transform_9x7, hamming48)
from stereo_to_multiview_tpu_torch.ops.mux import f32, mux_average

F32 = torch.float32
AD_VALUES = 766      # 3 channels x |0..255|
HAM_VALUES = 49      # 48 census bits


def cost_terms(ad_coeff: float, census_coeff: float):
    """The two float32 terms of the AD-census cost over their integer
    domains: (766,) 1 - e^{-(AD * 0.33333333333) / l_ad} and (49,)
    1 - e^{-H / l_c}, with the TPU kernel's op order
    (stereo_to_multiview_tpu/ops/costkern.py:107-108).  The cost is their
    float32 sum.  Built on the CPU, so every device uses the same
    values (exp differs in the last ulp between devices)."""
    ad = torch.arange(AD_VALUES, dtype=F32)
    ham = torch.arange(HAM_VALUES, dtype=F32)
    a = 1.0 - torch.exp(-(ad * f32(0.33333333333)) * f32(1.0 / ad_coeff))
    c = 1.0 - torch.exp(-ham * f32(1.0 / census_coeff))
    return a, c


def cost_table(ad_coeff: float, census_coeff: float,
               qscale: float = 127.0) -> torch.Tensor:
    """(766 * 49,) u8 table of the quantized AD-census cost, index
    AD * 49 + H:  rint(qscale * (a[AD] + c[H])) of `cost_terms`, in
    float32 with the TPU kernel's op order
    (stereo_to_multiview_tpu/ops/costkern.py:309-313).  Built on the CPU
    and uploaded by the caller, so every device uses the same table."""
    a, c = cost_terms(ad_coeff, census_coeff)
    q = torch.round((a[:, None] + c[None, :]) * f32(qscale))
    return q.to(torch.int32).to(torch.uint8).reshape(-1)


@functools.lru_cache(maxsize=8)
def device_cost_table(ad_coeff: float, census_coeff: float,
                      device: torch.device) -> torch.Tensor:
    """`cost_table` on `device`, built and uploaded once per coefficients
    and device: a copy from host memory waits for the device's queue, so
    a frame must not repeat it."""
    return cost_table(ad_coeff, census_coeff).to(device)


@functools.lru_cache(maxsize=8)
def device_cost_terms(ad_coeff: float, census_coeff: float,
                      device: torch.device):
    """`cost_terms` on `device`, uploaded once per coefficients and
    device."""
    return tuple(t.to(device) for t in cost_terms(ad_coeff, census_coeff))


def pair_margin(num_disp: int, zero_disp: int) -> int:
    """Columns of the pair volume beyond each image edge."""
    return max(zero_disp, num_disp - zero_disp)


def cost_pair_plain(img_l, img_r, cen_l, cen_r, table, num_disp: int,
                    zero_disp: int) -> torch.Tensor:
    """Plain version of `cost_pair`: one disparity plane at a time."""
    h, w = img_l.shape[:2]
    dev = img_l.device
    margin = pair_margin(num_disp, zero_disp)
    xs = torch.arange(-margin, w + margin, device=dev)
    xl = xs.clamp(0, w - 1)
    lv = img_l[:, xl].to(torch.int32)
    lc = cen_l[:, xl]
    rv = img_r.to(torch.int32)
    tab = table.to(dev).to(torch.int64)
    out = torch.empty((h, w + 2 * margin, num_disp), dtype=torch.uint8,
                      device=dev)
    for d in range(num_disp):
        xr = (xs + (d - zero_disp)).clamp(0, w - 1)
        ad = (lv - rv[:, xr]).abs().sum(dim=-1)
        ham = hamming48(lc, cen_r[:, xr])
        out[:, :, d] = tab[ad * HAM_VALUES + ham].to(torch.uint8)
    return out


def pack_bgr(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) u8 -> (H, W) int32 b | g << 8 | r << 16."""
    c = img.to(torch.int32)
    return c[:, :, 0] | (c[:, :, 1] << 8) | (c[:, :, 2] << 16)


@kernels.kernel_wrapper
def cost_pair(img_l: torch.Tensor, img_r: torch.Tensor, cen_l: torch.Tensor,
              cen_r: torch.Tensor, table: torch.Tensor, num_disp: int,
              zero_disp: int) -> torch.Tensor:
    """Pair volume P (H, W + 2*M, D) u8, M = pair_margin(D, zd), of two
    (H, W, 3) u8 images and their (H, W, 2) int32 census codes.  Kernel
    B2 (csrc/cost.cu)."""
    if kernels.on_cpu(img_l):
        return cost_pair_plain(img_l, img_r, cen_l, cen_r, table, num_disp,
                               zero_disp)
    dev = img_l.device
    h, w = img_l.shape[:2]
    for name, t, dt, nd in (("img_l", img_l, torch.uint8, 3),
                            ("img_r", img_r, torch.uint8, 3),
                            ("cen_l", cen_l, torch.int32, 3),
                            ("cen_r", cen_r, torch.int32, 3),
                            ("table", table, torch.uint8, 1)):
        kernels.require(t, name, dt, nd, dev, contiguous=False)
    if (img_r.shape != img_l.shape or img_l.shape[2] != 3
            or cen_l.shape != (h, w, 2) or cen_r.shape != (h, w, 2)
            or table.numel() != AD_VALUES * HAM_VALUES):
        raise ValueError("cost_pair: inconsistent input shapes")
    margin = pair_margin(num_disp, zero_disp)
    lpk, rpk = pack_bgr(img_l), pack_bgr(img_r)
    cl, cr, tab = cen_l.contiguous(), cen_r.contiguous(), table.contiguous()
    out = torch.empty((h, w + 2 * margin, num_disp), dtype=torch.uint8,
                      device=dev)
    rc = kernels.lib("cost").stm_cost_pair(
        lpk.data_ptr(), rpk.data_ptr(), cl.data_ptr(), cr.data_ptr(),
        tab.data_ptr(), out.data_ptr(), h, w, num_disp, zero_disp,
        kernels.stream_of(out))
    kernels.check_launch(rc, "cost_pair")
    cost_pair.launches += 1
    return out


def shear_right_plain(pair: torch.Tensor, zero_disp: int) -> torch.Tensor:
    """Plain version of `shear_right`: one strided slice per d."""
    h, wp, nd = pair.shape
    margin = pair_margin(nd, zero_disp)
    w = wp - 2 * margin
    out = torch.empty((h, w, nd), dtype=pair.dtype, device=pair.device)
    for d in range(nd):
        x0 = margin - (d - zero_disp)
        out[:, :, d] = pair[:, x0:x0 + w, d]
    return out


@kernels.kernel_wrapper
def shear_right(pair: torch.Tensor, zero_disp: int) -> torch.Tensor:
    """Right-eye volume (H, W, D) u8 from the pair volume (H, W + 2*M, D),
    M = pair_margin(D, zd): out[y, x, d] = pair[y, x - (d - zd) + M, d].
    Kernel B3 (csrc/shear.cu)."""
    if kernels.on_cpu(pair):
        return shear_right_plain(pair, zero_disp)
    kernels.require(pair, "pair", torch.uint8, 3, pair.device)
    h, wp, nd = pair.shape
    w = wp - 2 * pair_margin(nd, zero_disp)
    if w <= 0:
        raise ValueError("shear_right: the pair volume must be wider than "
                         "2 * max(zd, D - zd)")
    out = torch.empty((h, w, nd), dtype=torch.uint8, device=pair.device)
    rc = kernels.lib("shear").stm_shear_right(
        pair.data_ptr(), out.data_ptr(), h, w, nd, zero_disp,
        kernels.stream_of(out))
    kernels.check_launch(rc, "shear_right")
    shear_right.launches += 1
    return out


# ---- B16: both eyes, disparity-major ------------------------------------

MAX_REACH = 128      # |d - zero_disp| the disparity-major kernel can reach


EYES = {"lr": 0, "l": 1, "r": 2}   # the C entry point's eyes argument


def _columns(eyes: str, cols, w: int):
    """The output columns [x0, x1) of a `cost_dm` mode: every column
    unless the right eye alone is asked for a range."""
    if eyes not in EYES:
        raise ValueError(f"cost_dm: eyes must be 'lr', 'l' or 'r', not "
                         f"{eyes!r}")
    x0, x1 = (0, w) if cols is None else cols
    if cols is not None and eyes != "r":
        raise ValueError("cost_dm: a column range is for eyes='r' only")
    if not 0 <= x0 < x1 <= w:
        raise ValueError(f"cost_dm: columns [{x0}, {x1}) are not inside "
                         f"[0, {w})")
    return x0, x1


def ci_adcensus_stacked_plain(img_l, img_r, cen_l, cen_r, ad_coeff: float,
                              census_coeff: float, num_disp: int,
                              zero_disp: int, quant: bool = True,
                              eyes: str = "lr", cols=None) -> torch.Tensor:
    """Plain version of `cost_dm`: one disparity plane of each eye at a
    time, the cost as the float32 sum of the two `cost_terms` and, with
    `quant`, rint(cost * 127) as u8 (no table)."""
    h, w = img_l.shape[:2]
    x0, x1 = _columns(eyes, cols, w)
    dev = img_l.device
    a, c = device_cost_terms(ad_coeff, census_coeff, dev)
    xs = torch.arange(x0, x1, device=dev)
    lv, rv = img_l.to(torch.int32), img_r.to(torch.int32)
    out = torch.empty(((2 if eyes == "lr" else 1) * num_disp, h, x1 - x0),
                      device=dev, dtype=torch.uint8 if quant else F32)

    def emit(own, own_cen, oth, oth_cen, xo, plane):
        ad = (own[:, x0:x1] - oth[:, xo]).abs().sum(dim=-1)
        cost = a[ad] + c[hamming48(own_cen[:, x0:x1], oth_cen[:, xo])]
        if quant:
            cost = torch.round(cost * f32(127.0)).to(torch.int32)
        out[plane] = cost.to(out.dtype)

    right = num_disp if eyes == "lr" else 0
    for d in range(num_disp):
        k = d - zero_disp
        if eyes != "r":
            emit(lv, cen_l, rv, cen_r, (xs + k).clamp(0, w - 1), d)
        if eyes != "l":
            emit(rv, cen_r, lv, cen_l, (xs - k).clamp(0, w - 1), right + d)
    return out


@kernels.kernel_wrapper
def cost_dm(img_l: torch.Tensor, img_r: torch.Tensor, cen_l: torch.Tensor,
            cen_r: torch.Tensor, ad_coeff: float, census_coeff: float,
            num_disp: int, zero_disp: int, quant: bool = True,
            eyes: str = "lr", cols=None) -> torch.Tensor:
    """(2D, H, W) disparity-major AD-census cost of two (H, W, 3) u8
    images and their (H, W, 2) int32 census codes: plane d < D is the
    left eye's C(L(x), R(clamp(x + d - zd))), plane D + d the right eye's
    C(L(clamp(x - (d - zd))), R(x)).  u8 rint(127 * cost) with `quant`
    (the values of `cost_pair` + `shear_right`), else float32.  eyes="l"
    gives the left eye's (D, H, W) planes alone, eyes="r" the right eye's,
    over the columns cols=(x0, x1) if given: (D, H, x1 - x0).  Kernel B16
    (csrc/cost_dm.cu)."""
    if num_disp > MAX_REACH or zero_disp > MAX_REACH:
        raise ValueError("ci_adcensus_kern supports num_disp/zero_disp "
                         "<= 128")
    if kernels.on_cpu(img_l):
        return ci_adcensus_stacked_plain(img_l, img_r, cen_l, cen_r,
                                         ad_coeff, census_coeff, num_disp,
                                         zero_disp, quant, eyes, cols)
    dev = img_l.device
    h, w = img_l.shape[:2]
    for name, t, dt in (("img_l", img_l, torch.uint8),
                        ("img_r", img_r, torch.uint8),
                        ("cen_l", cen_l, torch.int32),
                        ("cen_r", cen_r, torch.int32)):
        kernels.require(t, name, dt, 3, dev, contiguous=False)
    if (img_r.shape != img_l.shape or img_l.shape[2] != 3
            or cen_l.shape != (h, w, 2) or cen_r.shape != (h, w, 2)):
        raise ValueError("cost_dm: inconsistent input shapes")
    if not 0 <= zero_disp <= num_disp:
        raise ValueError("cost_dm: need 0 <= zero_disp <= num_disp")
    x0, x1 = _columns(eyes, cols, w)
    lpk, rpk = pack_bgr(img_l), pack_bgr(img_r)
    cl, cr = cen_l.contiguous(), cen_r.contiguous()
    if quant:
        tabs = (device_cost_table(ad_coeff, census_coeff, dev).data_ptr(),
                None, None)
    else:
        a, c = device_cost_terms(ad_coeff, census_coeff, dev)
        tabs = (None, a.data_ptr(), c.data_ptr())
    out = torch.empty(((2 if eyes == "lr" else 1) * num_disp, h, x1 - x0),
                      device=dev, dtype=torch.uint8 if quant else F32)
    rc = kernels.lib("cost_dm").stm_cost_dm(
        lpk.data_ptr(), rpk.data_ptr(), cl.data_ptr(), cr.data_ptr(), *tabs,
        out.data_ptr(), h, w, num_disp, zero_disp, int(quant), EYES[eyes],
        x0, x1, kernels.stream_of(out))
    kernels.check_launch(rc, "cost_dm")
    cost_dm.launches += 1
    return out


def ci_adcensus_kern_stacked(img_l: torch.Tensor, img_r: torch.Tensor,
                             ad_coeff: float, census_coeff: float,
                             num_disp: int, zero_disp: int,
                             quant: bool = True) -> torch.Tensor:
    """(H, W, 3) u8 pair -> ONE (2D, H, W) disparity-major cost volume
    (left eye on planes [0, D), right on [D, 2D)), the layout
    `band_aggregate_q_dm` reads; u8 with `quant`, else float32."""
    return cost_dm(img_l, img_r, census_transform_9x7(mux_average(img_l)),
                   census_transform_9x7(mux_average(img_r)), ad_coeff,
                   census_coeff, num_disp, zero_disp, quant)


def shear_right_dm_plain(vol: torch.Tensor, zero_disp: int) -> torch.Tensor:
    """Plain version of `shear_right_dm`: one slice copy per plane."""
    nd, _, w = vol.shape
    out = torch.zeros_like(vol)
    for d in range(nd):
        s = d - zero_disp
        if s >= 0:
            out[d, :, s:] = vol[d, :, :w - s]
        else:
            out[d, :, :w + s] = vol[d, :, -s:]
    return out


@kernels.kernel_wrapper
def shear_right_dm(vol: torch.Tensor, zero_disp: int) -> torch.Tensor:
    """The right eye's (D, H, W) cost planes, but for their border columns,
    from the left eye's: out[d, y, x] = vol[d, y, x - (d - zd)] where that
    column lies in [0, W), else 0; u8 or float32.  Kernel B17
    (csrc/shear_dm.cu)."""
    if kernels.on_cpu(vol):
        return shear_right_dm_plain(vol, zero_disp)
    if vol.dtype not in (torch.uint8, F32):
        raise TypeError(f"shear_right_dm: dtype {vol.dtype}, expected uint8 "
                        f"or float32")
    kernels.require(vol, "vol", vol.dtype, 3, vol.device)
    nd, h, w = vol.shape
    if not 0 <= zero_disp <= nd:
        raise ValueError("shear_right_dm: need 0 <= zero_disp <= D")
    out = torch.empty_like(vol)
    rc = kernels.lib("shear_dm").stm_shear_dm(
        vol.data_ptr(), out.data_ptr(), h, w, nd, zero_disp,
        vol.element_size(), kernels.stream_of(out))
    kernels.check_launch(rc, "shear_right_dm")
    shear_right_dm.launches += 1
    return out


def shift_extract_applies(w: int, num_disp: int, zero_disp: int) -> bool:
    """The JAX package's condition for the shift extraction: at least 384
    columns and a reach max(zd, D - zd) of at most 64."""
    return w >= 384 and pair_margin(num_disp, zero_disp) <= 64


def ci_adcensus_kern(img_l: torch.Tensor, img_r: torch.Tensor,
                     ad_coeff: float, census_coeff: float, num_disp: int,
                     zero_disp: int, quant: bool = False,
                     shift_extract: bool = False):
    """(H, W, 3) u8 pair -> ((H, W, D), (H, W, D)) cost volumes: float32,
    or u8 rint(127 * cost) with `quant`.  The kernel's disparity-major
    planes are relaid to D-innermost by one torch copy per eye (the JAX
    package's `moveaxis`).

    `shift_extract`, where `shift_extract_applies` (else the direct path,
    silently, as in the JAX package): B16 computes the left eye alone, B17
    shears it into the right eye, and B16's right-eye mode recomputes the
    border strips [0, M) and [W - M, W), M = max(zd, D - zd), where the
    shifted column leaves the image.  Equal to the direct path."""
    if not (shift_extract
            and shift_extract_applies(img_l.shape[1], num_disp, zero_disp)):
        vol = ci_adcensus_kern_stacked(img_l, img_r, ad_coeff, census_coeff,
                                       num_disp, zero_disp, quant)
        return (vol[:num_disp].permute(1, 2, 0).contiguous(),
                vol[num_disp:].permute(1, 2, 0).contiguous())
    w = img_l.shape[1]
    cen_l = census_transform_9x7(mux_average(img_l))
    cen_r = census_transform_9x7(mux_average(img_r))
    args = (img_l, img_r, cen_l, cen_r, ad_coeff, census_coeff, num_disp,
            zero_disp, quant)
    vol_l = cost_dm(*args, eyes="l")
    vol_r = shear_right_dm(vol_l, zero_disp)
    m = pair_margin(num_disp, zero_disp)
    for x0, x1 in ((0, m), (w - m, w)):
        vol_r[:, :, x0:x1] = cost_dm(*args, eyes="r", cols=(x0, x1))
    return (vol_l.permute(1, 2, 0).contiguous(),
            vol_r.permute(1, 2, 0).contiguous())
