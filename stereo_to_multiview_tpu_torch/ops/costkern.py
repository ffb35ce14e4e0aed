"""AD-census cost init: kernels B2 (pair volume, or one eye), B3
(right-eye shear), B16 (both eyes, disparity-major) and B17 (its right eye
as per-plane shifts of the left), with their plain PyTorch versions.

cost_l(x, d) = C(L(x), R(clamp(x + d - zd)))      (left eye)
cost_r(x, d) = C(L(clamp(x - (d - zd))), R(x))    (right eye)

Both eyes come out of ONE pair volume P(x', d) = C(L(clamp(x')),
R(clamp(x' + d - zd))) computed over x' in [-M, W + M), M = max(zd,
D - zd): the left eye is the slice P[:, M:M+W] and the right eye the
per-d shear P[:, x - (d - zd) + M, d].  B2 also computes one eye
directly (margin 0, the other eye's reads at x + sign * (d - zd)), the
JAX package's per-eye mode.  C is the quantized cost rint(qscale *
(a[AD] + c[H])) of the two float32 `cost_terms`: u8 while round(2 *
qscale) <= 255, int16 above (the band_qscale dial), or the float32 sum
itself (quant=False).  The plain version looks it up in `cost_table`,
and so does B2 for u8 and int16; its float32 costs are the terms' sum,
as the table's.  B2 takes the two images of the whole
frame and a row range, and computes the grayscale and the 9x7 census of
the columns it stages itself (clamped at the frame's edges only); its
plain version computes them with `census_transform_9x7(mux_average)`.

Layout: (H, W, D) with D innermost, the layout the lane-major
aggregation reads.

B16 (`cost_dm`) computes both eyes directly, every other-eye read clamped
to the row, into ONE disparity-major (2D, H, W) volume: the left eye on
planes [0, D), the right eye on [D, 2D); u8 costs from the same table, or
float32 costs as the sum of the table's two float32 terms.  Like B2 it
takes the whole frame's images and a row range and computes gray and
census itself (the shared device code of csrc/census.cuh).  Its other
modes give one eye's (D, H, W) planes, or write the right eye's over one
or two column ranges into a given volume.  `ci_adcensus_kern_stacked`
and `ci_adcensus_kern` are the JAX package's entry points on it; with
shift_extract=True the latter takes
the right eye from the left by per-plane shifts (B17, `shear_right_dm`).
`ci_adcensus_kern_xm`, the JAX package's entry of the band engine, runs
on B2 and B3.

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
QSCALE = 127.0       # the default quantization scale: u8 costs <= 254


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


def cost_dtype(qscale: float = QSCALE, quant: bool = True) -> torch.dtype:
    """The cost volume's dtype, by the JAX package's rule
    (costkern.py:418-420): u8 while round(2 * qscale) <= 255, int16
    above, float32 without `quant`.  int16 holds qscale <= 16383 (round(2
    * qscale) <= 32767); beyond it the JAX cast wraps, and this raises."""
    if not quant:
        return F32
    qmax = int(round(2.0 * qscale))
    if not 0.0 < qscale or qmax > 32767:
        raise ValueError(f"band_qscale {qscale}: the quantized costs (up to "
                         f"{qmax}) must fit int16, qscale in (0, 16383]")
    return torch.uint8 if qmax <= 255 else torch.int16


def cost_table(ad_coeff: float, census_coeff: float,
               qscale: float = QSCALE, quant: bool = True) -> torch.Tensor:
    """(766 * 49,) table of the AD-census cost, index AD * 49 + H:
    rint(qscale * (a[AD] + c[H])) of `cost_terms` in float32 with the
    TPU kernel's op order (stereo_to_multiview_tpu/ops/costkern.py:
    309-313), as `cost_dtype`; the float32 sum a[AD] + c[H] without
    `quant`.  Built on the CPU and uploaded by the caller, so every device
    uses the same table."""
    dtype = cost_dtype(qscale, quant)
    a, c = cost_terms(ad_coeff, census_coeff)
    cost = a[:, None] + c[None, :]
    if not quant:
        return cost.reshape(-1)
    q = torch.round(cost * f32(qscale))
    return q.to(torch.int32).to(dtype).reshape(-1)


@functools.lru_cache(maxsize=16)
def device_cost_table(ad_coeff: float, census_coeff: float,
                      device: torch.device, qscale: float = QSCALE,
                      quant: bool = True) -> torch.Tensor:
    """`cost_table` on `device`, built and uploaded once per coefficients,
    scale and device: a copy from host memory waits for the device's
    queue, so a frame must not repeat it."""
    return cost_table(ad_coeff, census_coeff, qscale, quant).to(device)


@functools.lru_cache(maxsize=8)
def device_cost_terms(ad_coeff: float, census_coeff: float,
                      device: torch.device):
    """`cost_terms` on `device`, uploaded once per coefficients and
    device."""
    return tuple(t.to(device) for t in cost_terms(ad_coeff, census_coeff))


def pair_margin(num_disp: int, zero_disp: int) -> int:
    """Columns of the pair volume beyond each image edge."""
    return max(zero_disp, num_disp - zero_disp)


PAIR_EYES = ("pair", "l", "r")


def _pair_geometry(eye: str, num_disp: int, zero_disp: int):
    """(margin, sign, right eye owns the columns) of a `cost_pair` mode:
    the pair volume, or one eye directly."""
    if eye not in PAIR_EYES:
        raise ValueError(f"cost_pair: eye must be one of {PAIR_EYES}, not "
                         f"{eye!r}")
    if eye == "pair":
        return pair_margin(num_disp, zero_disp), 1, False
    return 0, (1 if eye == "l" else -1), eye == "r"


def _row_range(rows, h: int, what: str = "cost_pair"):
    """(start, count) of a `cost_pair` or `cost_dm` row range: every row
    by default."""
    start, count = (0, h) if rows is None else rows
    if not (0 <= start and 0 < count and start + count <= h):
        raise ValueError(f"{what}: rows {rows} are not inside the "
                         f"frame's {h} rows")
    return start, count


def census_rows(img: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """The census codes (count, W, 2) of the frame rows [start, start +
    count) of an (H, W, 3) u8 image, equal to those rows of
    `census_transform_9x7(mux_average(img))`: computed on the rows within
    the census' reach (3), so the reads clamp at the frame's edges only
    (the JAX band engine's i0 = max(0, start - 3) slice)."""
    i0, i1 = max(0, start - 3), min(img.shape[0], start + count + 3)
    cen = census_transform_9x7(mux_average(img[i0:i1]))
    return cen[start - i0:start - i0 + count]


def cost_pair_plain(img_l, img_r, table, num_disp: int, zero_disp: int,
                    eye: str = "pair", rows=None) -> torch.Tensor:
    """Plain version of `cost_pair`: the census of the rows by
    `census_rows`, then one disparity plane at a time, each cost looked
    up in `table` (its dtype is the volume's)."""
    h, w = img_l.shape[:2]
    start, count = _row_range(rows, h)
    dev = img_l.device
    margin, sign, swap = _pair_geometry(eye, num_disp, zero_disp)
    cen_l, cen_r = (census_rows(x, start, count) for x in (img_l, img_r))
    img_l, img_r = img_l[start:start + count], img_r[start:start + count]
    own, oth, own_c, oth_c = ((img_r, img_l, cen_r, cen_l) if swap
                              else (img_l, img_r, cen_l, cen_r))
    xs = torch.arange(-margin, w + margin, device=dev)
    xo = xs.clamp(0, w - 1)
    ov = own[:, xo].to(torch.int32)
    oc = own_c[:, xo]
    rv = oth.to(torch.int32)
    tab = table.to(dev)
    out = torch.empty((count, w + 2 * margin, num_disp), dtype=table.dtype,
                      device=dev)
    for d in range(num_disp):
        xr = (xs + sign * (d - zero_disp)).clamp(0, w - 1)
        ad = (ov - rv[:, xr]).abs().sum(dim=-1)
        ham = hamming48(oc, oth_c[:, xr])
        out[:, :, d] = tab[ad * HAM_VALUES + ham]
    return out


@kernels.kernel_wrapper
def cost_pair(img_l: torch.Tensor, img_r: torch.Tensor, ad_coeff: float,
              census_coeff: float, num_disp: int, zero_disp: int,
              qscale: float = QSCALE, quant: bool = True, eye: str = "pair",
              rows=None) -> torch.Tensor:
    """AD-census cost of two (H, W, 3) u8 images of the whole frame, as
    `cost_dtype(qscale, quant)`, over the frame rows rows=(start, count)
    (every row by default); the census of each eye is that of the whole
    frame (`census_rows`).  eye="pair": the pair volume P (count, W +
    2*M, D), M = pair_margin(D, zd); eye="l" or "r": that eye's (count, W,
    D) volume directly.  Kernel B2 (csrc/cost.cu), which computes the
    grayscale and the census itself."""
    dev = img_l.device
    table = device_cost_table(ad_coeff, census_coeff, dev, qscale, quant)
    if kernels.on_cpu(img_l):
        return cost_pair_plain(img_l, img_r, table, num_disp, zero_disp,
                               eye, rows)
    for name, t in (("img_l", img_l), ("img_r", img_r)):
        kernels.require(t, name, torch.uint8, 3, dev, contiguous=False)
    if img_r.shape != img_l.shape or img_l.shape[2] != 3:
        raise ValueError("cost_pair: expected two (H, W, 3) images of one "
                         "shape")
    if not 0 <= zero_disp <= num_disp:
        raise ValueError("cost_pair: need 0 <= zero_disp <= num_disp")
    h, w = img_l.shape[:2]
    start, count = _row_range(rows, h)
    margin, sign, swap = _pair_geometry(eye, num_disp, zero_disp)
    own, oth = (t.contiguous() for t in ((img_r, img_l) if swap
                                         else (img_l, img_r)))
    a, c = device_cost_terms(ad_coeff, census_coeff, dev)
    out = torch.empty((count, w + 2 * margin, num_disp), dtype=table.dtype,
                      device=dev)
    rc = kernels.lib("cost").stm_cost_pair(
        own.data_ptr(), oth.data_ptr(), table.data_ptr(), a.data_ptr(),
        c.data_ptr(), out.data_ptr(), h, w, num_disp, zero_disp, margin,
        sign, start, count, out.element_size(), kernels.stream_of(out))
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
    """Right-eye volume (H, W, D) from the pair volume (H, W + 2*M, D),
    M = pair_margin(D, zd): out[y, x, d] = pair[y, x - (d - zd) + M, d];
    u8, int16 or float32.  Kernel B3 (csrc/shear.cu)."""
    if kernels.on_cpu(pair):
        return shear_right_plain(pair, zero_disp)
    if pair.dtype not in (torch.uint8, torch.int16, F32):
        raise TypeError(f"shear_right: dtype {pair.dtype}, expected uint8, "
                        f"int16 or float32")
    kernels.require(pair, "pair", pair.dtype, 3, pair.device)
    h, wp, nd = pair.shape
    w = wp - 2 * pair_margin(nd, zero_disp)
    if w <= 0:
        raise ValueError("shear_right: the pair volume must be wider than "
                         "2 * max(zd, D - zd)")
    out = torch.empty((h, w, nd), dtype=pair.dtype, device=pair.device)
    rc = kernels.lib("shear").stm_shear_right(
        pair.data_ptr(), out.data_ptr(), h, w, nd, zero_disp,
        pair.element_size(), kernels.stream_of(out))
    kernels.check_launch(rc, "shear_right")
    shear_right.launches += 1
    return out


# ---- B16: both eyes, disparity-major ------------------------------------

MAX_REACH = 128      # |d - zero_disp| the disparity-major kernel can reach


EYES = {"lr": 0, "l": 1, "r": 2}   # the C entry point's eyes argument


def _dm_columns(eyes: str, cols, w: int):
    """The column ranges of a `cost_dm` mode: the whole row for "lr" and
    "l"; for "r" the one or two ascending, disjoint ranges [x0, x1) of
    `cols`."""
    if eyes not in EYES:
        raise ValueError(f"cost_dm: eyes must be 'lr', 'l' or 'r', not "
                         f"{eyes!r}")
    if eyes != "r":
        if cols is not None:
            raise ValueError("cost_dm: column ranges are for eyes='r' only")
        return ((0, w),)
    ranges = tuple((int(x0), int(x1)) for x0, x1 in cols or ())
    lo = 0
    for x0, x1 in ranges:
        if not lo <= x0 < x1 <= w:
            raise ValueError(f"cost_dm: columns {ranges} are not ascending, "
                             f"disjoint ranges inside [0, {w})")
        lo = x1
    if not 1 <= len(ranges) <= 2:
        raise ValueError("cost_dm: eyes='r' takes one or two column ranges")
    return ranges


def _dm_out(eyes: str, out, num_disp: int, count: int, w: int,
            dtype: torch.dtype, dev) -> torch.Tensor:
    """The volume a `cost_dm` mode writes: a new (2D or D, count, W) one
    for "lr" and "l"; for "r" the caller's (D, count, W) `out`, written in
    place at the ranges' columns."""
    if eyes != "r":
        if out is not None:
            raise ValueError("cost_dm: `out` is for eyes='r' only")
        return torch.empty(((2 if eyes == "lr" else 1) * num_disp, count, w),
                           device=dev, dtype=dtype)
    if out is None:
        raise ValueError("cost_dm: eyes='r' writes into `out`")
    if (tuple(out.shape) != (num_disp, count, w) or out.dtype != dtype
            or out.device != dev):
        raise ValueError(f"cost_dm: out must be a ({num_disp}, {count}, {w}) "
                         f"{dtype} volume on {dev}")
    return out


def cost_dm_plain(img_l, img_r, ad_coeff: float, census_coeff: float,
                  num_disp: int, zero_disp: int, quant: bool = True,
                  eyes: str = "lr", rows=None, cols=None,
                  out=None) -> torch.Tensor:
    """Plain version of `cost_dm`: the census of the rows by
    `census_rows`, then one disparity plane of each eye at a time, the
    cost as the float32 sum of the two `cost_terms` and, with `quant`,
    rint(cost * 127) as u8 (no table)."""
    h, w = img_l.shape[:2]
    start, count = _row_range(rows, h, "cost_dm")
    ranges = _dm_columns(eyes, cols, w)
    dev = img_l.device
    out = _dm_out(eyes, out, num_disp, count, w,
                  torch.uint8 if quant else F32, dev)
    a, c = device_cost_terms(ad_coeff, census_coeff, dev)
    cen_l, cen_r = (census_rows(x, start, count) for x in (img_l, img_r))
    lv, rv = (x[start:start + count].to(torch.int32) for x in (img_l, img_r))

    def emit(own, own_cen, oth, oth_cen, x0, x1, xo, plane):
        ad = (own[:, x0:x1] - oth[:, xo]).abs().sum(dim=-1)
        cost = a[ad] + c[hamming48(own_cen[:, x0:x1], oth_cen[:, xo])]
        if quant:
            cost = torch.round(cost * f32(127.0)).to(torch.int32)
        out[plane, :, x0:x1] = cost.to(out.dtype)

    right = num_disp if eyes == "lr" else 0
    for x0, x1 in ranges:
        xs = torch.arange(x0, x1, device=dev)
        for d in range(num_disp):
            k = d - zero_disp
            if eyes != "r":
                emit(lv, cen_l, rv, cen_r, x0, x1, (xs + k).clamp(0, w - 1),
                     d)
            if eyes != "l":
                emit(rv, cen_r, lv, cen_l, x0, x1, (xs - k).clamp(0, w - 1),
                     right + d)
    return out


@kernels.kernel_wrapper
def cost_dm(img_l: torch.Tensor, img_r: torch.Tensor, ad_coeff: float,
            census_coeff: float, num_disp: int, zero_disp: int,
            quant: bool = True, eyes: str = "lr", rows=None, cols=None,
            out=None) -> torch.Tensor:
    """Disparity-major AD-census cost of two (H, W, 3) u8 images of the
    whole frame over the frame rows rows=(start, count) (every row by
    default), the census of each eye that of the whole frame
    (`census_rows`): a (2D, count, W) volume whose plane d < D is the left
    eye's C(L(x), R(clamp(x + d - zd))), plane D + d the right eye's
    C(L(clamp(x - (d - zd))), R(x)).  u8 rint(127 * cost) with `quant`
    (the values of `cost_pair` + `shear_right`), else float32.  eyes="l"
    gives the left eye's (D, count, W) planes alone; eyes="r" writes the
    right eye's planes over the one or two column ranges cols=((x0, x1),
    ...) into `out`, a (D, count, W) volume, in place, and returns it.
    Kernel B16 (csrc/cost_dm.cu), which computes the grayscale and the
    census itself."""
    if zero_disp > MAX_REACH or num_disp - zero_disp > MAX_REACH:
        raise ValueError("cost_dm reaches at most 128 columns either way: "
                         "need zero_disp <= 128 and num_disp - zero_disp "
                         "<= 128")
    if kernels.on_cpu(img_l):
        return cost_dm_plain(img_l, img_r, ad_coeff, census_coeff, num_disp,
                             zero_disp, quant, eyes, rows, cols, out)
    dev = img_l.device
    for name, t in (("img_l", img_l), ("img_r", img_r)):
        kernels.require(t, name, torch.uint8, 3, dev, contiguous=False)
    if img_r.shape != img_l.shape or img_l.shape[2] != 3:
        raise ValueError("cost_dm: expected two (H, W, 3) images of one "
                         "shape")
    if not 0 <= zero_disp <= num_disp:
        raise ValueError("cost_dm: need 0 <= zero_disp <= num_disp")
    h, w = img_l.shape[:2]
    start, count = _row_range(rows, h, "cost_dm")
    ranges = _dm_columns(eyes, cols, w)
    out = _dm_out(eyes, out, num_disp, count, w,
                  torch.uint8 if quant else F32, dev)
    kernels.require(out, "out", out.dtype, 3, dev)
    if quant:
        tabs = (device_cost_table(ad_coeff, census_coeff, dev).data_ptr(),
                None, None)
    else:
        a, c = device_cost_terms(ad_coeff, census_coeff, dev)
        tabs = (None, a.data_ptr(), c.data_ptr())
    (a0, a1), (b0, b1) = ranges[0], (ranges + ((0, 0),))[1]
    il, ir = img_l.contiguous(), img_r.contiguous()
    rc = kernels.lib("cost_dm").stm_cost_dm(
        il.data_ptr(), ir.data_ptr(), *tabs, out.data_ptr(), h, w, num_disp,
        zero_disp, int(quant), EYES[eyes], start, count, a0, a1, b0, b1,
        kernels.stream_of(out))
    kernels.check_launch(rc, "cost_dm")
    cost_dm.launches += 1
    return out


def _check_jax_reach(num_disp: int, zero_disp: int):
    """The JAX entry points' limit (B16 itself reaches 128 columns either
    way, up to D = 256)."""
    if num_disp > MAX_REACH or zero_disp > MAX_REACH:
        raise ValueError("ci_adcensus_kern supports num_disp/zero_disp "
                         "<= 128")


def ci_adcensus_kern_stacked(img_l: torch.Tensor, img_r: torch.Tensor,
                             ad_coeff: float, census_coeff: float,
                             num_disp: int, zero_disp: int,
                             quant: bool = True) -> torch.Tensor:
    """(H, W, 3) u8 pair -> ONE (2D, H, W) disparity-major cost volume
    (left eye on planes [0, D), right on [D, 2D)), the layout
    `band_aggregate_q_dm` reads; u8 with `quant`, else float32."""
    _check_jax_reach(num_disp, zero_disp)
    return cost_dm(img_l, img_r, ad_coeff, census_coeff, num_disp,
                   zero_disp, quant)


def shear_right_dm_plain(vol: torch.Tensor, zero_disp: int) -> torch.Tensor:
    """Plain version of `shear_right_dm`: one slice copy per plane (none
    where the shift moves the whole row out)."""
    nd, _, w = vol.shape
    out = torch.zeros_like(vol)
    for d in range(nd):
        s = d - zero_disp
        if abs(s) >= w:
            continue
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
                     fast_exp: bool = False, shift_extract: bool = False):
    """(H, W, 3) u8 pair -> ((H, W, D), (H, W, D)) cost volumes: float32,
    or u8 rint(127 * cost) with `quant`.  The kernel's disparity-major
    planes are relaid to D-innermost by one torch copy per eye (the JAX
    package's `moveaxis`).

    `shift_extract`, where `shift_extract_applies` (else the direct path,
    silently, as in the JAX package): B16 computes the left eye alone, B17
    shears it into the right eye, and B16's right-eye mode recomputes the
    border strips [0, M) and [W - M, W), M = max(zd, D - zd), where the
    shifted column leaves the image, both in one launch, in place.  Equal
    to the direct path.
    `fast_exp` changes no value, as in `ci_adcensus_kern_xm`."""
    del fast_exp
    _check_jax_reach(num_disp, zero_disp)
    if not (shift_extract
            and shift_extract_applies(img_l.shape[1], num_disp, zero_disp)):
        vol = ci_adcensus_kern_stacked(img_l, img_r, ad_coeff, census_coeff,
                                       num_disp, zero_disp, quant)
        return (vol[:num_disp].permute(1, 2, 0).contiguous(),
                vol[num_disp:].permute(1, 2, 0).contiguous())
    w = img_l.shape[1]
    args = (img_l, img_r, ad_coeff, census_coeff, num_disp, zero_disp,
            quant)
    vol_l = cost_dm(*args, eyes="l")
    vol_r = shear_right_dm(vol_l, zero_disp)
    m = pair_margin(num_disp, zero_disp)
    cost_dm(*args, eyes="r", cols=((0, m), (w - m, w)), out=vol_r)
    return (vol_l.permute(1, 2, 0).contiguous(),
            vol_r.permute(1, 2, 0).contiguous())


# ---- the band engine's entry: B2 and B3 -------------------------------

def _edge_rows(vol: torch.Tensor, rows: int | None) -> torch.Tensor:
    """The first `rows` rows of an (H, W, D) volume; rows beyond H repeat
    the last one (the JAX kernel edge-pads its image and census planes)."""
    if rows is None:
        return vol
    if rows <= vol.shape[0]:
        return vol[:rows]
    extra = vol[-1:].expand(rows - vol.shape[0], *vol.shape[1:])
    return torch.cat([vol, extra])


def ci_adcensus_kern_xm(img_l: torch.Tensor, img_r: torch.Tensor,
                        ad_coeff: float, census_coeff: float, num_disp: int,
                        zero_disp: int, quant: bool = True,
                        out_rows: int | None = None, shear: bool = True,
                        fast_exp: bool = False, ablate_exp: bool = False,
                        qscale: float = QSCALE):
    """(H, W, 3) u8 pair -> ((H, W, D), (H, W, D)) cost volumes of the
    band engine, as `cost_dtype(qscale, quant)`: the JAX package's entry
    of the same name (costkern.py:366-507).

    shear=True: B2's pair volume and B3's shear (the left eye is a view
    into the pair); where the reach max(zd, D - zd) exceeds 64, silently
    the per-eye path instead, as in the JAX package.  shear=False: B2
    once an eye, directly.  Both give the same values.  out_rows returns
    that many rows (at most the height rounded up to 128, as the JAX
    entry allows); rows beyond H repeat the last row's costs.

    `fast_exp` changes no value: the JAX kernels take the polynomial exp
    only at qscale 127 and only where `fastmath.cost_flip_count` proves
    the u8 costs equal to the exp table's, which is what this computes.
    `ablate_exp` (wrong values by design, a measurement of the TPU
    kernel's exp) raises."""
    del fast_exp
    if ablate_exp:
        raise NotImplementedError(
            "ablate_exp gives wrong costs by design (a measurement of the "
            "TPU kernel's exp); it is not ported (ROADMAP A.3)")
    if num_disp > MAX_REACH or zero_disp > MAX_REACH:
        raise ValueError("ci_adcensus_kern supports num_disp/zero_disp "
                         "<= 128")
    h, w = img_l.shape[:2]
    if out_rows is not None and out_rows > -(-h // 128) * 128:
        raise ValueError("out_rows exceeds the kernel's padded height")
    args = (img_l, img_r, ad_coeff, census_coeff, num_disp, zero_disp,
            qscale, quant)
    m = pair_margin(num_disp, zero_disp)
    if shear and m <= 64:
        pair = cost_pair(*args)
        vols = pair[:, m:m + w], shear_right(pair, zero_disp)
    else:
        vols = cost_pair(*args, eye="l"), cost_pair(*args, eye="r")
    return tuple(_edge_rows(v, out_rows) for v in vols)
