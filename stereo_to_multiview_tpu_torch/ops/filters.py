"""Post filters: lifting Gaussian (the mask feather's plain version; its
kernel G1 is `ops.dibr.dibr_feather_mask`), bilateral (kernel B10
and its plain PyTorch version up to radius 8, the XLA filter's order
above), 3x3 median, bleed.

Float constants are float32 and every accumulation runs in the JAX
package's order, so the results match it to the last bit wherever its
compiler does not contract a multiply-add.  The bilateral's wrapper
takes the plain version only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.fastmath import (
    contracted_sum, exp_xla, flush_denormals)
from stereo_to_multiview_tpu_torch.ops.cost import clamp_index
from stereo_to_multiview_tpu_torch.ops.mux import f32

F32 = torch.float32


def gaussian_kernel_2d(radius: int, sigma: float) -> np.ndarray:
    """(2r+1)^2 float32 Gaussian exp(-(x^2+y^2)/2s^2) / (2 pi s^2)."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1].astype(np.float32)
    var = np.float32(sigma) ** 2
    num = np.exp(-(x * x + y * y) / (np.float32(2) * var))
    return (num / (np.float32(2 * np.pi) * var)).astype(np.float32)


def edge_pad(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Clamp-to-edge pad of an (H, W) plane by `radius` on every side."""
    h, w = img.shape
    rows = clamp_index(h, -radius, h + radius, img.device)
    cols = clamp_index(w, -radius, w + radius, img.device)
    return img[rows][:, cols]


def gaussian_lift_constants(radius: int, sigma: float):
    """(taps, post) of `filter_gaussian_lift`: the 2r + 1 one-dimensional
    taps and the factor scale / k2d_sum, each computed in float64 and
    rounded to float32 once, as the JAX package's filter makes them."""
    k1 = np.exp(-(np.arange(-radius, radius + 1, dtype=np.float64) ** 2)
                / (2.0 * float(sigma) ** 2))
    k2d_sum = float(gaussian_kernel_2d(radius, sigma).astype(np.float64).sum())
    scale = 1.0 / (2.0 * np.pi * float(sigma) ** 2)
    return k1.astype(np.float32), np.float32(scale / k2d_sum)


def filter_gaussian_lift(img: torch.Tensor, radius: int, sigma: float,
                         contract: bool = False):
    """out = max(input, gaussian_blur(input)), clamp-to-edge, normalized
    by the full 2D kernel sum; the blur runs as an x pass then a y pass
    with float32 taps.  With `contract` each pass adds its products as
    the JAX package's jitted CPU executable does
    (`fastmath.contracted_sum`); otherwise each product is rounded, as
    its op-by-op evaluation and the feather kernel do."""
    k1, post = gaussian_lift_constants(radius, sigma)
    a = img.to(F32)
    p = edge_pad(a, radius)
    h, w = img.shape
    if contract:
        acc_r = contracted_sum((f32(kv), p[:, j:j + w])
                               for j, kv in enumerate(k1))
        acc = contracted_sum((f32(kv), acc_r[i:i + h])
                             for i, kv in enumerate(k1))
        return torch.maximum(a, acc * f32(post))
    acc_r = torch.zeros((h + 2 * radius, w), dtype=F32, device=img.device)
    for j, kv in enumerate(k1):
        acc_r = acc_r + f32(kv) * p[:, j:j + w]
    acc = torch.zeros((h, w), dtype=F32, device=img.device)
    for i, kv in enumerate(k1):
        acc = acc + f32(kv) * acc_r[i:i + h]
    return torch.maximum(a, acc * f32(post))


def _bilateral_constants(radius: int, sigma_color: float,
                         sigma_spatial: float):
    """(spatial taps (2r+1)^2 float32, inv_2var, lut_scale): constants in
    float64, rounded to float32 once, as the band engine's bilateral
    kernel (stereo_to_multiview_tpu/ops/postkern.py `_bilat_kernel`)
    makes them."""
    sk = gaussian_kernel_2d(radius, sigma_spatial)
    var = float(np.float32(sigma_color)) ** 2
    lut_scale = f32(1.0 / float(np.sqrt(2 * np.pi * var)))
    inv_2var = f32(1.0 / (2.0 * var))
    return sk, inv_2var, lut_scale


@functools.lru_cache(maxsize=16)
def _bilateral_host_args(radius: int, sigma_color: float,
                         sigma_spatial: float):
    """B10's host arguments (the spatial taps as a host float32 array,
    inv_2var, lut_scale), built once for each setting: the kernel copies
    the taps at each call, so one array serves every call."""
    sk, inv_2var, lut_scale = _bilateral_constants(radius, sigma_color,
                                                   sigma_spatial)
    return (kernels.host_f32(sk.reshape(-1)), float(inv_2var),
            float(lut_scale))


def _bilateral_sum(img: torch.Tensor, radius: int, sk, inv_2var,
                   lut_scale, taps) -> torch.Tensor:
    """The bilateral's weighted mean, one shifted plane per tap, the taps
    ((dx, dy) pairs) accumulated in the order given."""
    h, w = img.shape
    a = img.to(F32)
    p = edge_pad(a, radius)
    num = torch.zeros((h, w), dtype=F32, device=img.device)
    den = torch.zeros((h, w), dtype=F32, device=img.device)
    for dx, dy in taps:
        s = p[dy + radius:dy + radius + h, dx + radius:dx + radius + w]
        t = torch.floor((a - s).abs())
        rw = torch.exp(-(t * t) * inv_2var) * lut_scale
        wgt = f32(sk[dy + radius, dx + radius]) * rw
        num = num + wgt * s
        den = den + wgt
    return num / den


def filter_bilateral_plain(img: torch.Tensor, radius: int,
                           sigma_color: float,
                           sigma_spatial: float) -> torch.Tensor:
    """Plain version of `filter_bilateral` up to radius 8: the band
    kernel's constants and tap order (dx outer, dy inner)."""
    sk, inv_2var, lut_scale = _bilateral_constants(radius, sigma_color,
                                                   sigma_spatial)
    r = range(-radius, radius + 1)
    return _bilateral_sum(img, radius, sk, inv_2var, lut_scale,
                          [(dx, dy) for dx in r for dy in r])


@functools.lru_cache(maxsize=16)
def _range_weights_xla(inv_2var: float) -> torch.Tensor:
    """exp_xla(-(t * t) * inv_2var) for the integers t = 0, 1, ... up to
    the first whose argument reaches -87.8, where XLA's exp is 0 and stays
    0 (the table's last entry): the bilateral's range weight by its
    integer index t, the same values as evaluating it tap by tap."""
    t = 0
    while float(np.float32(t * t) * np.float32(inv_2var)) < 87.8:
        t += 1
    ts = torch.arange(t + 1, dtype=F32)
    return exp_xla(-(ts * ts) * f32(inv_2var))


def filter_bilateral_wide(img: torch.Tensor, radius: int,
                          sigma_color: float, sigma_spatial: float,
                          contract: bool = True) -> torch.Tensor:
    """The bilateral filter as the JAX package's XLA filter computes it
    (stereo_to_multiview_tpu/ops/filters.py `filter_bilateral`), the one
    its band engine runs above radius 8 and its XLA engine at every
    radius, in the order its jitted CPU executable evaluates it: taps dy
    outer, dx inner; sigma_color squared in float32; each tap's weight
    e^{-t^2 / 2 s_c^2} times one float32 constant, the range scale times
    the spatial tap (XLA folds the two); the exp as XLA's CPU `exp`
    (`fastmath.exp_xla`); subnormal weights flushed to 0, as XLA's CPU
    executables run; the numerator's products added with fused
    multiply-adds (`fastmath.contracted_sum`), the weights added
    plainly.  Equal to the JAX package's CPU values to the bit.  With
    contract=False, the order of its op-by-op evaluation instead: the
    spatial tap times (range weight times range scale), each product
    rounded.  Plain torch on every device: no TPU kernel runs there."""
    var = np.float32(sigma_color) ** 2
    lut_scale = np.float32(1.0 / float(np.sqrt(2 * np.pi * var)))
    inv_2var = f32(1.0 / (2.0 * float(var)))
    sk = gaussian_kernel_2d(radius, sigma_spatial)
    h, w = img.shape
    a = img.to(F32)
    p = edge_pad(a, radius)
    table = _range_weights_xla(float(inv_2var)).to(img.device)
    weights, samples = [], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            s = p[dy + radius:dy + radius + h, dx + radius:dx + radius + w]
            t = torch.floor((a - s).abs()).clamp(max=len(table) - 1)
            rw = table[t.to(torch.int64)]
            tap = np.float32(sk[dy + radius, dx + radius])
            weights.append(flush_denormals(
                rw * f32(lut_scale * tap) if contract else
                f32(tap) * (rw * f32(lut_scale))))
            samples.append(s)
    den = weights[0]
    for wgt in weights[1:]:
        den = den + wgt
    if contract:
        return contracted_sum(zip(weights, samples)) / den
    num = weights[0] * samples[0]
    for wgt, s in zip(weights[1:], samples[1:]):
        num = num + wgt * s
    return num / den


@kernels.kernel_wrapper
def filter_bilateral(img: torch.Tensor, radius: int, sigma_color: float,
                     sigma_spatial: float) -> torch.Tensor:
    """Edge-preserving smoothing of a float disparity map: spatial weight
    from the 2D Gaussian, range weight exp(-t^2 / 2 s_c^2) / sqrt(2 pi
    s_c^2) at t = floor(|center - sample|); clamp-to-edge.

    Up to radius 8 the tap order (dx outer, dy inner) is that of the band
    engine's bilateral kernel, the one on the main path: the result feeds
    trunc() in the occlusion test, so an ulp matters there.  Kernel B10
    (csrc/bilateral.cu).  Above radius 8 the band engine runs the XLA
    filter instead, and so does the port: `filter_bilateral_wide`, on
    either device."""
    if radius > 8:
        return filter_bilateral_wide(img, radius, sigma_color,
                                     sigma_spatial)
    if kernels.on_cpu(img):
        return filter_bilateral_plain(img, radius, sigma_color,
                                      sigma_spatial)
    kernels.require(img, "img", F32, 2, img.device)
    if radius < 0:
        raise ValueError("filter_bilateral: radius must be >= 0")
    taps, inv_2var, lut_scale = _bilateral_host_args(
        radius, float(sigma_color), float(sigma_spatial))
    h, w = img.shape
    out = torch.empty_like(img)
    rc = kernels.lib("bilateral").stm_bilateral(
        img.data_ptr(), out.data_ptr(), taps, h, w, radius, inv_2var,
        lut_scale, kernels.stream_of(out))
    kernels.check_launch(rc, "filter_bilateral")
    filter_bilateral.launches += 1
    return out


# Median of nine as 19 compare-exchanges (Paeth's network): after them
# element 4 holds the median.
_MEDIAN9 = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
            (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
            (4, 2), (6, 4), (4, 2))


def filter_median(img: torch.Tensor) -> torch.Tensor:
    """3x3 median of an (H, W) plane, clamp-to-edge, as elementwise
    minimum/maximum exchanges of the nine shifted planes."""
    h, w = img.shape
    p = edge_pad(img, 1)
    v = [p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    for a, b in _MEDIAN9:
        v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
    return v[4]


def _bleed_index(n: int, off: int, device) -> torch.Tensor:
    """Source index of the bleed filter's edge rule: i + off, negative
    coordinates mirrored (s -> -s), coordinates past the end mapped to
    n - 1 - off (the offset is subtracted: a reference quirk)."""
    s = torch.arange(n, device=device) + off
    s = torch.where(s < 0, -s, s)
    return torch.where(s > n - 1, n - 1 - off, s)


def filter_bleed(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary-mask dilation: 1 where more than 30% of the (2r+1)^2
    neighbourhood is non-zero, else the input value (u8)."""
    h, w = img.shape
    ksz = (2 * radius + 1) ** 2
    nz = (img > 0).to(torch.int32)
    cnt = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    for dy in range(-radius, radius + 1):
        row = nz[_bleed_index(h, dy, img.device)]
        for dx in range(-radius, radius + 1):
            cnt = cnt + row[:, _bleed_index(w, dx, img.device)]
    return torch.where(cnt.to(F32) > f32((ksz - 1) * 0.30), 1,
                       img.to(torch.uint8))
