"""The polynomial e^-x of the cost kernels' `fast_exp` option, and its
exactness proof over the quantized cost's discrete domain.

The JAX package's cost kernels can swap their two `exp` for a degree-5
`2^t` polynomial with exponent-bit stuffing (~1.7e-7 absolute error),
but only where `cost_flip_count` proves the quantized cost
rint(127 * ((1 - e^-a) + (1 - e^-c))) unchanged over all 766 x 49
integer (AD, Hamming) inputs; elsewhere they keep `exp`.  Either way the
u8 values are those of the exp table, which is what the port computes:
it checks the same proof and keeps its table (`costkern`).

Also `exp_xla`: e^x as XLA's CPU backend evaluates float32 `exp` (the
Cephes reduction and degree-5 polynomial, each step a fused
multiply-add), so the port's copies of the JAX package's XLA float
filters give its CPU values to the bit, on every device.
"""

from __future__ import annotations

import numpy as np
import torch

LOG2E = 1.4426950408889634

# 2^t on [-0.5, 0.5], degree-5 Chebyshev fit: |err| <= 1.8e-7
EXP2_COEF = (1.000000052291761, 0.6931472000679485, 0.2402221165794857,
             0.05550340668100081, 0.00967076787534441,
             0.001339528536407251)


def exp_neg(x: torch.Tensor) -> torch.Tensor:
    """e^-x for float32 x >= 0 (valid to x ~ 80, clamped above): 2^-z with
    z = x * log2(e) split as z = n - t, n integer, t in [-0.5, 0.5]; 2^t
    by the polynomial, 2^-n by exponent-bit stuffing."""
    f = lambda v: torch.tensor(np.float32(v), dtype=torch.float32)
    z = torch.minimum(x.to(torch.float32) * f(LOG2E), f(80.0))
    n = torch.floor(z + f(0.5))
    t = n - z
    p = f(EXP2_COEF[5])
    for c in EXP2_COEF[4::-1]:
        p = p * t + f(c)
    scale = ((127 - n.to(torch.int32)) << 23).view(torch.float32)
    return p * scale


def exp_neg_np(x: np.ndarray) -> np.ndarray:
    """NumPy float32 twin of `exp_neg` (the same op sequence)."""
    f = np.float32
    z = np.minimum(x.astype(f) * f(LOG2E), f(80.0))
    n = np.floor(z + f(0.5)).astype(f)
    t = (n - z).astype(f)
    p = f(EXP2_COEF[5])
    for c in EXP2_COEF[4::-1]:
        p = (p * t + f(c)).astype(f)
    scale = ((127 - n.astype(np.int32)) << 23).view(f)
    return (p * scale).astype(f)


def cost_flip_count(inv_ad: float, inv_cen: float, max_ad: int = 765,
                    max_ham: int = 48) -> int:
    """Number of (AD, Hamming) integer input pairs whose quantized cost
    rint(127 * ((1 - e^-(ad/3 * inv_ad)) + (1 - e^-(ham * inv_cen))))
    differs between float32 `exp` and the polynomial.  0: the polynomial
    is bit-exact over the kernel's whole input domain for these
    coefficients."""
    f = np.float32
    third = f(0.33333333333)
    ad = np.arange(max_ad + 1, dtype=f)
    ham = np.arange(max_ham + 1, dtype=f)
    za = (ad * third).astype(f) * f(inv_ad)
    zc = ham * f(inv_cen)
    ref = np.rint(((f(1.0) - np.exp(za * f(-1.0)).astype(f))[:, None]
                   + (f(1.0) - np.exp(zc * f(-1.0)).astype(f))[None, :])
                  * f(127.0))
    got = np.rint(((f(1.0) - exp_neg_np(za))[:, None]
                   + (f(1.0) - exp_neg_np(zc))[None, :]) * f(127.0))
    return int((ref != got).sum())


# XLA's CPU float32 exp: n = floor(x log2(e) + 1/2) clamped to [-127,
# 127], a = x - n C1 - n C2 (ln 2 = C1 + C2), e^a by a Cephes polynomial,
# times 2^n built in the exponent bits (0 at n = -127)
_LOG2EF = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (b, c tensors or float32 constants):
    the float32 product is exact in float64."""
    wide = lambda v: (v.to(torch.float64) if isinstance(v, torch.Tensor)
                      else float(np.float32(v)))
    return (a.to(torch.float64) * wide(b) + wide(c)).to(torch.float32)


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """e^x of a float32 tensor with the op sequence of XLA's CPU `exp`
    (a subnormal result flushed to 0);
    equal to it to the bit on random inputs in [-87, 5]
    (`tests/test_torch_xla_engine.py`), where torch.exp differs in the
    last ulp at about one input in ten."""
    x = x.to(torch.float32).clamp(float(np.float32(-87.8)),
                                  float(np.float32(88.8)))
    n = torch.floor(fma(x, _LOG2EF, 0.5)).clamp(-127.0, 127.0)
    a = fma(n, -np.float32(_EXP_C1), x)
    a = fma(n, -np.float32(_EXP_C2), a)
    z = fma(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = fma(z, a, c)
    z = 1.0 + fma(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return flush_denormals(z * pow2)


FLT_MIN = float(np.finfo(np.float32).tiny)


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """x with its subnormal values set to 0, as XLA's CPU executables
    run (flush-to-zero): a float32 result below 2^-126 in magnitude."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def contracted_sum(pairs):
    """sum of a * b over the (a, b) pairs, in order, as a jitted XLA CPU
    loop adds a chain of products: each product fused into the running
    sum by a multiply-add, the first two as fma(a0, b0, a1 * b1)."""
    pairs = list(pairs)
    if len(pairs) == 1:
        return pairs[0][0] * pairs[0][1]
    (a0, b0), (a1, b1) = pairs[:2]
    acc = fma(a0, b0, a1 * b1)
    for a, b in pairs[2:]:
        acc = fma(a, b, acc)
    return acc
