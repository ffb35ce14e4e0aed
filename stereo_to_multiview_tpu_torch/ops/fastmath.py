"""The polynomial e^-x of the cost kernels' `fast_exp` option, and its
exactness proof over the quantized cost's discrete domain.

The JAX package's cost kernels can swap their two `exp` for a degree-5
`2^t` polynomial with exponent-bit stuffing (~1.7e-7 absolute error),
but only where `cost_flip_count` proves the quantized cost
rint(127 * ((1 - e^-a) + (1 - e^-c))) unchanged over all 766 x 49
integer (AD, Hamming) inputs; elsewhere they keep `exp`.  Either way the
u8 values are those of the exp table, which is what the port computes:
it checks the same proof and keeps its table (`costkern`).
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
