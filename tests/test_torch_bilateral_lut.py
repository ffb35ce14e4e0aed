"""A CPU replay of kernel B10's table path (`csrc/bilateral.cu`), held bit
for bit against its plain version `filter_bilateral_plain`.

The CUDA kernel runs only on the card.  The replay follows its loops: the
range weight rw(t) looked up in a table of 128 entries built with the
expression of the direct path, its index floor(|a - s|) read off the bits
of |a - s| + 2^23 added with rounding down (the magic-number add, emulated
here from the exact sum), the direct expression at an index of 128 or more
(a large difference, an infinity or a NaN; a block whose tile is finite
and spans less than 128 never reaches it and skips the check), and each
thread's 4 vertically
adjacent pixels fed from one column of samples, every pixel in its own
dx-outer, dy-inner order with each product and sum rounded on its own.
"""

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.ops import filters

torch.set_num_threads(1)

BILAT_T, BILAT_RY, BIAS = 128, 4, 0x4B000000       # bilateral.cu
F32 = np.float32


def fadd_rd(u, c):
    """float32 u + c rounded toward -inf (__fadd_rd), from the sum taken
    in float64 and rounded down onto the float32 grid."""
    exact = u.astype(np.float64) + np.float64(c)
    r = exact.astype(F32)
    down = r.astype(np.float64) > exact
    return np.where(down, np.nextafter(r, F32(-np.inf)), r).astype(F32)


def table_index(u):
    """The kernel's index: the bits of u + 2^23 (rounded down) minus those
    of 2^23, as uint32."""
    bits = fadd_rd(u, 8388608.0).view(np.uint32)
    return (bits.astype(np.int64) - BIAS) & 0xFFFFFFFF


def range_weight(t, inv_2var, lut_scale):
    """The direct expression on float32 t, as the plain version computes
    it."""
    tt = torch.from_numpy(np.ascontiguousarray(t, dtype=F32))
    return (torch.exp(-(tt * tt) * inv_2var) * lut_scale).numpy()


def replay_bilateral(img, radius, sigma_color, sigma_spatial):
    """bilateral_kernel's arithmetic over the whole image; returns the
    output and the number of taps that took the direct expression."""
    sk, inv_2var, lut_scale = filters._bilateral_constants(
        radius, sigma_color, sigma_spatial)
    table = range_weight(np.arange(BILAT_T, dtype=F32), inv_2var, lut_scale)
    h, w = img.shape
    k = 2 * radius + 1
    nyb = -(-h // BILAT_RY)
    # the staged tile, clamp-to-edge, rows up to whole threads' pixels
    rows = np.clip(np.arange(-radius, nyb * BILAT_RY + radius), 0, h - 1)
    cols = np.clip(np.arange(-radius, w + radius), 0, w - 1)
    p = img.astype(F32)[rows][:, cols]
    a = p[radius:radius + nyb * BILAT_RY, radius:radius + w].reshape(
        nyb, BILAT_RY, w)
    num = np.zeros((nyb, BILAT_RY, w), F32)
    den = np.zeros((nyb, BILAT_RY, w), F32)
    direct = 0
    for c in range(k):                               # dx = c - radius
        for jj in range(BILAT_RY + 2 * radius):      # one column of samples
            s = p[jj:jj + nyb * BILAT_RY:BILAT_RY, c:c + w]
            for i in range(BILAT_RY):
                j = jj - i                           # dy = j - radius
                if not 0 <= j < k:
                    continue
                u = np.abs(np.subtract(a[:, i], s, dtype=F32))
                t = table_index(u)
                in_table = t < BILAT_T
                rw = np.where(in_table, table[np.minimum(t, BILAT_T - 1)],
                              range_weight(np.floor(u), inv_2var, lut_scale))
                direct += int((~in_table).sum())
                wgt = np.multiply(F32(sk[j, c]), rw, dtype=F32)
                num[:, i] = num[:, i] + np.multiply(wgt, s, dtype=F32)
                den[:, i] = den[:, i] + wgt
    out = np.divide(num, den, dtype=F32).reshape(nyb * BILAT_RY, w)[:h]
    return out, direct


def _maps(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":                 # disparities after IRV
        img = rng.integers(-64, 64, (h, w)).astype(F32)
        img[:, : w // 2] = F32(rng.integers(-64, 64))
        return img
    if kind == "fractional":              # differences past the table
        return rng.uniform(-1000.0, 1000.0, (h, w)).astype(F32)
    # |a - s| on integers and one ulp below them, where the floor changes,
    # up to 128: a tile spanning less than 128 takes the table unchecked
    n = rng.integers(1, 128, (h, w)).astype(F32)
    v = np.where(rng.random((h, w)) < 0.5, n, np.nextafter(n, F32(0)))
    ys, xs = np.indices((h, w))
    return np.where((ys + xs) % 2 == 0, F32(0), v).astype(F32)


@pytest.mark.parametrize("kind", ["integer", "fractional", "ulp"])
@pytest.mark.parametrize("radius", [0, 1, 7, 8])
def test_bilateral_table_path_matches_plain(radius, kind):
    """The replay equals `filter_bilateral_plain` bit for bit; fractional
    maps reach the direct expression, the others stay in the table (their
    tiles span less than 128: the kernel's blocks skip the check)."""
    h, w = 23, 37                          # rows: no multiple of 4
    img = _maps(kind, h, w, seed=radius * 10 + len(kind))
    got, direct = replay_bilateral(img, radius, 5.0, 7.0)
    ref = filters.filter_bilateral_plain(torch.from_numpy(img), radius, 5.0,
                                         7.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    if kind == "fractional":
        assert (direct > 0) == (radius > 0)
    else:
        assert direct == 0 and float(img.max() - img.min()) < BILAT_T
    cpu = filters.filter_bilateral(torch.from_numpy(img), radius, 5.0, 7.0)
    np.testing.assert_array_equal(cpu.numpy(), ref)


def test_bilateral_table_index_is_the_floor():
    """The magic-number index equals floor(u) below 2^23, one ulp below
    each integer included, and is 2^23 or more for larger u, infinities
    and NaN (the direct expression's cases)."""
    n = np.arange(1, 4097, dtype=F32)
    u = np.concatenate([n, np.nextafter(n, F32(0)), n + F32(0.5),
                        np.array([0.0, 1e-45, 8388607.5, 8388607.0], F32)])
    np.testing.assert_array_equal(table_index(u), np.floor(u).astype(np.int64))
    big = np.array([8388608.0, 1e9, 3.4e38, np.inf, np.nan], F32)
    assert (table_index(big) >= 1 << 23).all()


def test_bilateral_table_path_with_nan_and_inf():
    """A NaN or an infinity in the map takes the direct expression and
    spreads as in the plain version."""
    img = _maps("integer", 20, 30, seed=3)
    img[5, 7] = np.nan
    img[12, 20] = np.inf
    with np.errstate(invalid="ignore"):
        got, direct = replay_bilateral(img, 3, 5.0, 7.0)
    ref = filters.filter_bilateral_plain(torch.from_numpy(img), 3, 5.0,
                                         7.0).numpy()
    assert direct > 0 and np.isnan(ref).any()
    np.testing.assert_array_equal(got, ref)
