"""The port's rescale transforms, 3x3 median and resampled interlace
against the JAX package, with the numpy golden as arbiter.

The port resamples with index_select + an elementwise lerp (1 - w) * a +
w * b; the JAX package computes the same two-term sums as matmuls with
mostly-zero weight matrices (`ops/scale.py`) or as one-hot selects + the
same lerp (`ops/mux.py`).  Each term is one float32 product and the sum
of two is commutative, so the results are exact unless XLA contracts the
multiply-add; every assert below is exact unless a tolerance is stated.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.golden import stages as golden

from stereo_to_multiview_tpu_torch.ops import (
    filters as tfilters, mux as tmux, scale as tscale)

torch.set_num_threads(1)

SIZES = [((36, 52), (45, 64)),      # up, odd ratio
         ((36, 52), (72, 104)),     # 2x up
         ((37, 53), (18, 26)),      # down, odd input
         ((36, 52), (36, 70)),      # one axis only
         ((20, 31), (33, 17))]      # up and down


def _t(a):
    return torch.from_numpy(np.array(a))


def _u8_close_with_golden(got, ref, gold):
    """Exact against the JAX result, or +-1 on at most 0.1% of the values
    and then equal to the golden there: XLA may contract a lerp's
    multiply-add, which can move a value across the u8 truncation."""
    diff = got != ref
    if diff.any():
        assert np.mean(diff) <= 1e-3
        assert np.all(np.abs(got.astype(int) - ref.astype(int))[diff] == 1)
        np.testing.assert_array_equal(got[diff], gold[diff])


@pytest.mark.parametrize("src,dst", SIZES)
def test_tx_scale_bilinear_matches_jax(src, dst):
    rng = np.random.default_rng(51)
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    ref = np.asarray(jops.tx_scale_bilinear(jnp.asarray(img), *dst))
    got = tscale.tx_scale_bilinear(_t(img), *dst).numpy()
    assert got.shape == (*dst, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, golden.tx_scale_bilinear(img, *dst))
    _u8_close_with_golden(got, ref, golden.tx_scale_bilinear(img, *dst))


@pytest.mark.parametrize("src,dst", SIZES)
def test_tx_scale_nearest_matches_jax(src, dst):
    rng = np.random.default_rng(52)
    img = rng.integers(0, 256, src, dtype=np.uint8)
    ref = np.asarray(jops.tx_scale_nearest(jnp.asarray(img), *dst))
    got = tscale.tx_scale_nearest(_t(img), *dst).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, golden.tx_scale_nearest(img, *dst))


@pytest.mark.parametrize("src,dst", SIZES)
def test_tx_disp_scale_matches_jax(src, dst):
    rng = np.random.default_rng(53)
    disp = (rng.random(src) * 24 - 12).astype(np.float32)
    ref = np.asarray(jops.tx_disp_scale(jnp.asarray(disp), *dst, 2.0))
    got = tscale.tx_disp_scale(_t(disp), *dst, 2.0).numpy()
    assert got.shape == dst and got.dtype == np.float32
    # the golden is the same expression in numpy: exact
    np.testing.assert_array_equal(got,
                                  golden.tx_disp_scale(disp, *dst, 2.0))
    # XLA may contract a lerp's multiply-add: a few ulps of |d| <= 24
    np.testing.assert_allclose(got, ref, rtol=0, atol=4e-6)


def test_resize_is_identity_at_equal_shape():
    img = torch.arange(24, dtype=torch.uint8).reshape(4, 6)
    assert tscale.tx_scale_nearest(img, 4, 6) is img
    assert torch.equal(tscale.resize_bilinear_f32(img, 4, 6), img.float())
    assert torch.equal(tscale.tx_scale_bilinear(img, 4, 6), img)


def test_filter_median_matches_jax():
    """3x3 median on a disparity-like plane with many ties, clamp-to-edge
    borders included: exact (a median selects, it does not compute)."""
    rng = np.random.default_rng(54)
    for shape in ((36, 52), (5, 7), (1, 9)):
        d = rng.integers(-6, 6, shape).astype(np.float32)
        d += (rng.random(shape) < 0.3) * rng.random(shape).astype(np.float32)
        ref = np.asarray(jops.filter_median(jnp.asarray(d)))
        got = tfilters.filter_median(_t(d)).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, golden.filter_median(d))


@pytest.mark.parametrize("num_views", [6, 8])
@pytest.mark.parametrize("dst", [(45, 64), (27, 40), (36, 80)])
def test_mux_multiview_resampled_matches_jax(num_views, dst):
    """The interlace at an output resolution other than the views': every
    view resampled (truncating u8), then the per-subpixel select."""
    rng = np.random.default_rng(55)
    views = rng.integers(0, 256, (num_views, 36, 52, 3), dtype=np.uint8)
    ref = np.asarray(jops.mux_multiview(jnp.asarray(views), *dst, 18.43))
    got = tmux.mux_multiview(_t(views), *dst, 18.43).numpy()
    assert got.shape == (*dst, 3) and got.dtype == np.uint8
    gold = golden.mux_multiview(views, *dst, 18.43)
    np.testing.assert_array_equal(got, gold)
    _u8_close_with_golden(got, ref, gold)
