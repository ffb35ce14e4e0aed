"""The row-major bounded warps, kernels B19 (`dibr_warp_views_kern`) and
B20 (`dibr_warp_pair_kern`) by their plain versions, against the JAX
package's kernels (Pallas, interpret mode on the CPU); and the forward
warp (`dibr_forward_warp`, `dibr_dfm`, plain torch everywhere) against
the JAX package and the numpy golden.

On the CPU every wrapper takes its plain version, which chip_smoke.py
holds bit-equal to the CUDA kernel on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.golden import stages as golden
from stereo_to_multiview_tpu.ops import dibr as jdibr, warpkern as jwarp

from stereo_to_multiview_tpu_torch.models.pipeline import _synth_shifts
from stereo_to_multiview_tpu_torch.ops import (
    dibr as tdibr, warpkern as twarp)

torch.set_num_threads(1)

ND, ZD = 12, 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _disparities(stereo_pair, seed, integral, scale=1.0):
    h, w = stereo_pair[0].shape[:2]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        d = rng.integers(-ZD, ND - ZD, (h, w)).astype(np.float32)
        if not integral:
            d += (rng.random((h, w)) * 0.9).astype(np.float32)
        out.append((d * np.float32(scale)).astype(np.float32))
    return out


def _jax_views(l, r, dl, dr, shifts):
    return [np.asarray(v) for v in jwarp.dibr_warp_views_kern(
        *(jnp.asarray(a) for a in (l, r, dl, dr)), shifts, ND, ZD,
        interpret=True)]


@pytest.mark.parametrize("integral", [True, False])
@pytest.mark.parametrize("num_views", [4, 8])
def test_warp_views_kern_matches_jax(stereo_pair, num_views, integral):
    """In-range disparities: exact against the JAX package's unfused warp
    (`dibr_backward_warp`, bounded by the same range, mask of ones).
    Against its TPU kernel the port may differ by exactly 1, and only
    where that kernel departs from `dibr_backward_warp` itself: its lerp
    is a contracted multiply-add there, both products rounded here."""
    l, r = stereo_pair
    dl, dr = _disparities(stereo_pair, 60, integral)
    shifts = _synth_shifts(num_views)
    va, vb = twarp.dibr_warp_views_kern(*(_t(a) for a in (l, r, dl, dr)),
                                        shifts, ND, ZD)
    assert va.shape == (len(shifts), *l.shape) and va.dtype == torch.float32
    ones = jnp.ones(dl.shape, jnp.float32)
    xla_a = np.stack([np.asarray(jops.dibr_backward_warp(
        jnp.asarray(l), ones, jnp.asarray(dr), -s, ND, ZD)) for s in shifts])
    xla_b = np.stack([np.asarray(jops.dibr_backward_warp(
        jnp.asarray(r), ones, jnp.asarray(dl), 1.0 - s, ND, ZD))
        for s in shifts])
    ka, kb = _jax_views(l, r, dl, dr, shifts)
    for got, kern, xla in ((va, ka, xla_a), (vb, kb, xla_b)):
        got = got.numpy()
        np.testing.assert_array_equal(got, xla.astype(np.float32))
        diff = got != kern
        assert np.all(np.abs(got - kern)[diff] == 1)
        assert np.all((xla != kern)[diff])
        assert np.mean(diff) < 3e-2


def test_warp_views_kern_zeros_outside_the_range(stereo_pair):
    """Disparities three times the range: a sample whose offset leaves the
    view's static range is 0 in the JAX kernel, and 0 at exactly the same
    subpixels here; the other subpixels as above."""
    l, r = stereo_pair
    dl, dr = _disparities(stereo_pair, 61, False, scale=3.0)
    shifts = _synth_shifts(8)
    got = twarp.dibr_warp_views_kern(*(_t(a) for a in (l, r, dl, dr)),
                                     shifts, ND, ZD)
    kern = _jax_views(l, r, dl, dr, shifts)
    for g, k in zip(got, kern):
        g = g.numpy()
        zero_k = (k == 0).all(axis=-1)
        assert zero_k.mean() > 0.3
        np.testing.assert_array_equal((g == 0).all(axis=-1), zero_k)
        diff = g != k
        assert np.all(np.abs(g - k)[diff] == 1)


@pytest.mark.parametrize("num_views", [8, 40])
@pytest.mark.parametrize("w", [17, 52])
def test_warp_views_kern_edge_shapes_match_jax(stereo_pair, num_views, w):
    """38 views (one launch for all of them on the card) and W = 17 (a row
    shorter than one 128-lane chunk), on disparities up to twice the
    range: the zeros at exactly the JAX kernel's subpixels, the others
    equal or, where its contracted lerp departs, 1 apart; each view equal
    to B20's pair at its shift."""
    l, r = (a[:16, :w] for a in stereo_pair)
    dl, dr = (d[:16, :w] for d in _disparities(stereo_pair, 67, False,
                                                scale=2.0))
    shifts = _synth_shifts(num_views)
    args = [_t(a) for a in (l, r, dl, dr)]
    got = twarp.dibr_warp_views_kern(*args, shifts, ND, ZD)
    assert got[0].shape == (len(shifts), 16, w, 3)
    for g, k in zip(got, _jax_views(l, r, dl, dr, shifts)):
        g = g.numpy()
        np.testing.assert_array_equal((g == 0).all(axis=-1),
                                      (k == 0).all(axis=-1))
        assert np.all(np.abs(g - k)[g != k] == 1)
    for v in (0, len(shifts) - 1):
        a, b = twarp.dibr_warp_pair_kern(*args, shifts[v], ND, ZD)
        assert torch.equal(a, got[0][v]) and torch.equal(b, got[1][v])


def test_warp_pair_kern_matches_jax_and_views(stereo_pair):
    """B20 is B19 with one view: equal to that view of B19, and to the JAX
    pair kernel up to the same departures by 1."""
    l, r = stereo_pair
    dl, dr = _disparities(stereo_pair, 62, False, scale=2.0)
    shifts = _synth_shifts(8)
    args = [_t(a) for a in (l, r, dl, dr)]
    va, vb = twarp.dibr_warp_views_kern(*args, shifts, ND, ZD)
    for v, s in enumerate(shifts):
        a, b = twarp.dibr_warp_pair_kern(*args, s, ND, ZD)
        assert torch.equal(a, va[v]) and torch.equal(b, vb[v])
    s = shifts[2]
    ref = jwarp.dibr_warp_pair_kern(*(jnp.asarray(x) for x in (l, r, dl, dr)),
                                    s, ND, ZD, interpret=True)
    for g, k in zip((va[2], vb[2]), ref):
        g, k = g.numpy(), np.asarray(k)
        np.testing.assert_array_equal((g == 0).all(axis=-1),
                                      (k == 0).all(axis=-1))
        assert np.all(np.abs(g - k)[g != k] == 1)


def test_offset_range_matches_jax():
    for nd, zd in ((12, 6), (128, 64), (64, 10)):
        for s in _synth_shifts(8):
            for sh in (-s, 1.0 - s):
                assert tdibr.offset_range(-zd, nd - zd, sh) == jwarp._bounds(
                    -zd, nd - zd, sh)


def test_warp_kerns_refuse_reach_beyond_128(stereo_pair):
    """Where the JAX entries raise, the port raises too."""
    l, r = stereo_pair
    dl, dr = _disparities(stereo_pair, 63, True)
    args = [_t(a) for a in (l, r, dl, dr)]
    with pytest.raises(ValueError, match="128-lane"):
        jwarp.dibr_warp_pair_kern(*(jnp.asarray(a) for a in (l, r, dl, dr)),
                                  0.5, 600, 300, interpret=True)
    with pytest.raises(ValueError, match="128-lane"):
        twarp.dibr_warp_pair_kern(*args, 0.5, 600, 300)
    with pytest.raises(ValueError, match="128-lane"):
        twarp.dibr_warp_views_kern(*args, _synth_shifts(8), 400, 0)


def test_warp_views_kern_without_views(stereo_pair):
    l, r = stereo_pair
    dl, dr = _disparities(stereo_pair, 64, True)
    va, vb = twarp.dibr_warp_views_kern(*(_t(a) for a in (l, r, dl, dr)),
                                        (), ND, ZD)
    assert va.shape == vb.shape == (0, *l.shape)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("integral", [True, False])
def test_forward_warp_matches_jax_and_golden(stereo_pair, bounded, integral):
    """The deterministic rule (the largest source x wins, unhit targets
    0) and, with a disparity range, no write from outside it: exact
    against JAX and, unbounded, against the numpy golden."""
    l, _ = stereo_pair
    rng = np.random.default_rng(65)
    disp = rng.integers(-14, 15, l.shape[:2]).astype(np.float32)
    if not integral:
        disp += rng.random(l.shape[:2]).astype(np.float32)
    nd, zd = (ND, ZD) if bounded else (None, None)
    for s in (0.5, -0.3, 1.0, 2.0 / 7.0):
        got = tdibr.dibr_forward_warp(_t(l), _t(disp), s, nd, zd)
        assert got.dtype == torch.uint8 and got.shape == l.shape
        ref = jdibr.dibr_forward_warp(jnp.asarray(l), jnp.asarray(disp), s,
                                      nd, zd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        if not bounded:
            np.testing.assert_array_equal(
                got.numpy(), golden.dibr_forward_warp(l, disp, s))
        assert (got.numpy() == 0).all(axis=-1).any()   # unhit targets


def test_dibr_dfm_matches_jax(stereo_pair):
    l, r = stereo_pair
    h, w = l.shape[:2]
    rng = np.random.default_rng(66)
    dl = rng.integers(-6, 7, (h, w)).astype(np.float32)
    dr = rng.integers(-6, 7, (h, w)).astype(np.float32)
    ml = (rng.random((h, w)) < 0.8).astype(np.float32)
    mr = (rng.random((h, w)) < 0.8).astype(np.float32)
    for s in (0.25, 0.6):
        ref = jdibr.dibr_dfm(*(jnp.asarray(a) for a in (l, r, dl, dr, ml,
                                                         mr)), s)
        got = tdibr.dibr_dfm(*(_t(a) for a in (l, r, dl, dr, ml, mr)), s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("wrapper", ["dibr_warp_views_kern",
                                     "dibr_warp_pair_kern"])
def test_warp_rowmajor_wrappers_reject_other_devices(wrapper):
    """A wrapper takes the plain version only for a CPU tensor; any other
    device launches the kernel or raises, never a silent fallback."""
    img = torch.empty((4, 8, 3), dtype=torch.uint8, device="meta")
    d = torch.empty((4, 8), device="meta")
    shifts = (0.5,) if wrapper == "dibr_warp_views_kern" else 0.5
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(twarp, wrapper)(img, img, d, d, shifts, ND, ZD)
