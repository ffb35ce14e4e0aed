"""The band engine's cost entry, `ci_adcensus_kern_xm` (kernels B2 and
B3 in every mode: the pair volume and its shear or one eye directly;
u8, int16 and float32 costs), its `fast_exp` option and the polynomial
exp of `ops.fastmath`, against the JAX package, its Pallas kernels in
interpret mode on the CPU.

The float32 costs differ from the JAX kernel's by the last ulp of exp at
a few entries (atol 1e-6); the quantized costs agree over the whole
(AD, Hamming) domain but for the rint flips listed in
`test_int16_table_over_the_whole_domain`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu.ops import costkern as jck
from stereo_to_multiview_tpu.ops import fastmath as jfm

from stereo_to_multiview_tpu_torch.ops import costkern as tck
from stereo_to_multiview_tpu_torch.ops import fastmath as tfm

torch.set_num_threads(1)

H, W = 36, 52


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("coeffs", [(10.0, 30.0), (20.0, 30.0),
                                    (10.0, 60.0)])
def test_int16_table_over_the_whole_domain(coeffs):
    """The quantized cost over all 766 x 49 (AD, Hamming) integers equals
    the TPU kernel's float32 expression evaluated with jnp.exp at every
    int16 scale the presets' sweep uses.  At the int16 ceiling XLA's exp
    and torch's differ by an ulp where the scaled cost sits within it of
    .5: those entries, named here, round the other way."""
    ad_coeff, census_coeff = coeffs
    f32 = jnp.float32
    ad = jnp.arange(766, dtype=f32)[:, None]
    ham = jnp.arange(49, dtype=f32)[None, :]
    cost = ((f32(1.0) - jnp.exp(-(ad * f32(0.33333333333))
                                * float(1.0 / ad_coeff)))
            + (f32(1.0) - jnp.exp(-ham * float(1.0 / census_coeff))))
    for q in (255.0, 510.0, 1020.0, 4000.0, 16383.0):
        ref = _np(jnp.rint(cost * f32(q)).astype(jnp.int32))
        got = tck.cost_table(ad_coeff, census_coeff, q)
        assert got.dtype == torch.int16
        got = got.to(torch.int32).numpy().reshape(766, 49)
        flips = {(int(i), int(j)): int(got[i, j] - ref[i, j])
                 for i, j in zip(*np.nonzero(got != ref))}
        want = {}
        if q == 16383.0:
            want = {(10.0, 30.0): {(1, 26): 1, (26, 1): 1},
                    (20.0, 30.0): {(2, 26): 1, (45, 35): 1, (52, 1): 1},
                    (10.0, 60.0): {(26, 2): 1}}[coeffs]
        assert flips == want, (q, flips)


def _xm_inputs(stereo_pair):
    l, r = stereo_pair
    return (jnp.asarray(l), jnp.asarray(r)), (_t(l), _t(r))


@pytest.mark.parametrize("shear", [True, False])
@pytest.mark.parametrize("mode", ["u8", "int16", "float32"])
def test_ci_adcensus_kern_xm_matches_jax(stereo_pair, mode, shear):
    """Every mode of the entry against JAX's: the pair volume and its
    shear, or one eye at a time; u8 (qscale 127) and int16 (qscale 510)
    exact, float32 to the exp ulp; out_rows beyond H repeats the last
    row."""
    (jl, jr), (tl, tr) = _xm_inputs(stereo_pair)
    quant = mode != "float32"
    q = 510.0 if mode == "int16" else 127.0
    kw = dict(quant=quant, out_rows=H + 5, shear=shear, qscale=q)
    ref = jck.ci_adcensus_kern_xm(jl, jr, 10.0, 30.0, 12, 6, interpret=True,
                                  **kw)
    got = tck.ci_adcensus_kern_xm(tl, tr, 10.0, 30.0, 12, 6, **kw)
    want = {"u8": torch.uint8, "int16": torch.int16,
            "float32": torch.float32}[mode]
    for a, b in zip(ref, got):
        assert b.dtype == want and b.shape == (H + 5, W, 12)
        assert _np(a).dtype == b.numpy().dtype
        if quant:
            np.testing.assert_array_equal(_np(a), _np(b))
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
        assert torch.equal(b[H:], b[H - 1:H].expand(5, W, 12))


def test_ci_adcensus_kern_xm_falls_back_per_eye(stereo_pair):
    """A reach max(zd, D - zd) above 64 takes the per-eye path with
    shear=True, silently, as the JAX entry does; the values equal the
    pair path's, and out_rows below H cuts the rows."""
    (jl, jr), (tl, tr) = _xm_inputs(stereo_pair)
    nd, zd = 72, 2
    ref = jck.ci_adcensus_kern_xm(jl, jr, 10.0, 30.0, nd, zd, qscale=510.0,
                                  out_rows=30, interpret=True)
    for shear in (True, False):
        got = tck.ci_adcensus_kern_xm(tl, tr, 10.0, 30.0, nd, zd,
                                      qscale=510.0, out_rows=30,
                                      shear=shear)
        for a, b in zip(ref, got):
            assert b.shape == (30, W, nd)
            np.testing.assert_array_equal(_np(a), _np(b))
    pair = tck.cost_pair(tl, tr, 10.0, 30.0, nd, zd, 510.0)
    m = tck.pair_margin(nd, zd)
    assert torch.equal(pair[:30, m:m + W], got[0])
    assert torch.equal(tck.shear_right(pair, zd)[:30], got[1])


@pytest.mark.parametrize("mode", ["u8", "int16"])
@pytest.mark.parametrize("rows", [(10, 20), (21, 15)])
def test_cost_pair_row_range_is_the_frames(stereo_pair, rows, mode):
    """B2 on a row range of the whole frame's images (a chunk starting
    below row 0, one ending at the frame's last row): the census clamps
    at the frame's edges only, so the volume is those rows of the
    whole-frame volume, and its eyes equal JAX ci_adcensus_kern_xm on the
    JAX band engine's i0:i1 slice (band.py:1148-1155), rows c_lo on."""
    (jl, jr), (tl, tr) = _xm_inputs(stereo_pair)
    start, count = rows
    q = 510.0 if mode == "int16" else 127.0
    nd, zd = 12, 6
    whole = tck.cost_pair(tl, tr, 10.0, 30.0, nd, zd, q)
    pair = tck.cost_pair(tl, tr, 10.0, 30.0, nd, zd, q, rows=rows)
    assert torch.equal(pair, whole[start:start + count])
    i0, i1 = max(0, start - 3), min(H, start + count + 3)
    ref = jck.ci_adcensus_kern_xm(jl[i0:i1], jr[i0:i1], 10.0, 30.0, nd, zd,
                                  qscale=q, interpret=True)
    m = tck.pair_margin(nd, zd)
    got = pair[:, m:m + W], tck.shear_right(pair, zd)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(
            _np(a)[start - i0:start - i0 + count], _np(b))
    # the census of the rows alone would clamp at the range's edges
    cut = tck.cost_pair(tl[start:start + count], tr[start:start + count],
                        10.0, 30.0, nd, zd, q)
    assert not torch.equal(cut, pair)


@pytest.mark.parametrize("eye", ["l", "r"])
def test_cost_pair_row_range_one_eye(stereo_pair, eye):
    """One eye directly over a row range equals those rows of the eye's
    whole-frame volume, and of the pair's eye."""
    _, (tl, tr) = _xm_inputs(stereo_pair)
    rows = (7, 22)
    got = tck.cost_pair(tl, tr, 10.0, 30.0, 12, 6, eye=eye, rows=rows)
    whole = tck.cost_pair(tl, tr, 10.0, 30.0, 12, 6, eye=eye)
    assert torch.equal(got, whole[7:29])
    pair = tck.cost_pair(tl, tr, 10.0, 30.0, 12, 6, rows=rows)
    m = tck.pair_margin(12, 6)
    want = pair[:, m:m + W] if eye == "l" else tck.shear_right(pair, 6)
    assert torch.equal(got, want)


def test_cost_pair_refuses_rows_outside_the_frame(stereo_pair):
    _, (tl, tr) = _xm_inputs(stereo_pair)
    for rows in ((-1, 4), (30, 7), (0, 0)):
        with pytest.raises(ValueError, match="rows"):
            tck.cost_pair(tl, tr, 10.0, 30.0, 12, 6, rows=rows)


def test_ci_adcensus_kern_xm_refuses_what_jax_refuses(stereo_pair):
    _, (tl, tr) = _xm_inputs(stereo_pair)
    with pytest.raises(ValueError, match="padded height"):
        tck.ci_adcensus_kern_xm(tl, tr, 10.0, 30.0, 12, 6, out_rows=129)
    with pytest.raises(ValueError, match="<= 128"):
        tck.ci_adcensus_kern_xm(tl, tr, 10.0, 30.0, 130, 6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tck.ci_adcensus_kern_xm(tl, tr, 10.0, 30.0, 12, 6, ablate_exp=True)


@pytest.mark.parametrize("coeffs", [(10.0, 30.0), (5.0, 15.0), (20.0, 30.0),
                                    (10.0, 60.0), (3.0, 9.0)])
def test_cost_flip_count_matches_jax(coeffs):
    inv = (1.0 / coeffs[0], 1.0 / coeffs[1])
    assert tfm.cost_flip_count(*inv) == jfm.cost_flip_count(*inv)


def test_exp_neg_matches_jax():
    """The polynomial e^-x: the NumPy twin bit-equal to JAX's, the torch
    version to the NumPy twin (no contracted multiply-adds on either),
    JAX's XLA version within an ulp-sized distance."""
    x = np.linspace(0, 40, 4096).astype(np.float32)
    np.testing.assert_array_equal(tfm.exp_neg_np(x), jfm.exp_neg_np(x))
    np.testing.assert_array_equal(tfm.exp_neg(torch.from_numpy(x)).numpy(),
                                  tfm.exp_neg_np(x))
    np.testing.assert_allclose(tfm.exp_neg_np(x),
                               _np(jfm.exp_neg(jnp.asarray(x))), rtol=0,
                               atol=1e-7)
    assert np.abs(tfm.exp_neg_np(x) - np.exp(-x.astype(np.float64))).max() \
        < 1e-6


@pytest.mark.parametrize("coeffs", [(10.0, 30.0), (5.0, 15.0)])
def test_fast_exp_changes_no_value(stereo_pair, coeffs):
    """With fast_exp the JAX kernels take the polynomial (its flip count
    is 0 here), and their u8 costs equal the port's table-based ones; so
    do both cost entries of the port."""
    (jl, jr), (tl, tr) = _xm_inputs(stereo_pair)
    assert jfm.cost_flip_count(1.0 / coeffs[0], 1.0 / coeffs[1]) == 0
    ref = jck.ci_adcensus_kern_xm(jl, jr, *coeffs, 12, 6, fast_exp=True,
                                  interpret=True)
    got = tck.ci_adcensus_kern_xm(tl, tr, *coeffs, 12, 6, fast_exp=True)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a), _np(b))
    ref = jck.ci_adcensus_kern(jl, jr, *coeffs, 12, 6, quant=True,
                               fast_exp=True, interpret=True)
    got = tck.ci_adcensus_kern(tl, tr, *coeffs, 12, 6, quant=True,
                               fast_exp=True)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(a).astype(np.uint8), _np(b))
