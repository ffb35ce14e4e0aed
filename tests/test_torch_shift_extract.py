"""`ci_adcensus_kern(shift_extract=True)`: kernel B16's one-eye modes
and kernel B17's plain version (`shear_right_dm`) against the JAX
package's shift extraction (Pallas, interpret mode on the CPU) and
against the port's direct path.  The D=128 case sits in
`test_torch_shift_extract_d128.py`, a file of its own for the runner.

On the CPU every wrapper takes its plain version, which chip_smoke.py
holds bit-equal to the CUDA kernel on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu.ops import costkern as jck

from stereo_to_multiview_tpu_torch.ops import costkern as tck

torch.set_num_threads(1)


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _cost_args(left, right, nd, zd):
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    return (l, r, 10.0, 30.0, nd, zd)


@pytest.mark.parametrize("quant", [True, False])
def test_cost_dm_one_eye_modes_are_the_stacked_planes(quant):
    """eyes="l" is the stacked volume's first D planes; eyes="r" writes
    its last D planes at the columns of one or two ranges into the
    given volume, in place, and leaves its other columns as they were;
    on a row range, both are those rows of the whole frame's planes."""
    left, right = _pair(50, 9, 90)
    nd, zd = 16, 10
    args = _cost_args(left, right, nd, zd)
    both = tck.cost_dm(*args, quant)
    assert torch.equal(tck.cost_dm(*args, quant, eyes="l"), both[:nd])
    for cols in (((0, 10),), ((37, 90),), ((0, 90),),
                 ((0, 16), (74, 90)), ((0, 1), (89, 90))):
        vol = torch.full_like(both[nd:], 7)
        got = tck.cost_dm(*args, quant, eyes="r", cols=cols, out=vol)
        assert got is vol
        want = torch.full_like(vol, 7)
        for x0, x1 in cols:
            want[:, :, x0:x1] = both[nd:, :, x0:x1]
        assert torch.equal(vol, want)
    rows = (3, 4)
    part = tck.cost_dm(*args, quant, rows=rows)
    assert torch.equal(part, both[:, 3:7])
    vol = torch.zeros_like(part[nd:])
    tck.cost_dm(*args, quant, eyes="r", rows=rows, cols=((0, 16), (74, 90)),
                out=vol)
    assert torch.equal(vol[:, :, 74:], both[nd:, 3:7, 74:])


def test_cost_dm_refuses_bad_modes():
    left, right = _pair(51, 4, 20)
    args = _cost_args(left, right, 8, 4)
    out = torch.zeros((8, 4, 20), dtype=torch.uint8)
    with pytest.raises(ValueError, match="eyes"):
        tck.cost_dm(*args, eyes="both")
    with pytest.raises(ValueError, match="eyes='r' only"):
        tck.cost_dm(*args, eyes="l", cols=((0, 4),))
    with pytest.raises(ValueError, match="not ascending"):
        tck.cost_dm(*args, eyes="r", cols=((5, 21),), out=out)
    with pytest.raises(ValueError, match="not ascending"):
        tck.cost_dm(*args, eyes="r", cols=((8, 12), (4, 6)), out=out)
    with pytest.raises(ValueError, match="writes into `out`"):
        tck.cost_dm(*args, eyes="r", cols=((0, 4),))
    with pytest.raises(ValueError, match="rows"):
        tck.cost_dm(*args, rows=(2, 3))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("zd", [0, 5, 12])
def test_shear_right_dm_plain(dtype, zd):
    """out[d, y, x] = vol[d, y, x - (d - zd)] inside the row, else 0."""
    rng = np.random.default_rng(52)
    nd, h, w = 12, 3, 30
    vol = torch.from_numpy(rng.integers(1, 250, (nd, h, w))).to(dtype)
    got = tck.shear_right_dm(vol, zd)
    want = torch.zeros_like(vol)
    for d in range(nd):
        for x in range(w):
            xs = x - (d - zd)
            if 0 <= xs < w:
                want[d, :, x] = vol[d, :, xs]
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("w", [1, 15, 17])
def test_shear_right_dm_plain_rows_shorter_than_the_shifts(w):
    """Rows narrower than the largest shift: the planes shifted past the
    row are all 0, the others as above."""
    rng = np.random.default_rng(55)
    nd, zd = 40, 20
    vol = torch.from_numpy(rng.integers(1, 250, (nd, 2, w), dtype=np.uint8))
    got = tck.shear_right_dm(vol, zd)
    want = torch.zeros_like(vol)
    for d in range(nd):
        for x in range(w):
            if 0 <= x - (d - zd) < w:
                want[d, :, x] = vol[d, :, x - (d - zd)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("zd_at", ["0", "D"])
@pytest.mark.parametrize("w", [17, 448])
def test_shear_right_dm_matches_jax_shear(w, zd_at, dtype):
    """B17's plain version against the JAX package's shear (`_shear_right`,
    Pallas, interpret mode) at zd = 0 (every shift >= 0) and zd = D
    (every shift < 0), on a row shorter than one 128-lane chunk and on
    one of 448 columns: equal in every element."""
    nd = 24
    zd = 0 if zd_at == "0" else nd
    rng = np.random.default_rng(56)
    vol = rng.integers(0, 256, (nd, 8, w)).astype(dtype)
    got = tck.shear_right_dm(torch.from_numpy(vol), zd)
    ref = np.asarray(jck._shear_right(jnp.asarray(vol), zd, True))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("quant", [True, False])
def test_shift_extract_matches_jax_and_the_direct_path(quant):
    """(16, 448, 24, 12), as the JAX package's own test: the condition
    holds (448 >= 384 columns, reach 12 <= 64), so the left eye, the shear
    and two 12-column border strips.  Equal to the port's direct path in
    every element; to JAX's shift extraction exactly in u8 and within the
    float32 exp rounding of the two packages otherwise."""
    h, w, nd, zd = 16, 448, 24, 12
    left, right = _pair(53, h, w)
    assert tck.shift_extract_applies(w, nd, zd)
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    got = tck.ci_adcensus_kern(l, r, 10.0, 30.0, nd, zd, quant=quant,
                               shift_extract=True)
    direct = tck.ci_adcensus_kern(l, r, 10.0, 30.0, nd, zd, quant=quant)
    ref = jck.ci_adcensus_kern(jnp.asarray(left), jnp.asarray(right), 10.0,
                               30.0, nd, zd, quant=quant, interpret=True,
                               shift_extract=True)
    for g, dct, rf in zip(got, direct, ref):
        assert g.shape == (h, w, nd)
        assert g.dtype == (torch.uint8 if quant else torch.float32)
        assert torch.equal(g, dct)
        rf = np.asarray(rf).astype(np.float32)
        if quant:
            np.testing.assert_array_equal(g.numpy().astype(np.float32), rf)
        else:
            np.testing.assert_allclose(g.numpy(), rf, rtol=0, atol=2e-6)


@pytest.mark.parametrize("h, w, nd, zd", [(8, 200, 16, 8), (6, 400, 80, 8)])
def test_shift_extract_below_the_condition_takes_the_direct_path(
        monkeypatch, h, w, nd, zd):
    """Under 384 columns, or a reach max(zd, D - zd) above 64, the JAX
    package computes both eyes directly, silently; so does the port: B17
    is never called, and the result is the direct one."""
    left, right = _pair(54, h, w)
    assert not tck.shift_extract_applies(w, nd, zd)

    def no_shear(*args, **kwargs):
        raise AssertionError("the shear ran below the condition")

    monkeypatch.setattr(tck, "shear_right_dm", no_shear)
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    got = tck.ci_adcensus_kern(l, r, 10.0, 30.0, nd, zd, quant=True,
                               shift_extract=True)
    direct = tck.ci_adcensus_kern(l, r, 10.0, 30.0, nd, zd, quant=True)
    assert all(torch.equal(a, b) for a, b in zip(got, direct))


@pytest.mark.parametrize("wrapper", ["cost_dm_left", "shear_right_dm"])
def test_shift_extract_wrappers_reject_other_devices(wrapper):
    """A wrapper takes the plain version only for a CPU tensor; any other
    device launches the kernel or raises, never a silent fallback."""
    def m(*shape, dtype=torch.uint8):
        return torch.empty(shape, dtype=dtype, device="meta")
    calls = {
        "cost_dm_left": lambda: tck.cost_dm(
            m(4, 8, 3), m(4, 8, 3), 10.0, 30.0, 8, 4, eyes="l"),
        "shear_right_dm": lambda: tck.shear_right_dm(m(8, 4, 8), 4),
    }
    with pytest.raises(ValueError, match="CPU or CUDA"):
        calls[wrapper]()
