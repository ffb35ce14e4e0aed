"""The port's IRV `need` gating, change frontier and early stop against
the JAX band engine (`irv_round_kern`, `dr_irv_band_chunked`, Pallas in
interpret mode on the CPU).  Everything here is exact: the frontier is an
over-approximation of the pixels whose vote can change, so the gated,
early-stopping loop equals the fixed rounds bit for bit.
"""

import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.ops.band import dr_irv_band_chunked
from stereo_to_multiview_tpu.ops.irvkern import irv_round_kern

from stereo_to_multiview_tpu_torch.ops import irv as tirv
from stereo_to_multiview_tpu_torch.ops.cross import UP, DOWN, LEFT, RIGHT

torch.set_num_threads(1)


def _load(name, *parts):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), *parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    """chip_smoke.py as a module: it holds the mirrors of the gated
    kernels' rules that its comparisons on the card are masked by."""
    return _load("chip_smoke", "chip_smoke.py")


def _t(a):
    return torch.from_numpy(np.array(a))


def _need_fixture():
    """The fixture of the JAX package's test_irv_round_need_mask_exact:
    three outliers, one inside the need region, one in the same 128-row
    segment but outside it, one elsewhere."""
    rng = np.random.default_rng(1234)
    h, w, nd, zd, usd = 256, 64, 12, 6, 5
    disp = rng.integers(-zd, nd - zd, (h, w)).astype(np.float32)
    outl = np.zeros((h, w), np.uint8)
    outl[8, 10] = 1
    outl[120, 10] = 1
    outl[200, 30] = 1
    arms = np.stack([
        np.minimum(usd, np.arange(h))[:, None].repeat(w, 1),
        np.minimum(usd, h - 1 - np.arange(h))[:, None].repeat(w, 1),
        np.minimum(usd, np.arange(w))[None, :].repeat(h, 0),
        np.minimum(usd, w - np.arange(w))[None, :].repeat(h, 0),
    ]).astype(np.int32)
    need = np.zeros((h, w), bool)
    need[:32, :] = True
    return disp, outl, arms, need, (nd, zd, usd)


def test_irv_round_need_matches_irv_round_kern():
    """One round under a sparse `need`: equal to the JAX round kernel
    with the same `need`; need pixels equal the full round, every other
    pixel keeps its state."""
    disp, outl, arms, need, (nd, zd, usd) = _need_fixture()
    ref_d, ref_o = irv_round_kern(jnp.asarray(disp), jnp.asarray(outl),
                                  jnp.asarray(arms), 2, 0.01, nd, zd, usd,
                                  interpret=True, need=jnp.asarray(need))
    args = (_t(disp), _t(outl), _t(arms), 2, 0.01, nd, zd, usd)
    got_d, got_o = tirv.irv_round(*args, need=_t(need))
    np.testing.assert_array_equal(np.asarray(ref_d), got_d.numpy())
    np.testing.assert_array_equal(np.asarray(ref_o), got_o.numpy())
    full_d, full_o = tirv.irv_round(*args)
    assert int(full_o.sum()) < int(outl.sum())     # the round accepts votes
    np.testing.assert_array_equal(full_d.numpy()[:32], got_d.numpy()[:32])
    np.testing.assert_array_equal(full_o.numpy()[:32], got_o.numpy()[:32])
    np.testing.assert_array_equal(got_d.numpy()[32:], disp[32:])
    np.testing.assert_array_equal(got_o.numpy()[32:], outl[32:])


@pytest.mark.parametrize("need_dtype", [torch.bool, torch.uint8])
def test_irv_vote_need_dtypes_agree(need_dtype):
    disp, outl, arms, need, (nd, zd, usd) = _need_fixture()
    ta = _t(arms)
    cnt = tirv.irv_rowspan(_t(disp), _t(outl), ta[LEFT], ta[RIGHT], nd, zd,
                           usd, _t(need).to(need_dtype))
    got = tirv.irv_vote(cnt, _t(disp), _t(outl), ta[UP], ta[DOWN], 2, 0.1,
                        zd, usd, _t(need).to(need_dtype))
    ref = tirv.irv_vote(cnt, _t(disp), _t(outl), ta[UP], ta[DOWN], 2, 0.1,
                        zd, usd, _t(need))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_rowspan_live_covers_every_needed_vote():
    """The row spans the gated kernel computes (chip_smoke's
    `rowspan_live`, which masks its comparison on the card) include
    every span a vote at an outlying need pixel reads: its column, rows
    y - usd .. y + usd.  Rows it skips are read by no such vote.  The
    mirror is exactly the set of rows the gated B9 streams (its runs,
    replayed by tests/test_torch_irvstream.py)."""
    smoke = _chip_smoke()
    stream = _load("irvstream", "tests", "test_torch_irvstream.py")
    rng = np.random.default_rng(7)
    h, w, usd = 200, 150, 9
    need = rng.random((h, w)) < 0.002
    outl = (rng.random((h, w)) < 0.5).astype(np.uint8)
    live = smoke.rowspan_live(_t(need), _t(outl), usd).numpy()
    ys, xs = np.nonzero(need & (outl != 0))
    assert len(ys) > 10 and not live.all()
    for y, x in zip(ys, xs):
        assert live[max(y - usd, 0):y + usd + 1, x].all()
    voter = need & (outl != 0)
    for reach in (usd, 0, 40, 127):
        np.testing.assert_array_equal(
            smoke.rowspan_live(_t(need), _t(outl), reach).numpy(),
            stream.b9_streamed_rows(voter, reach))
    cells = smoke.vote_cells(_t(need), _t(outl)).numpy()
    assert cells.shape == (4, w)
    assert cells.sum() == len({(y // tirv.TILE, x) for y, x in zip(ys, xs)})


def test_dilate_frontier_covers_chebyshev_reach():
    """The frontier holds every pixel within Chebyshev distance usd of a
    changed pixel (the reach of a cross region), at a grain of 8."""
    rng = np.random.default_rng(8)
    h, w = 77, 90
    changed = rng.random((h, w)) < 0.001
    changed[0, 0] = changed[h - 1, w - 1] = True
    for usd in (5, 12, 34):
        got = tirv.dilate_frontier(_t(changed), usd).numpy()
        assert got.shape == (h, w)
        for y, x in zip(*np.nonzero(changed)):
            assert got[max(y - usd, 0):y + usd + 1,
                       max(x - usd, 0):x + usd + 1].all()
    assert not tirv.dilate_frontier(_t(changed), 5).numpy().all()
    assert not tirv.dilate_frontier(_t(np.zeros((h, w), bool)), 5).any()


def _frontier_by_pixel(changed, usd):
    """need[y, x]: some changed pixel lies in an 8x8 block within
    ceil(usd / 8) + 1 blocks of (y // 8, x // 8) on both axes."""
    h, w = changed.shape
    r = -(-usd // 8) + 1
    cy, cx = np.nonzero(changed)
    blocks = np.unique(np.stack([cy // 8, cx // 8], 1), axis=0)
    by, bx = np.mgrid[:h, :w] // 8
    need = np.zeros((h, w), bool)
    for b_y, b_x in blocks:
        need |= np.maximum(abs(by - b_y), abs(bx - b_x)) <= r
    return need


def _frontier_changes(h, w, pattern):
    changed = np.zeros((h, w), bool)
    if pattern == "full":
        changed[:] = True
    elif pattern != "empty":
        changed[{"top": 0, "bottom": h - 1}[pattern.split("-")[0]],
                {"left": 0, "right": w - 1}[pattern.split("-")[1]]] = True
    return changed


@pytest.mark.parametrize("h,w", [(1, 1), (1, 37), (37, 1), (21, 43),
                                 (64, 80), (100, 250)])
@pytest.mark.parametrize("usd", [0, 1, 7, 8, 34, 127])
def test_irv_frontier_matches_per_pixel_definition(h, w, usd):
    """`irv_frontier` (on the CPU: `dilate_frontier` of the changed labels)
    against the per-pixel definition: no change, every pixel changed, and
    one change at each corner."""
    rng = np.random.default_rng(h * w + usd)
    before = rng.integers(0, 3, (h, w)).astype(np.uint8)
    for pattern in ("empty", "full", "top-left", "top-right", "bottom-left",
                    "bottom-right"):
        changed = _frontier_changes(h, w, pattern)
        after = np.where(changed, before ^ 1, before).astype(np.uint8)
        got = tirv.irv_frontier(_t(before), _t(after), usd)
        assert got.dtype == torch.bool and got.shape == (h, w)
        np.testing.assert_array_equal(got.numpy(),
                                      _frontier_by_pixel(changed, usd),
                                      err_msg=pattern)


def _irv_inputs(stereo_pair, usd, share, seed):
    h, w = stereo_pair[0].shape[:2]
    rng = np.random.default_rng(seed)
    arms = [np.asarray(jops.cross_arms(jnp.asarray(img), 6.0, 20.0, usd,
                                       usd // 2)) for img in stereo_pair]
    disp = [rng.integers(-6, 6, (h, w)).astype(np.float32) for _ in range(2)]
    outl = [(rng.random((h, w)) < share).astype(np.uint8) for _ in range(2)]
    return arms, disp, outl


@pytest.mark.parametrize("share,iterations", [(0.3, 6), (0.6, 3), (0.05, 5)])
def test_dr_irv_early_stop_equals_fixed_rounds_and_jax(stereo_pair, share,
                                                        iterations):
    """Early stop + frontier gating: bit-equal to the port's fixed rounds
    and to the JAX band engine's `dr_irv_band_chunked`."""
    usd, nd, zd = 9, 12, 6
    arms, disp, outl = _irv_inputs(stereo_pair, usd, share, 41)
    cfg = JaxConfig(num_rows=disp[0].shape[0], num_cols=disp[0].shape[1],
                    num_disp=nd, zero_disp=zd, usd=usd, lsd=4,
                    irv_iterations=iterations, irv_thresh_s=5,
                    irv_thresh_h=0.4)
    ref = dr_irv_band_chunked(*(jnp.asarray(a) for a in (
        disp[0], outl[0], disp[1], outl[1], arms[0], arms[1])), cfg, True)
    rounds = []
    for eye in range(2):
        args = (_t(disp[eye]), _t(outl[eye]), _t(arms[eye]), 5, 0.4, nd, zd,
                usd, iterations)
        fixed = tirv.dr_irv(*args)
        early = tirv.dr_irv_early_stop(*args, rounds)
        for a, b, c in zip(fixed, early, ref[eye]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(np.asarray(c), b.numpy())
    assert all(1 <= r <= iterations for r in rounds) and len(rounds) == 2


def test_dr_irv_early_stop_stops_at_the_fixpoint():
    """No outlier: the first round changes nothing and is the last."""
    disp = torch.zeros((20, 30))
    outl = torch.zeros((20, 30), dtype=torch.uint8)
    arms = torch.full((4, 20, 30), 3, dtype=torch.int32)
    rounds = []
    d, o = tirv.dr_irv_early_stop(disp, outl, arms, 5, 0.4, 8, 4, 3, 5,
                                  rounds)
    assert rounds == [1] and torch.equal(d, disp) and torch.equal(o, outl)
