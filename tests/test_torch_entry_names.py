"""The JAX package's entry names in the port (thin wrappers over the
port's kernels), each held against its JAX entry on the CPU: the Pallas
entries in interpret mode, the rest as plain jnp.

Exact unless a tolerance is stated beside the assert.  On the CPU every
wrapper takes its plain version, which chip_smoke.py holds bit-equal to
the CUDA kernel on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JConfig
from stereo_to_multiview_tpu.ops import postkern as jpost
from stereo_to_multiview_tpu.ops.band import (
    dr_irv_band_chunked as j_irv_chunked)
from stereo_to_multiview_tpu.ops.dibr import (
    dibr_backward_warp_dyn as j_warp_dyn, dibr_dbm as j_dbm)
from stereo_to_multiview_tpu.ops.demux import demux_rgb as j_demux_rgb
from stereo_to_multiview_tpu.ops.hslo import dc_hslo_hwd
from stereo_to_multiview_tpu.ops.hslokern import (
    dc_hslo_wta_kern as j_hslo_kern)
from stereo_to_multiview_tpu.ops.irvkern import (
    irv_round_kern as j_irv_round)
from stereo_to_multiview_tpu.ops.mux import (
    mux_multiview_rows as j_mux_rows)
from stereo_to_multiview_tpu.models import (
    make_process_frame as j_make_process_frame)

from stereo_to_multiview_tpu_torch import models as tmodels
from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.ops import (
    band as tband, dibr as tdibr, filters as tfilters, hslokern as thslo,
    irvkern as tirvkern, mux as tmux, postkern as tpost)
from stereo_to_multiview_tpu_torch.ops.demux import demux_rgb
from stereo_to_multiview_tpu_torch.ops.irv import irv_round

torch.set_num_threads(1)

ND, ZD = 12, 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def disps(stereo_pair):
    h, w = stereo_pair[0].shape[:2]
    rng = np.random.default_rng(41)
    dl = rng.integers(-ZD, ND - ZD, (h, w)).astype(np.float32)
    dr = rng.integers(-ZD, ND - ZD, (h, w)).astype(np.float32)
    return dl, dr


@pytest.mark.parametrize("halo", [None, (-9, 50), (5, 50)])
def test_cross_arms_kern_names(stereo_pair, halo):
    """`cross_arms_kern` and `cross_arms_kern_lr` (B1), without and with
    the halo-shard arguments, against the JAX entries: every row whose
    walk stays in the tensor and inside the frame (where the JAX kernel
    and its XLA op agree; tests/test_torch_arms_halo.py pins the rest)."""
    img_l, img_r = stereo_pair
    h = img_l.shape[0]
    kw = {} if halo is None else dict(row_offset=halo[0], global_h=halo[1])
    args = (6.0, 20.0, 9, 4)
    ref_l, ref_r = (np.asarray(a) for a in jpost.cross_arms_kern_lr(
        jnp.asarray(img_l), jnp.asarray(img_r), *args, interpret=True,
        **kw))
    got_l, got_r = tpost.cross_arms_kern_lr(_t(img_l), _t(img_r), *args,
                                            **kw)
    one = tpost.cross_arms_kern(_t(img_l), *args, **kw)
    np.testing.assert_array_equal(one.numpy(), got_l.numpy())
    g = np.arange(h) + (0 if halo is None else halo[0])
    gh = h if halo is None else halo[1]
    y = np.arange(h)
    rows = ((g >= 0) & (g < gh) & (y - np.minimum(9, np.maximum(g, 0)) >= 0)
            & (y + np.minimum(9, np.maximum(gh - 1 - g, 0)) <= h - 1))
    if halo is None:
        rows[:] = True
    for got, ref in ((got_l, ref_l), (got_r, ref_r)):
        np.testing.assert_array_equal(got.numpy()[:, rows], ref[:, rows])
    with pytest.raises(ValueError):
        tpost.cross_arms_kern(_t(img_l), 6.0, 20.0, 65, 4)


@pytest.mark.parametrize("with_labels", [True, False])
def test_dcc_occl_kern_name(disps, with_labels):
    """`dcc_occl_kern` (B7): labels or occlusion hits of both eyes."""
    dl, dr = disps
    ref = jpost.dcc_occl_kern(jnp.asarray(dl), jnp.asarray(dr), 1.0,
                              with_labels=with_labels, num_disp=ND,
                              zero_disp=ZD, interpret=True)
    got = tpost.dcc_occl_kern(_t(dl), _t(dr), 1.0, with_labels=with_labels,
                              num_disp=ND, zero_disp=ZD)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError):
        tpost.dcc_occl_kern(_t(dl), _t(dr), transposed=True)
    with pytest.raises(ValueError):
        tpost.dcc_occl_kern(_t(dl), _t(dr), num_disp=300, zero_disp=150)


def test_filter_bleed_mask_kern_name():
    """`filter_bleed_mask_kern` (B11) at radius 1, both eyes."""
    rng = np.random.default_rng(43)
    occ = [(rng.random((30, 70)) < p).astype(np.uint8) for p in (0.1, 0.5)]
    ref = jpost.filter_bleed_mask_kern(*map(jnp.asarray, occ), 1,
                                       interpret=True)
    got = tpost.filter_bleed_mask_kern(*map(_t, occ), 1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_filter_bilateral_kern_names(disps):
    """`filter_bilateral_kern(_lr)` (B10): the port's `filter_bilateral`
    exactly, and the JAX kernel to the tolerance tests/
    test_torch_postkern.py states (XLA's float32 exp and torch's may
    differ in the last ulp at some taps)."""
    dl, dr = (d * 0.5 for d in disps)
    got_l, got_r = tpost.filter_bilateral_kern_lr(_t(dl), _t(dr), 3, 5.0,
                                                  10.0, ND)
    one = tpost.filter_bilateral_kern(_t(dl), 3, 5.0, 10.0, ND)
    np.testing.assert_array_equal(one.numpy(), got_l.numpy())
    np.testing.assert_array_equal(
        got_r.numpy(), tfilters.filter_bilateral(_t(dr), 3, 5.0, 10.0).numpy())
    ref_l, ref_r = jpost.filter_bilateral_kern_lr(
        jnp.asarray(dl), jnp.asarray(dr), 3, 5.0, 10.0, ND, interpret=True)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tpost.filter_bilateral_kern(_t(dl), 9, 5.0, 10.0, ND)


def _irv_inputs(stereo_pair, disps):
    img = stereo_pair[0]
    dl, _ = disps
    rng = np.random.default_rng(44)
    outl = (rng.random(dl.shape) < 0.3).astype(np.uint8)
    arms = np.asarray(jops.cross_arms(jnp.asarray(img), 6.0, 20.0, 9, 4))
    return dl, outl, arms


def test_irv_round_kern_name(stereo_pair, disps):
    """`irv_round_kern` (B8 + B9): one round, and one round gated by a
    `need` plane."""
    d, o, arms = _irv_inputs(stereo_pair, disps)
    need = np.zeros(d.shape, bool)
    need[::2] = True
    for nd_ in (None, need):
        ref = j_irv_round(jnp.asarray(d), jnp.asarray(o), jnp.asarray(arms),
                          5, 0.4, ND, ZD, 9, interpret=True,
                          need=None if nd_ is None else jnp.asarray(nd_))
        got = tirvkern.irv_round_kern(_t(d), _t(o), _t(arms), 5, 0.4, ND,
                                      ZD, 9,
                                      need=None if nd_ is None else _t(nd_))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    plain = irv_round(_t(d), _t(o), _t(arms), 5, 0.4, ND, ZD, 9)
    np.testing.assert_array_equal(plain[0].numpy(),
                                  tirvkern.irv_round_kern(
                                      _t(d), _t(o), _t(arms), 5, 0.4, ND,
                                      ZD, 9)[0].numpy())


def test_dr_irv_band_chunked_name(stereo_pair, disps):
    """`dr_irv_band_chunked`: both eyes, rounds over row chunks, early
    stop."""
    d, o, arms = _irv_inputs(stereo_pair, disps)
    d2 = np.flip(d, 1).copy()
    o2 = np.flip(o, 0).copy()
    kw = dict(num_rows=d.shape[0], num_cols=d.shape[1], num_disp=ND,
              zero_disp=ZD, usd=9, lsd=4, irv_iterations=3, irv_thresh_s=5,
              irv_row_chunk=16)
    ref = j_irv_chunked(*map(jnp.asarray, (d, o, d2, o2, arms, arms)),
                        JConfig(**kw), interpret=True)
    got = tband.dr_irv_band_chunked(*map(_t, (d, o, d2, o2, arms, arms)),
                                    PipelineConfig(**kw))
    for (gd, go), (rd, ro) in zip(got, ref):
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(go.numpy(), np.asarray(ro))


@pytest.mark.parametrize("sign", [+1, -1])
def test_dc_hslo_wta_kern_name(stereo_pair, sign):
    """`dc_hslo_wta_kern` (B13) on a W-major volume: exactly the JAX
    scan's WTA (argmin of `dc_hslo_hwd`), and the JAX kernel wherever the
    kernel agrees with its own scan (tests/test_torch_hslo.py pins the
    TPU kernel's first-column difference)."""
    img_l, img_r = stereo_pair
    h, w = img_l.shape[:2]
    rng = np.random.default_rng(45 + sign)
    vol = rng.integers(0, 400, (h, w, ND)).astype(np.int32)
    gl, gr = (np.asarray(jops.mux_average(jnp.asarray(i)))
              for i in (img_l, img_r))
    ga, gb = (gl, gr) if sign > 0 else (gr, gl)
    vol_whd = np.ascontiguousarray(vol.transpose(1, 0, 2))
    ref = j_hslo_kern(jnp.asarray(vol_whd, jnp.float32), jnp.asarray(ga),
                      jnp.asarray(gb), ND, ZD, 15.0, 30.0, 90.0, sign=sign,
                      interpret=True)
    got = thslo.dc_hslo_wta_kern(_t(vol_whd), _t(ga), _t(gb), ND, ZD, 15.0,
                                 30.0, 90.0, sign=sign)
    scan = dc_hslo_hwd(jnp.asarray(vol, jnp.float32), jnp.asarray(gl),
                       jnp.asarray(gr), ND, ZD, 15.0, 30.0, 90.0, sign=sign)
    scan_d = np.asarray(jnp.argmin(scan, axis=2) - ZD).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), scan_d)
    np.testing.assert_array_equal(got.numpy() != np.asarray(ref),
                                  scan_d != np.asarray(ref))
    np.testing.assert_array_equal(
        got.numpy(), thslo.dc_hslo_wta(_t(vol), _t(ga), _t(gb), ND, ZD,
                                       15.0, 30.0, 90.0, sign).numpy())


def test_make_process_frame_and_models_exports(stereo_pair):
    """`make_process_frame` (and `models`' exports, the JAX package's)
    against the JAX function on the XLA engine at xla_agg_qscale 8."""
    img_l, img_r = stereo_pair
    h, w = img_l.shape[:2]
    kw = dict(num_rows=h, num_cols=w, num_rows_out=h, num_cols_out=w,
              num_disp=ND, zero_disp=ZD, usd=7, lsd=3, irv_iterations=2,
              bilateral_radius=2, feather_radius=3, num_views=4,
              engine="xla", xla_agg_qscale=8.0)
    sbs = np.concatenate([img_l, img_r], axis=1)
    ref = j_make_process_frame(JConfig(**kw))(jnp.asarray(sbs))
    fn = tmodels.make_process_frame(PipelineConfig(**kw), device="cpu")
    for g, r in zip(fn(sbs), ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    import stereo_to_multiview_tpu.models as jmodels
    assert set(tmodels.__all__) == set(jmodels.__all__)


def test_demux_rgb_name(stereo_pair):
    img = stereo_pair[0]
    for g, r in zip(demux_rgb(_t(img)), j_demux_rgb(jnp.asarray(img))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_dibr_dbm_name(stereo_pair, disps):
    """`dibr_dbm`: one backward-mapped view, unbounded warps, the feather
    computed or given (op by op: each product rounded)."""
    img_l, img_r = stereo_pair
    dl, dr = (d * 0.75 for d in disps)
    rng = np.random.default_rng(46)
    ml, mr = ((rng.random(dl.shape) < 0.8).astype(np.float32)
              for _ in range(2))
    for shift, fm in ((0.25, None), (0.6, True)):
        feath = None
        if fm:
            feath = np.asarray(jops.dibr.dibr_feather_mask(jnp.asarray(mr),
                                                           4, 3.0))
        ref = j_dbm(*map(jnp.asarray, (img_l, img_r, dl, dr, ml, mr)),
                    shift, 4, 3.0,
                    None if feath is None else jnp.asarray(feath))
        got = tdibr.dibr_dbm(*map(_t, (img_l, img_r, dl, dr, ml, mr)),
                             shift, 4, 3.0,
                             None if feath is None else _t(feath))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mux_multiview_rows(stereo_pair):
    """`ops.mux.mux_multiview_rows`: the interlace of a row shard with the
    global row's phase, against the JAX function and against the rows of
    the whole frame's interlace."""
    rng = np.random.default_rng(47)
    views = rng.integers(0, 256, (5, 30, 20, 3)).astype(np.uint8)
    whole = tmux.mux_multiview(_t(views), 30, 20, 18.43)
    for row0 in (0, 7, 12):
        shard = views[:, row0:row0 + 11]
        got = tmux.mux_multiview_rows(_t(shard), 18.43, row0)
        ref = j_mux_rows(jnp.asarray(shard), 18.43, row0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(),
                                      whole.numpy()[row0:row0 + 11])


@pytest.mark.parametrize("shift", [0.6, -0.4, 1.0])
def test_dibr_backward_warp_dyn(stereo_pair, disps, shift):
    """`ops.dibr.dibr_backward_warp_dyn` (the view axis' warp) against the
    JAX function op by op (each product rounded), and against the
    statically bounded `dibr_backward_warp` with and without `contract`
    on disparities inside the range."""
    img = stereo_pair[0]
    d = disps[0] * 0.9
    rng = np.random.default_rng(48)
    m = (rng.random(d.shape) < 0.8).astype(np.float32)
    ref = j_warp_dyn(jnp.asarray(img), jnp.asarray(m), jnp.asarray(d),
                     jnp.float32(shift), ND, ZD)
    got = tdibr.dibr_backward_warp_dyn(_t(img), _t(m), _t(d), shift, ND, ZD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for contract in (False, True):
        np.testing.assert_array_equal(
            tdibr.dibr_backward_warp_dyn(_t(img), _t(m), _t(d), shift, ND,
                                         ZD, contract).numpy(),
            tdibr.dibr_backward_warp(_t(img), _t(m), _t(d), shift, ND, ZD,
                                     contract).numpy())
