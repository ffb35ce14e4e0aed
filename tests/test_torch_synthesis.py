"""The synthesis of process_frame on the CPU: the port's
`synthesize_interlace` (B12's interlace mode; on the CPU its plain
version) against the JAX package's unfused chain and its band-engine
chain, the mask feather (G1) against the JAX filter, the interlace's
per-row view term against the JAX view pattern, and numpy replays of
the two kernels' index logic (flat output blocks and their staged
stores; tiles, halos and clamps) against their plain versions.

Exact unless a tolerance is stated beside the assert.  The inputs are
numpy arrays from seeds: a crop of the bud pair and fractional
disparities inside the configuration's range.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
from stereo_to_multiview_tpu.models import pipeline as jpipe
from stereo_to_multiview_tpu.ops import dibr as jdibr
from stereo_to_multiview_tpu.ops import mux as jmux

from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.models import pipeline as tpipe
from stereo_to_multiview_tpu_torch.ops import (
    dibr as tdibr, filters as tfilters, mux as tmux)
from stereo_to_multiview_tpu_torch.ops.scale import lerp_taps
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
H, W, ND, ZD = 36, 52, 12, 6
F32 = np.float32
BASE = JaxConfig(num_rows=H, num_cols=W, num_rows_out=H, num_cols_out=W,
                 num_disp=ND, zero_disp=ZD, num_views=8, engine="xla",
                 bilateral_radius=2, feather_radius=3)
CASES = {
    "identity": BASE,
    "resampled 72x104": BASE.replace(num_rows_out=72, num_cols_out=104),
    "shrunk 27x40": BASE.replace(num_rows_out=27, num_cols_out=40),
    "resampled 36x70 (rows at identity)": BASE.replace(num_cols_out=70),
    "bleed_radius 2": BASE.replace(bleed_radius=2),
    "feather_radius 10": BASE.replace(feather_radius=10),
    "2 views": BASE.replace(num_views=2),
    "3 views": BASE.replace(num_views=3),
    "40 views": BASE.replace(num_views=40),
    "40 views resampled 45x64": BASE.replace(num_views=40, num_rows_out=45,
                                             num_cols_out=64),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frame():
    """A crop of the bud pair and fractional disparities in (-6, 6)."""
    l = read_bmp(os.path.join(DATA, "bud_2.bmp"))[100:172:2, 200:304:2]
    r = read_bmp(os.path.join(DATA, "bud_3.bmp"))[100:172:2, 200:304:2]
    rng = np.random.default_rng(31)
    dl, dr = ((rng.integers(-6, 6, (H, W)).astype(F32)
               + rng.random((H, W)).astype(F32) * F32(0.9)) for _ in "lr")
    return [np.ascontiguousarray(a) for a in (l, r, dl, dr)]


def _band(cfg):
    """The port's configuration of the route under test: the band engine
    (B12's interlace mode; `cfg` names the XLA engine for the JAX
    reference chain)."""
    return config_from_dict(dataclasses.asdict(cfg)).replace(engine="band")


def _jax_unfused(frame, cfg):
    views = jpipe.synthesize_views(*(jnp.asarray(a) for a in frame), cfg)
    return np.asarray(jops.mux_multiview(views, cfg.num_rows_out,
                                         cfg.num_cols_out, cfg.angle))


@pytest.mark.parametrize("name", list(CASES))
def test_synthesize_interlace_matches_jax_unfused(frame, name):
    """The port's one synthesis route against JAX mux_multiview(
    synthesize_views(engine="xla")): exact."""
    cfg = CASES[name]
    ref = _jax_unfused(frame, cfg)
    got = tpipe.synthesize_interlace(*(_t(a) for a in frame), _band(cfg))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (cfg.num_rows_out, cfg.num_cols_out, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ["identity", "40 views",
                                  "resampled 72x104"])
def test_synthesize_interlace_matches_jax_band(frame, name):
    """Against JAX synthesize_interlace(engine="band") with its Pallas
    kernels in interpret mode: every difference is +-1 and sits where
    the JAX band chain departs from its own unfused chain (its warp
    kernel's lerp contracts a multiply-add; the port rounds both
    products, as the unfused chain does)."""
    cfg = CASES[name]
    band = np.asarray(jpipe.synthesize_interlace(
        *(jnp.asarray(a) for a in frame), cfg.replace(engine="band")))
    unfused = _jax_unfused(frame, cfg)
    got = tpipe.synthesize_interlace(*(_t(a) for a in frame),
                                     _band(cfg)).numpy()
    diff = got != band
    assert np.all(np.abs(got.astype(int) - band)[diff] == 1)
    assert np.all((unfused != band)[diff])
    assert np.mean(diff) <= 1e-3


@pytest.mark.parametrize("radius", [0, 1, 3, 10])
@pytest.mark.parametrize("shape", [(H, W), (7, 5)])
def test_feather_matches_jax(radius, shape):
    """G1's plain version against JAX dibr_feather_mask
    (filter_gaussian_lift of 1 - m), also on a plane narrower and
    shorter than 2r + 1: exact."""
    rng = np.random.default_rng(40 + radius)
    m = (rng.random(shape) > 0.3).astype(F32)
    ref = np.asarray(jdibr.dibr_feather_mask(jnp.asarray(m), radius, 15.0))
    got = tdibr.dibr_feather_mask(_t(m), radius, 15.0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("v_cnt,angle,rows,cols", [
    (8, 18.43, 64, 40), (16, 18.43, 61, 3840), (38, 18.43, 200, 1001),
    (40, 18.43, 97, 50), (8, 30.0, 50, 33), (14, 9.5, 120, 20),
    (5, 63.0, 40, 10), (2, 45.0, 20, 7)])
def test_row_views_match_jax_pattern(v_cnt, angle, rows, cols):
    """The per-row view term the interlace kernel computes (its plain
    twin `mux_row_views`), expanded to subpixels as the kernel does,
    against JAX mux_view_pattern."""
    ref = np.asarray(jmux.mux_view_pattern(v_cnt, rows, cols, angle,
                                           np.arange(rows)))
    yv = tmux.mux_row_views(v_cnt, rows, angle).numpy()
    base = 3 * np.arange(cols)[None, :] + yv[:, None] + 2
    got = np.stack([(base - ch) % v_cnt for ch in range(3)], axis=-1)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tmux.mux_view_pattern(v_cnt, rows, cols, angle).numpy(), ref)


# ---- replays of the kernels' index logic --------------------------------

WMI_TX, WMI_PX = 128, 4           # csrc/warp.cu: threads, pixels a thread


def _replay_interlace(views, rows, cols, angle):
    """csrc/warp.cu `warp_merge_interlace_kernel` on a (V, H, W, 3) u8
    view stack: blocks of 512 flat output pixels, thread t pixels t +
    128 k (the first found by division, each next by stepping x, y and
    y mod y_mod), the view id from the row term, the selected view's value
    (lerped at the four input points of a resampled output, float32 and
    each operation rounded), staged bytes stored as 16-byte words and
    the last block's tail byte by byte.  Unwritten bytes keep a poison
    value."""
    v_cnt, h, w = views.shape[:3]
    y_mod, inv_y = tmux.mux_geometry(v_cnt, angle)
    identity = (rows, cols) == (h, w)
    if not identity:
        ty, tx = ([a.numpy() for a in lerp_taps(n, m, "cpu")]
                  for n, m in ((rows, h), (cols, w)))
    npx, block = rows * cols, WMI_TX * WMI_PX
    out = np.full(npx * 3, 0xAB, np.uint8)
    for p0 in range(0, npx, block):
        n = min(block, npx - p0)
        stage = np.zeros(block * 3, np.uint8)
        # each thread's first pixel, then steps of WMI_TX pixels
        y, x = np.divmod(p0 + np.arange(WMI_TX), cols)
        ym = y % y_mod
        for k in range(WMI_PX):
            j = np.arange(WMI_TX) + k * WMI_TX
            live = j < n
            yl, xl = y[live], x[live]
            yv = ((ym[live].astype(F32) + F32(1.0)) * F32(v_cnt)
                  * inv_y).astype(np.int64)
            v0 = (3 * xl + yv + 2) % v_cnt
            for ch in range(3):
                v = np.where(v0 - ch < 0, v0 - ch + v_cnt, v0 - ch)
                if identity:
                    val = views[v, yl, xl, ch]
                else:
                    at = lambda yy, xx: views[v, yy, xx, ch].astype(F32)
                    fx, fy = tx[2][xl], ty[2][yl]
                    fxb, fyb = F32(1.0) - fx, F32(1.0) - fy
                    top = (at(ty[0][yl], tx[0][xl]) * fxb
                           + at(ty[0][yl], tx[1][xl]) * fx)
                    bot = (at(ty[1][yl], tx[0][xl]) * fxb
                           + at(ty[1][yl], tx[1][xl]) * fx)
                    val = (top * fyb + bot * fy).astype(np.uint8)
                stage[j[live] * 3 + ch] = val
            x = x + WMI_TX
            while np.any(x >= cols):
                wrap = x >= cols
                x[wrap] -= cols
                y[wrap] += 1
                ym[wrap] = (ym[wrap] + 1) % y_mod
        nb = n * 3
        words = nb // 16
        out[p0 * 3:p0 * 3 + words * 16] = stage[:words * 16]
        for i in range(words * 16, nb):
            out[p0 * 3 + i] = stage[i]
    return out.reshape(rows, cols, 3)


@pytest.mark.parametrize("v_cnt,hw,out_hw", [
    (5, (37, 33), (37, 33)),            # odd width: rows of 99 bytes
    (40, (36, 52), (37, 71)),           # resampled, a partial last block
    (8, (36, 52), (23, 31))])           # shrunk
def test_interlace_kernel_replay(v_cnt, hw, out_hw):
    rng = np.random.default_rng(50 + v_cnt)
    views = rng.integers(0, 256, (v_cnt, *hw, 3)).astype(np.uint8)
    ref = tmux.mux_multiview(_t(views), *out_hw, 18.43).numpy()
    np.testing.assert_array_equal(
        _replay_interlace(views, *out_hw, 18.43), ref)


FEATHER_TX, FEATHER_TY, FEATHER_RMAX = 64, 64, 10    # csrc/feather.cu


def _replay_feather(m, radius, sigma):
    """csrc/feather.cu on an (H, W) mask: up to FEATHER_RMAX, tiles of
    64 x 64 outputs staged with a halo of r at clamped indices, the x pass
    over the tile's 64 + 2r rows, the y pass four rows at a time (output q of
    a group adds k[t - q] * xs[t], t ascending), the max; above it the
    two one-thread-a-pixel passes through an (H, W) plane of x sums."""
    taps, post = tfilters.gaussian_lift_constants(radius, sigma)
    h, w = m.shape
    n = 2 * radius + 1
    a = F32(1.0) - m
    out = np.full((h, w), np.nan, F32)
    if radius > FEATHER_RMAX:
        cols = np.arange(w)
        xs = np.zeros((h, w), F32)
        for j in range(n):
            xs = xs + taps[j] * a[:, np.clip(cols + j - radius, 0, w - 1)]
        rows = np.arange(h)
        acc = np.zeros((h, w), F32)
        for j in range(n):
            acc = acc + taps[j] * xs[np.clip(rows + j - radius, 0, h - 1)]
        return np.maximum(a, acc * post)
    for y0 in range(0, h, FEATHER_TY):
        for x0 in range(0, w, FEATHER_TX):
            gy = np.clip(y0 + np.arange(FEATHER_TY + 2 * radius) - radius,
                         0, h - 1)
            gx = np.clip(x0 + np.arange(FEATHER_TX + 2 * radius) - radius,
                         0, w - 1)
            tile = a[gy][:, gx]
            xs = np.zeros((FEATHER_TY + 2 * radius, FEATHER_TX), F32)
            for j in range(n):
                xs = xs + taps[j] * tile[:, j:j + FEATHER_TX]
            acc = np.zeros((FEATHER_TY, FEATHER_TX), F32)
            for g in range(0, FEATHER_TY, 4):
                for t in range(n + 3):
                    for q in range(4):
                        if 0 <= t - q < n:
                            acc[g + q] = acc[g + q] + taps[t - q] * xs[g + t]
            res = np.maximum(tile[radius:radius + FEATHER_TY,
                                  radius:radius + FEATHER_TX], acc * post)
            ny, nx = min(FEATHER_TY, h - y0), min(FEATHER_TX, w - x0)
            out[y0:y0 + ny, x0:x0 + nx] = res[:ny, :nx]
    return out


@pytest.mark.parametrize("radius,shape", [
    (10, (70, 130)),        # ragged tiles on both axes
    (10, (7, 5)),           # one tile, narrower than 2r + 1
    (0, (33, 65)),
    (11, (40, 70)),         # the first radius of the two launches
    (40, (20, 9)),          # two launches, narrower than 2r + 1
    (70, (9, 150))])        # two launches, shorter than 2r + 1
def test_feather_kernel_replay(radius, shape):
    rng = np.random.default_rng(60 + radius)
    m = (rng.random(shape) > 0.3).astype(F32)
    ref = tdibr.dibr_feather_mask_plain(_t(m), radius, 15.0).numpy()
    np.testing.assert_array_equal(_replay_feather(m, radius, 15.0),
                                  ref)



def _replay_fast_merge(img_l, img_r, dl, dr, ml, mr, m, sl, sr):
    """The conversion-free merge of csrc/warp.cu (`fast_lerp`, `lerp_f`,
    `view_f`) for one view, in float32: its floors are v + 2^23 rounded
    toward zero, np.floor here, for values its ranges keep in [0, 2^23);
    u8((1 - m) * from_l) as the floor of max(product, 0)."""
    h, w = dl.shape
    xf = np.arange(w, dtype=F32)[None, :]

    def warp(img, d, s, mask):
        c = np.minimum(np.maximum(xf + d * F32(s), F32(0.0)), F32(w - 1))
        x0 = np.floor(c)
        w0 = np.maximum(F32(1.0) - np.abs(c - x0), F32(0.0))
        w1 = np.maximum(F32(1.0) - np.abs(c - (x0 + F32(1.0))), F32(0.0))
        i0 = x0.astype(np.int64)
        i1 = np.minimum(i0 + 1, w - 1)
        rows = np.arange(h)[:, None]
        a0, a1 = (img[rows, i, :].astype(F32) for i in (i0, i1))
        lerp = np.floor(w0[..., None] * a0 + w1[..., None] * a1)
        return np.floor(lerp * mask[..., None])

    m3 = m[..., None]
    b = np.floor(np.maximum((F32(1.0) - m3) * warp(img_l, dr, sl, mr),
                            F32(0.0)))
    a = np.floor(m3 * warp(img_r, dl, sr, ml))
    t = b + a
    return np.where(t >= 256, t - 256, t).astype(np.uint8)


def test_interlace_fast_merge_replay(frame):
    """The interlace kernel's merge without conversions equals B12's merge
    (`warp_merge_views_plain`) wherever its fast path runs: masks in
    [0, 1] and a feather in [0, 1 + 2^-8], here drawn across those
    ranges and their ends, over every view of 8."""
    l, r, dl, dr = frame
    rng = np.random.default_rng(70)
    ml, mr = (np.where(rng.random((H, W)) < 0.3,
                       rng.integers(0, 2, (H, W)),
                       rng.random((H, W))).astype(F32) for _ in "lr")
    m = np.where(rng.random((H, W)) < 0.3,
                 rng.choice([0.0, 1.0, 1.00390625], (H, W)),
                 rng.random((H, W)) * 1.00390625).astype(F32)
    shifts = tdibr.synth_shifts(8)
    sl, sr = tdibr.merge_shifts(shifts)
    ref = tdibr.warp_merge_views_plain(*(_t(a) for a in (l, r, dl, dr, ml,
                                                         mr, m)),
                                       shifts).numpy()
    for v in range(len(shifts)):
        np.testing.assert_array_equal(
            _replay_fast_merge(l, r, dl, dr, ml, mr, m, sl[v], sr[v]),
            ref[v])
