"""The benchmark's plain reference of the low-resolution route
(`mvbench/reference/lowres.py`) against the port's plain versions
(`process_frame_lowres(..., device="cpu")`) on small frames of the
`hd1080_lowres` configuration's settings: disparities and the interlaced
frame agree bit for bit at a 2:1 ratio and at a ratio whose weights are
neither 0 nor 0.5 and whose upscale taps clamp at the far edge, over two
block sizes.  Also: the stream takes the route from the configuration,
G2's wrappers take the plain rescales for CPU tensors, the configuration
file is the port's preset field for field, the reference refuses what it
does not compute, and it loads neither JAX nor the port."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mvbench.harness.frames import make_ring  # noqa: E402
from mvbench.reference import lowres  # noqa: E402
from stereo_to_multiview_tpu_torch.config import (  # noqa: E402
    HD1080_LOWRES, config_from_dict)
from stereo_to_multiview_tpu_torch.models.pipeline import (  # noqa: E402
    process_frame, process_frame_lowres)
from stereo_to_multiview_tpu_torch.models.stream import stream  # noqa: E402
from stereo_to_multiview_tpu_torch.ops import scale  # noqa: E402

CONFIG = ROOT / "mvbench" / "configs" / "hd1080_lowres.json"
# 96x320 an eye, D = 16 at the disparity size, the configuration's arms
# (usd 34); the disparity size at 2:1, and at 40x150 (2.4 and 2.133...
# input pixels an output pixel)
FRAME = dict(num_rows=96, num_cols=320, num_rows_out=96, num_cols_out=320,
             num_disp=16, zero_disp=8)
SIZES = {"2:1": (48, 160), "non-integer": (40, 150)}


def small_cfg(rows: int, cols: int, **kw) -> dict:
    pipe = json.loads(CONFIG.read_text())["pipeline"]
    return {**pipe, **FRAME, "num_rows_disp": rows, "num_cols_disp": cols,
            **kw}


@pytest.fixture(scope="module")
def sbs():
    return make_ring(2 ** 31 + 29, 96, 320, 1.0, "cpu", n=1)[0]


def assert_equal_outputs(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def weights(n_out: int, n_in: int) -> set:
    return set(lowres.taps(n_out, n_in, "cpu")[2].tolist())


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("block", [None, 20])
def test_reference_equals_the_ports_plain_versions(sbs, size, block):
    rows, cols = SIZES[size]
    pipe = small_cfg(rows, cols)
    got = process_frame_lowres(sbs.numpy(), config_from_dict(pipe),
                               device="cpu")
    ref = lowres.process_frame(sbs, pipe, block=block or rows)
    assert got[0].shape == (96, 320) and got[2].shape == (96, 320, 3)
    assert_equal_outputs(got, ref)


def test_the_ratios_take_the_weights_and_edges_they_are_for():
    # 2:1 down samples every other pixel exactly, up halfway between two
    assert weights(48, 96) == weights(160, 320) == {0.0}
    assert weights(96, 48) == weights(320, 160) == {0.0, 0.5}
    # the non-integer ratio: weights other than 0 and 0.5 both ways
    for n_out, n_in in ((40, 96), (150, 320), (96, 40), (320, 150)):
        assert weights(n_out, n_in) - {0.0, 0.5}
    # upscaling, the last outputs sample past the last input: their
    # coordinate clamps to it and both taps are that input
    i0, i1, w = lowres.taps(96, 40, "cpu")
    assert int(i0[-1]) == int(i1[-1]) == 39 and float(w[-1]) == 0.0
    i0, i1, w = lowres.taps(320, 150, "cpu")
    assert int(i0[-1]) == int(i1[-1]) == 149


def test_the_disparities_come_back_doubled(sbs):
    """The route's disparities at full size span twice the low size's
    range and take half-pixel values between the doubled ones."""
    pipe = small_cfg(48, 160)
    dl, dr, _ = lowres.process_frame(sbs, pipe)
    for d in (dl, dr):
        assert float(d.min()) >= -16 and float(d.max()) < 16
        assert bool(((d * 2) != torch.round(d * 2)).any())


def test_stream_takes_the_route_from_the_configuration(sbs):
    frames = [f.numpy() for f in make_ring(2 ** 31 + 31, 96, 320, 1.0,
                                           "cpu", n=2)]
    cfg = config_from_dict(small_cfg(48, 160))
    assert cfg.lowres

    def run(**kw):
        outs = []
        stream(iter(frames), cfg, on_frame=lambda i, *o: outs.append(o),
               prefetch=0, verbose=False, device="cpu", **kw)
        return outs

    for outs, entry in ((run(), process_frame_lowres),
                        (run(lowres=True), process_frame_lowres),
                        (run(lowres=False), process_frame)):
        assert len(outs) == len(frames)
        for f, got in zip(frames, outs):
            assert_equal_outputs(got, entry(f, cfg, device="cpu"))
    # the two routes differ: the default is not the full-resolution one
    low, full = run()[0], run(lowres=False)[0]
    assert not torch.equal(low[0], full[0])


@pytest.mark.parametrize("src,dst", [((37, 53), (18, 26)),
                                     ((36, 52), (45, 64)),
                                     ((20, 31), (1, 17)),
                                     ((20, 31), (33, 1)),
                                     ((36, 52), (36, 52))])
def test_g2_wrappers_take_the_plain_rescales_on_the_cpu(src, dst):
    rng = np.random.default_rng(61)
    imgs = [torch.from_numpy(rng.integers(0, 256, (*src, 3), dtype=np.uint8))
            for _ in range(2)]
    disps = [torch.from_numpy((rng.random(src) * 24 - 12).astype(np.float32))
             for _ in range(2)]
    before = (scale.tx_scale_bilinear_lr.launches,
              scale.tx_disp_scale_lr.launches)
    down = scale.tx_scale_bilinear_lr(*imgs, *dst)
    up = scale.tx_disp_scale_lr(*disps, *dst, 2.0)
    for got, img in zip(down, imgs):
        assert got.is_contiguous()
        assert torch.equal(got, scale.tx_scale_bilinear(img, *dst))
    for got, d in zip(up, disps):
        assert torch.equal(got, scale.tx_disp_scale(d, *dst, 2.0))
    # the reference's own rescale agrees with the plain versions
    for got, img in zip(down, imgs):
        assert torch.equal(got, lowres.scale_down(img, *dst))
    for got, d in zip(up, disps):
        assert torch.equal(got, lowres.scale_up(d, *dst, 0.5))
    # nothing launched on the CPU
    assert (scale.tx_scale_bilinear_lr.launches,
            scale.tx_disp_scale_lr.launches) == before


@pytest.mark.parametrize("dial", [{"band_lossy_wta": True},
                                  {"use_hslo": True},
                                  {"use_median": True},
                                  {"num_rows_disp": 0, "num_cols_disp": 0},
                                  {"num_rows_out": 192, "num_cols_out": 640}])
def test_reference_refuses_what_it_does_not_compute(dial):
    sbs = torch.zeros((96, 640, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        lowres.process_frame(sbs, small_cfg(48, 160, **dial))


def test_configuration_file_is_the_preset():
    data = json.loads(CONFIG.read_text())
    assert data["pipeline"] == dataclasses.asdict(HD1080_LOWRES)
    assert config_from_dict(data["pipeline"]) == HD1080_LOWRES
    assert data["reference"] == "lowres" and data["reduced"] == []
    assert (data["check_frames"], data["trace_frames"]) == (4, 20)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "hd1080_lowres")
    assert entry["file"] == "mvbench/configs/hd1080_lowres.json"
    assert (entry["source"], entry["reduced"]) == (data["source"], [])
    cell = next(w for w in bench["workloads"]
                if w["name"] == "hd1080_lowres.video")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "hd1080_lowres", "video", 1)


def test_reference_loads_neither_jax_nor_the_port():
    text = (ROOT / "mvbench" / "reference" / "lowres.py").read_text()
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert not words[1].startswith(("jax", "stereo_to_multiview"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import mvbench.reference.lowres; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'stereo_to_multiview_tpu', "
            "'stereo_to_multiview_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
