"""The benchmark's plain reference of the scanline route
(`mvbench/reference/hslo_4k.py`) against the port's plain versions
(`process_frame(..., device="cpu")`) on a small frame of the
`hd1080_hslo_4k` configuration's settings: disparities and the interlaced
frame agree bit for bit, over two block sizes, the median on and off,
penalties whose three tiers all occur, and an output of another size
than the input or of the same.  Also: the configuration file is the
port's preset field for field, the reference refuses what it does not
compute, and it loads neither JAX nor the port."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mvbench.harness.frames import make_ring  # noqa: E402
from mvbench.reference import hslo_4k, plain  # noqa: E402
from stereo_to_multiview_tpu_torch.config import (  # noqa: E402
    HD1080_D128_HSLO_4K, config_from_dict)
from stereo_to_multiview_tpu_torch.models.pipeline import (  # noqa: E402
    process_frame)

CONFIG = ROOT / "mvbench" / "configs" / "hd1080_hslo_4k.json"
# 96x320 an eye, D = 32, views to a 192x640 output; the configuration's
# arms (usd 34), whose pass-4 sums are large enough for the order of the
# DP's float32 steps to show
SMALL = dict(num_rows=96, num_cols=320, num_rows_out=192, num_cols_out=640,
             num_disp=32, zero_disp=16)
# the paper's penalties, and strong ones at a low threshold (T, H1, H2)
PENALTIES = {"paper": (15.0, 1.0, 3.0), "strong": (6.0, 40.0, 120.0)}


def small_cfg(**kw) -> dict:
    pipe = json.loads(CONFIG.read_text())["pipeline"]
    return dict(pipe, **dict(SMALL, **kw))


@pytest.fixture(scope="module")
def sbs():
    return make_ring(2 ** 31 + 23, 96, 320, 1.0, "cpu", n=1)[0]


def tier_counts(sbs, cfg) -> set:
    """The tiers (0, 1, 2 small gradients) the frame's penalties take."""
    w = sbs.shape[1] // 2
    small = [hslo_4k.small_gradients(plain.grey(sbs[:, a:a + w]),
                                     cfg["hslo_T"]) for a in (0, w)]
    nd, zd = cfg["num_disp"], cfg["zero_disp"]
    return set(torch.cat([hslo_4k.tiers(small[0], small[1], nd, zd, 1),
                          hslo_4k.tiers(small[1], small[0], nd, zd, -1)])
               .unique().tolist())


def assert_equal_outputs(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("penalties", sorted(PENALTIES))
@pytest.mark.parametrize("median", [True, False])
@pytest.mark.parametrize("block", [96, 40])
def test_reference_equals_the_ports_plain_versions(sbs, penalties, median,
                                                   block):
    T, h1, h2 = PENALTIES[penalties]
    pipe = small_cfg(use_median=median, hslo_T=T, hslo_H1=h1, hslo_H2=h2)
    assert tier_counts(sbs, pipe) == {0, 1, 2}
    got = process_frame(sbs.numpy(), config_from_dict(pipe), device="cpu")
    ref = hslo_4k.process_frame(sbs, pipe, block=block)
    assert got[2].shape == (192, 640, 3)
    assert_equal_outputs(got, ref)


def test_an_output_of_the_inputs_size_passes(sbs):
    pipe = small_cfg(num_rows_out=96, num_cols_out=320)
    got = process_frame(sbs.numpy(), config_from_dict(pipe), device="cpu")
    ref = hslo_4k.process_frame(sbs, pipe, block=40)
    assert got[2].shape == (96, 320, 3)
    assert_equal_outputs(got, ref)


def test_the_scanline_moves_disparities(sbs):
    """The DP is not a no-op on the test frame: its WTA differs from the
    aggregate's own at some pixels, more with the strong penalties."""
    w = sbs.shape[1] // 2
    img_l, img_r = sbs[:, :w].contiguous(), sbs[:, w:].contiguous()
    moved = []
    for name in ("paper", "strong"):
        T, h1, h2 = PENALTIES[name]
        pipe = small_cfg(hslo_T=T, hslo_H1=h1, hslo_H2=h2)
        arms = plain.cross_arms(img_l, pipe), plain.cross_arms(img_r, pipe)
        wta = plain.stereo_core(img_l, img_r, *arms, pipe, 96)
        dp = hslo_4k.stereo_core(img_l, img_r, *arms, pipe, 96)
        moved.append(sum(int((a != b).sum()) for a, b in zip(wta, dp)))
    assert 0 < moved[0] < moved[1]


@pytest.mark.parametrize("dial", [{"band_lossy_wta": True},
                                  {"num_rows_disp": 48, "num_cols_disp": 160},
                                  {"use_hslo": False}])
def test_reference_refuses_what_it_does_not_compute(dial):
    sbs = torch.zeros((96, 640, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hslo_4k.process_frame(sbs, small_cfg(**dial))


def test_configuration_file_is_the_preset():
    data = json.loads(CONFIG.read_text())
    assert data["pipeline"] == dataclasses.asdict(HD1080_D128_HSLO_4K)
    assert config_from_dict(data["pipeline"]) == HD1080_D128_HSLO_4K
    assert data["reference"] == "hslo_4k" and data["reduced"] == []
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "hd1080_hslo_4k")
    assert entry["file"] == "mvbench/configs/hd1080_hslo_4k.json"
    assert (entry["source"], entry["reduced"]) == (data["source"], [])


def test_penalties_are_in_the_aggregates_units():
    """qscale 127 over the digits-3 shifts (0, 3, 6): 127 / 512 a cost
    unit; the tiers a tenth, a quarter and all of it."""
    p1, p2 = hslo_4k.penalty_tables(small_cfg())
    unit = 127.0 / 512.0
    assert p1.tolist() == pytest.approx([0.1 * unit, 0.25 * unit, unit],
                                        rel=2e-7)
    assert p2.tolist() == pytest.approx([0.3 * unit, 0.75 * unit, 3 * unit],
                                        rel=2e-7)


def test_reference_loads_neither_jax_nor_the_port():
    for name in ("hslo_4k.py", "plain.py"):
        text = (ROOT / "mvbench" / "reference" / name).read_text()
        for line in text.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "stereo_to_multiview"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import mvbench.reference.hslo_4k; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'stereo_to_multiview_tpu', "
            "'stereo_to_multiview_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
