"""The per-layer metrics of the `hd1080_lowres.video` cell
(`mvbench/metrics/`): the cell's metric set, `tx_scale_roofline`'s byte
counts at 1080p and at a small shape, what it reads from a synthetic
stretch and its None where the program launches neither rescale kernel;
`stage_ms.tx_scale` on a synthetic stretch."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mvbench.harness.cells import load_cell, load_metric  # noqa: E402
from mvbench.harness.trace import DeviceEvent, Stretch  # noqa: E402

CELL = "hd1080_lowres.video"
NEW = ("stage_ms.tx_scale", "tx_scale_roofline")
CFG = json.loads((ROOT / "mvbench/configs/hd1080_lowres.json").read_text())[
    "pipeline"]
DOWN = ("tx_scale_bilinear_kernel(unsigned char const*, unsigned char "
        "const*, unsigned char*, unsigned char*, int, int, int, int, int, "
        "bool)")
UP = ("tx_disp_scale_kernel(float const*, float const*, float*, float*, "
      "int, int, int, int, float, bool)")
# the plain route's launches, as the parent program makes them
PLAIN = ("void at::native::index_select_out_kernel_impl(...)",
         "void at::native::vectorized_elementwise_kernel<4, ...>(...)")

roof = load_metric("tx_scale_roofline")


def ev(name, start, dur, stage="tx_scale"):
    return DeviceEvent(name, "kernel", start, dur, stage)


def stretch(events, frames=2, cfg=CFG):
    return Stretch(frames=frames, window_us=1e6, events=events, counters={},
                   config=cfg)


def test_the_cell_reads_the_two_new_metrics():
    # the new two, after the accepted metrics that read the layers the
    # cell shares with the 1080p cells (all but `core_roofline`, which
    # counts the full-resolution core, and `irv_sync_ms`, silent since its
    # span went)
    assert tuple(load_cell(CELL).per_layer) == (
        "copy_ms", "stage_ms.stereo_core", "stage_ms.dr_irv", "irv_rounds",
        "device_idle_pct", "idle_ms.stage_in", "idle_ms.dr_irv",
        "idle_ms.unnamed") + NEW
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]


def test_byte_counts_at_1080p():
    # down: both eyes' 1080p u8 images read, 540x960 written; up: both
    # eyes' 540x960 float32 disparities read, 1080p written
    assert roof.down_bytes(CFG) == 12_441_600 + 3_110_400
    assert roof.up_bytes(CFG) == 4_147_200 + 16_588_800
    assert roof.frame_bytes(CFG) == 36_288_000
    assert roof.frame_bound_ms(CFG) == pytest.approx(36_288_000 / 3.35e12
                                                     * 1e3)
    assert roof.frame_bound_ms(CFG) == pytest.approx(0.01083, abs=1e-5)


def test_byte_counts_at_a_small_shape():
    cfg = dict(CFG, num_rows=4, num_cols=6, num_rows_disp=2,
               num_cols_disp=3)
    assert roof.down_bytes(cfg) == 2 * 3 * (24 + 6)
    assert roof.up_bytes(cfg) == 2 * 4 * (6 + 24)
    assert roof.frame_bound_ms(cfg) == pytest.approx(420 / 3.35e12 * 1e3)


def test_tx_scale_roofline_reads_the_two_kernels():
    events = [ev(DOWN, 0.0, 12.0), ev("cost_pair_kernel", 20.0, 300.0,
                                      "stereo_core"),
              ev(UP, 400.0, 14.0), ev(DOWN, 1000.0, 12.0),
              ev(UP, 1400.0, 14.0),
              # the next frame's downscale, its upscale after the stretch
              ev(DOWN, 2000.0, 12.0)]
    log = []
    got = roof.read(stretch(events), log)
    bound_us = 1e3 * (3 * roof.down_bytes(CFG) + 2 * roof.up_bytes(CFG)) \
        / 3.35e12 * 1e3
    assert got == pytest.approx(100.0 * bound_us / (3 * 12.0 + 2 * 14.0))
    assert 0.0 < got <= 100.0
    assert "3 downscale and 2 upscale launches" in log[0]


def test_tx_scale_roofline_reads_nothing_without_the_kernels():
    # the plain route: torch's own kernels inside the `tx_scale` stage
    events = [ev(PLAIN[0], 0.0, 5.0), ev(PLAIN[1], 5.0, 5.0)]
    assert roof.read(stretch(events), []) is None
    assert roof.read(stretch([]), []) is None


def test_stage_ms_tx_scale_reads_its_span():
    mod = load_metric("stage_ms.tx_scale")
    events = [ev(DOWN, 0.0, 15.0), ev(UP, 500.0, 25.0),
              ev("cost_pair_kernel", 20.0, 300.0, "stereo_core"),
              DeviceEvent("Memset (Device)", "gpu_memset", 800.0, 10.0,
                          "tx_scale")]
    assert mod.read(stretch(events), []) == pytest.approx(0.025)
    # the plain route's torch launches are read as well: it is a stage
    assert mod.read(stretch([ev(PLAIN[0], 0.0, 60.0)]),
                    []) == pytest.approx(0.03)
    # a program that opens no `tx_scale` range (the full-resolution route)
    assert mod.read(stretch(events[2:3]), []) is None
    assert mod.read(stretch([]), []) is None
