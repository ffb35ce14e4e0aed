"""The per-layer metrics of the `hd1080_hslo_4k.video` cell
(`mvbench/metrics/`): `hslo_roofline`'s byte and operation counts at
1080p and at a small shape, what it reads from a synthetic stretch and
its None where the program opens no `dc_hslo` span; `stage_ms.dc_hslo`
and `stage_ms.filter_median` on a synthetic stretch."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mvbench.harness.cells import load_cell, load_metric  # noqa: E402
from mvbench.harness.trace import DeviceEvent, Stretch  # noqa: E402

CELL = "hd1080_hslo_4k.video"
NEW = ("stage_ms.dc_hslo", "hslo_roofline", "stage_ms.filter_median")
CFG = json.loads((ROOT / "mvbench/configs/hd1080_hslo_4k.json").read_text())[
    "pipeline"]
B13 = "void hslo_kernel<4, true>(HsloArgs)"
PASS4 = ("void hpass_kernel<int, false, 32, true, false>(int const*, long "
         "long, int const*, int const*, int*, float*, int, int, int, int, "
         "int, int, int)")
PASS1 = ("void hpass_kernel<unsigned char, false, 32, true, false>(unsigned "
         "char const*, long long, int const*, int const*, int*, float*, int, "
         "int, int, int, int, int, int)")
VPASS = "vpass_kernel(int const*, int const*, int const*, int*, int, int)"

roof = load_metric("hslo_roofline")


def ev(name, start, dur, stage):
    return DeviceEvent(name, "kernel", start, dur, stage)


def stretch(events, frames=2, cfg=CFG):
    return Stretch(frames=frames, window_us=1e6, events=events, counters={},
                   config=cfg)


def test_the_cell_reads_the_three_new_metrics():
    # the new three, after the accepted metrics that read the layers the
    # cell shares with the 1080p cells (all but the two that read nothing
    # here: `core_roofline` off B13's route, `irv_sync_ms` since its span
    # went)
    assert tuple(load_cell(CELL).per_layer) == (
        "copy_ms", "stage_ms.stereo_core", "stage_ms.dr_irv", "irv_rounds",
        "device_idle_pct", "idle_ms.stage_in", "idle_ms.dr_irv",
        "idle_ms.unnamed") + NEW


def test_byte_and_operation_counts_at_1080p():
    # an eye: the int32 pass-3 volume, two int32 arms, two u8 grey
    # images, the float32 disparity
    assert roof.eye_bytes(1080, 1920, 128) == 1080 * 1920 * (512 + 14)
    assert roof.eye_ops(1080, 1920, 128) == 22 * 1080 * 1920 * 128
    b = roof.frame_bound_ms(CFG)
    assert b == pytest.approx(2 * 1080 * 1920 * 526 / 3.35e12 * 1e3)
    assert b == pytest.approx(0.651, abs=0.001)   # the bytes bound it
    ops_ms = 2 * roof.eye_ops(1080, 1920, 128) / 67e12 * 1e3
    assert ops_ms == pytest.approx(0.174, abs=0.001)


def test_byte_and_operation_counts_at_a_small_shape():
    assert roof.eye_bytes(2, 3, 4) == 6 * (16 + 8 + 2 + 4)
    assert roof.eye_ops(2, 3, 4) == 22 * 24
    cfg = dict(CFG, num_rows=2, num_cols=3, num_disp=4)
    # a tiny frame is bound by neither: the larger of the two, in ms
    assert roof.frame_bound_ms(cfg) == pytest.approx(
        max(2 * 180 / 3.35e12, 2 * 528 / 67e12) * 1e3)


def test_hslo_roofline_reads_b13_and_the_pass4_sums():
    events = [
        ev(PASS1, 0.0, 500.0, "stereo_core"),
        ev(VPASS, 500.0, 1200.0, "stereo_core"),
        ev(PASS4, 1700.0, 900.0, "stereo_core"),
        ev(PASS4, 2600.0, 900.0, "stereo_core"),
        ev(B13, 3500.0, 2800.0, "dc_hslo"),
        ev(PASS4, 9000.0, 900.0, "stereo_core"),
        ev(PASS4, 9900.0, 900.0, "stereo_core"),
        ev(B13, 10800.0, 2800.0, "dc_hslo"),
        # the next frame's pass-4 sum, its B13 after the stretch's end
        ev(PASS4, 20000.0, 900.0, "stereo_core"),
    ]
    log = []
    got = roof.read(stretch(events), log)
    bound_us = roof.frame_bound_ms(CFG) * 1e3
    assert got == pytest.approx(100.0 * 2 * bound_us / (2 * 2800 + 4 * 900))
    assert 12.0 < got < 16.0
    assert "2 frames of B13 launches, 4 pass-4 sums" in log[0]


def test_hslo_roofline_counts_a_frame_a_chunk_of_launches():
    cfg = dict(CFG, band_row_chunk=540)       # two chunks a frame
    events = [ev(B13, 1000.0 * k, 500.0, "dc_hslo") for k in range(4)]
    got = roof.read(stretch(events, cfg=cfg), [])
    assert got == pytest.approx(100.0 * 2 * roof.frame_bound_ms(cfg) * 1e3
                                / 2000.0)


def test_hslo_roofline_reads_nothing_without_the_span():
    # the parent program: B13 launched inside `stereo_core`, no `dc_hslo`
    events = [ev(PASS4, 0.0, 900.0, "stereo_core"),
              ev(B13, 900.0, 2800.0, "stereo_core")]
    assert roof.read(stretch(events), []) is None
    assert roof.read(stretch([]), []) is None


@pytest.mark.parametrize("name,stage", [("stage_ms.dc_hslo", "dc_hslo"),
                                        ("stage_ms.filter_median",
                                         "filter_median")])
def test_stage_ms_reads_its_span(name, stage):
    mod = load_metric(name)
    k = B13 if stage == "dc_hslo" else "k"
    events = [ev(k, 0.0, 1500.0, stage), ev(k, 2000.0, 500.0, stage),
              ev("k", 3000.0, 4000.0, "stereo_core"),
              DeviceEvent("Memset (Device)", "gpu_memset", 8000.0, 100.0,
                          stage)]
    assert mod.read(stretch(events), []) == pytest.approx(1.05)
    assert mod.read(stretch(events[2:3]), []) is None
    assert mod.read(stretch([]), []) is None


def test_stage_ms_dc_hslo_counts_a_frame_by_its_b13_launch():
    # depth 2: the stretch's 20 frames hold 19 B13 launches, the 20th
    # runs after it; a frame of the span is one launch's time
    mod = load_metric("stage_ms.dc_hslo")
    events = [ev(B13, 3000.0 * k, 2800.0, "dc_hslo") for k in range(19)]
    assert mod.read(stretch(events, frames=20), []) == pytest.approx(2.8)
    cfg = dict(CFG, band_row_chunk=540)       # two launches a frame
    assert mod.read(stretch(events[:4], cfg=cfg), []) == pytest.approx(5.6)
    # the parent program: B13 inside `stereo_core`, no span to read
    assert mod.read(stretch([ev(B13, 0.0, 2800.0, "stereo_core")]),
                    []) is None
