"""The check fails what it must: the control (the program with its bf16
WTA switched on) and each fault the cells can have, planted in the timed
path of a whole run on the CPU at a small size; a sound run passes."""

import pytest

from mvbench.control import readings
from mvbench.harness.cells import load_cell
from mvbench.harness.faults import FAULTS
from mvbench.harness.runner import run_cell

from conftest import SMALL

SEEDS = [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13]


@pytest.fixture(scope="module")
def cell():
    return load_cell("hd1080_d128.resident")


def test_a_sound_run_is_correct(cell):
    r = run_cell(cell, SEEDS[0], 0.5, False, "cpu", pipeline_override=SMALL)
    assert r["correct"] and r["failed"] == 0
    assert {k: c["value"] for k, c in r["checks"].items()} == {
        "disp_px_off": 0, "interlace_sub_off": 0}
    assert set(r["metrics"]) == {"fps", "frame_ms_p95", "peak_mem_gib",
                                 "setup_s"}
    assert list(r)[-2:] == ["checks", "log"]


def test_the_control_is_not_correct(cell):
    for rec in readings(cell, SEEDS, 0.5, "cpu", {"band_lossy_wta": True},
                        geometry=SMALL):
        assert not rec["correct"]
        assert rec["disp_px_off"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_is_not_correct(cell, fault):
    (rec,) = readings(cell, SEEDS[:1], 0.5, "cpu", None, fault,
                      geometry=SMALL)
    assert not rec["correct"]
    assert rec["disp_px_off"] + rec["interlace_sub_off"] > 0


def test_a_traced_run_on_the_cpu_reports_no_device_metric(cell):
    r = run_cell(cell, SEEDS[1], 0.5, True, "cpu", pipeline_override=SMALL)
    assert r["correct"] and r["metrics"] == {}
