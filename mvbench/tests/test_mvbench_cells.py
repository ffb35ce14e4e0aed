"""Cells are found by name: a configuration, a mix and a per-layer metric
added as new files (and entries in BENCHMARK.json) are picked up with no
edit of the harness."""

import json
import shutil

import pytest

from mvbench.harness import cells
from mvbench.harness.cells import load_cell
from mvbench.harness.trace import DeviceEvent, Stretch

from conftest import ROOT


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_of_the_benchmark_loads():
    b = bench()
    for w in b["workloads"]:
        c = load_cell(w["name"])
        assert (c.config_name, c.mix_name) == (w["config"], w["traffic"])
        assert c.end_to_end == [m["name"] for m in b["end_to_end"]]
        assert set(c.per_layer) == {m["name"] for m in b["per_layer"]
                                    if w["name"] in m["workloads"]}
        assert c.config["pipeline"]["num_rows"] > 0


def test_config_files_are_the_benchmarks():
    b = bench()
    for cfg in b["configs"]:
        path = ROOT / cfg["file"]
        assert path.parent.name == "configs"
        data = json.loads(path.read_text())
        assert data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "mvbench", root / "mvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    base = json.loads((root / "mvbench/configs/hd1080_d128.json").read_text())
    base["pipeline"]["num_views"] = 12
    (root / "mvbench/configs/probe_cfg.json").write_text(json.dumps(base))
    mix = json.loads((root / "mvbench/traffic/video.json").read_text())
    mix["depth"] = 3
    (root / "mvbench/traffic/probe_mix.json").write_text(json.dumps(mix))
    (root / "mvbench/metrics/probe_metric.py").write_text(
        'UNIT = "ms"\nMOVES = "fps"\n\n\ndef read(st, log):\n'
        '    return 1.0 + st.frames\n')
    b["workloads"].append({"name": "probe_cfg.probe_mix", "config":
                           "probe_cfg", "traffic": "probe_mix", "chips": 1,
                           "why": "probe"})
    b["per_layer"].append({"name": "probe_metric", "unit": "ms", "better":
                           "lower", "source": "program_span", "layer": "x",
                           "moves": "fps",
                           "workloads": ["probe_cfg.probe_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = load_cell("probe_cfg.probe_mix", bench_dir=root / "mvbench")
    assert c.config["pipeline"]["num_views"] == 12
    assert c.traffic["depth"] == 3
    assert list(c.per_layer) == ["probe_metric"]
    st = Stretch(frames=4, window_us=1.0, events=[], counters={}, config={})
    assert c.per_layer["probe_metric"].read(st, []) == 5.0
    # the shipped cells keep their metrics in the copy
    assert "probe_metric" not in load_cell(
        "hd1080_d128.video", bench_dir=root / "mvbench").per_layer


def test_a_name_that_is_no_cell_is_refused():
    with pytest.raises(ValueError):
        load_cell("hd1080_d128")
    with pytest.raises(FileNotFoundError):
        load_cell("hd1080_d128.no_such_mix")


def test_a_reader_that_disagrees_with_the_benchmark_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "mvbench", root / "mvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    b["per_layer"][0]["unit"] = "s"
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(ValueError):
        load_cell(b["workloads"][0]["name"], bench_dir=root / "mvbench")


def test_metric_modules_name_their_unit_and_moves():
    for m in bench()["per_layer"]:
        mod = cells.load_metric(m["name"])
        assert (mod.UNIT, mod.MOVES) == (m["unit"], m["moves"])
        empty = Stretch(frames=1, window_us=1.0, events=[], counters={},
                        config={})
        assert mod.read(empty, []) is None
    one = DeviceEvent("k", "kernel", 0.0, 1.0, "stereo_core")
    assert one.stage == "stereo_core"


PROBE_SOURCE = '''
from mvbench.harness.frames import Frames, make_ring

MADE = []


def make(seed, cfg, mix, device):
    MADE.append((seed, mix["noise_sigma"]))
    ring = make_ring(seed, cfg.num_rows, cfg.num_cols, mix["noise_sigma"],
                     device, n=3)
    return Frames(ring, lambda i: ring[i % len(ring)])
'''

PROBE_REFERENCE = '''
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "probe_plain", Path(__file__).with_name("plain.py"))
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)


def process_frame(sbs, cfg):
    disp_l, disp_r, out = plain.process_frame(sbs, cfg)
    out = out.clone()
    out[0, 0, 0] ^= 1
    return disp_l, disp_r, out
'''


def test_a_new_reference_and_source_are_picked_up_without_an_edit(tmp_path):
    from conftest import SMALL
    from mvbench.harness.runner import run_cell

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "mvbench", root / "mvbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench()))
    (root / "mvbench/sources/probe_src.py").write_text(PROBE_SOURCE)
    (root / "mvbench/reference/probe_ref.py").write_text(PROBE_REFERENCE)
    cfg = json.loads((root / "mvbench/configs/hd1080_d128.json").read_text())
    cfg["reference"] = "probe_ref"
    (root / "mvbench/configs/probe_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "mvbench/traffic/resident.json").read_text())
    mix.update(frames_in="probe_src", noise_sigma=0.5)
    (root / "mvbench/traffic/probe_mix.json").write_text(json.dumps(mix))
    c = load_cell("probe_cfg.probe_mix", bench_dir=root / "mvbench")
    seed = 2 ** 31 + 404
    r = run_cell(c, seed, 0.3, False, "cpu", pipeline_override=SMALL)
    assert c.source.MADE == [(seed, 0.5)]
    # the probe reference differs from the plain one in one subpixel a
    # frame: the check read it, and nothing else
    checks = {k: v["value"] for k, v in r["checks"].items()}
    sampled = min(cfg["check_frames"], r["attempted"] - r["failed"])
    assert checks == {"disp_px_off": 0, "interlace_sub_off": sampled}
    assert not r["correct"]
    mix["frames_in"] = "no_such_source"
    (root / "mvbench/traffic/probe_mix.json").write_text(json.dumps(mix))
    with pytest.raises(FileNotFoundError):
        load_cell("probe_cfg.probe_mix", bench_dir=root / "mvbench")
