"""Cells found by name.

A cell `<config>.<mix>` is the configuration file `configs/<config>.json`
under the traffic mix `traffic/<mix>.json`.  The configuration names its
plain reference (`reference`: `reference/<name>.py`), the mix where its
frames come from (`frames_in`: `sources/<name>.py`).  Its per-layer
metrics are the `per_layer` entries of the checkout's `BENCHMARK.json`
that name the cell (or name no cells), each read by `metrics/<metric>.py`.
Adding a configuration, a mix, a reference, a frame source or a metric is
adding its file and its entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    mix_name: str
    config: dict          # the configuration file
    traffic: dict         # the mix file
    end_to_end: list      # names of the cell's end-to-end metrics
    per_layer: dict       # name -> the metric's module
    source: object        # the frame source's module
    reference: object     # the plain reference's module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, attrs: tuple,
                bench_dir: Path = BENCH_DIR):
    """The module `<kind>/<name>.py` of the benchmark's folder, which has
    to define each of `attrs`."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"mvbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in attrs:
        if not hasattr(mod, attr):
            raise ValueError(f"{kind} {name}: {path} defines no {attr}")
    return mod


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of per-layer metric `name`: it defines UNIT,
    MOVES and read(stretch, log) -> float or None."""
    return load_module("metrics", name, ("UNIT", "MOVES", "read"), bench_dir)


def load_source(name: str, bench_dir: Path = BENCH_DIR):
    """The frame source `name`: make(seed, cfg, mix, device) -> Frames."""
    return load_module("sources", name, ("make",), bench_dir)


def load_reference(name: str, bench_dir: Path = BENCH_DIR):
    """The plain reference `name`: process_frame(sbs, pipeline) -> the
    outputs the check compares."""
    return load_module("reference", name, ("process_frame",), bench_dir)


def _applies(entry: dict, cell: str, e2e: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in e2e


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of the benchmark whose folder is `bench_dir` (its
    BENCHMARK.json in the folder's parent)."""
    config_name, sep, mix_name = name.partition(".")
    if not sep or not config_name or not mix_name:
        raise ValueError(f"workload {name!r} is not <config>.<mix>")
    config = load_json(bench_dir / "configs" / f"{config_name}.json")
    traffic = load_json(bench_dir / "traffic" / f"{mix_name}.json")
    bench = load_json(bench_dir.parent / "BENCHMARK.json")
    e2e = [m["name"] for m in bench.get("end_to_end", [])
           if "workloads" not in m or name in m["workloads"]]
    per_layer = {}
    for entry in bench.get("per_layer", []):
        if _applies(entry, name, set(e2e)):
            mod = load_metric(entry["name"], bench_dir)
            if (mod.UNIT, mod.MOVES) != (entry["unit"], entry["moves"]):
                raise ValueError(f"metric {entry['name']}: its reader says "
                                 f"{mod.UNIT}/{mod.MOVES}, BENCHMARK.json "
                                 f"{entry['unit']}/{entry['moves']}")
            per_layer[entry["name"]] = mod
    return Cell(name, config_name, mix_name, config, traffic, e2e, per_layer,
                load_source(traffic["frames_in"], bench_dir),
                load_reference(config["reference"], bench_dir))
