"""Readings that set the check's limits, at a cell's own size and load,
several seeds in one process (one set-up):

    python3 mvbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds S [--dial band_lossy_wta=true] [--fault NAME]

Without a dial or fault: the program as configured (the lower reading).
With `--dial`: the program with its lower-precision path switched on (the
control; the configuration states band_digits=3 integer aggregation and
no bf16 WTA).  With `--fault`: a fault of `harness/faults.py` planted.
Prints one JSON line a seed with the numbers compared.  The benchmark's
own runs do not run this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mvbench.harness.cells import load_cell  # noqa: E402
from mvbench.harness.faults import FAULTS  # noqa: E402
from mvbench.harness.runner import run_cell  # noqa: E402


def dial(text: str) -> dict:
    key, _, val = text.partition("=")
    return {key: json.loads(val)}


def readings(cell, seeds, seconds, device, override=None, fault=None,
             geometry=None):
    """[{seed, correct, checks...}] of one short window a seed;
    `geometry` resizes the frame for program and reference alike."""
    out = []
    for seed in seeds:
        plant = FAULTS[fault]() if fault else contextlib.nullcontext()
        with plant:
            r = run_cell(cell, seed, seconds, False, device,
                         pipeline_override=geometry,
                         program_override=override)
        out.append({"seed": seed, "correct": r["correct"],
                    "frames": r["attempted"],
                    **{k: c["value"] for k, c in r["checks"].items()}})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dial", action="append", default=[])
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args(argv)
    override = {}
    for d in a.dial:
        override.update(dial(d))
    cell = load_cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    for rec in readings(cell, seeds, a.seconds, a.device, override, a.fault):
        print(json.dumps({"workload": a.workload, "dial": override,
                          "fault": a.fault, **rec}), flush=True)


if __name__ == "__main__":
    main()
