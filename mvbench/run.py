"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 mvbench/run.py --workload <config>.<mix> --seed N --seconds S \
        --trace 0|1

See `harness/runner.py`; the cells, metrics and bounds are in the
checkout's BENCHMARK.json.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mvbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
