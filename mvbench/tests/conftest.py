"""The benchmark's CPU tests: `python -m pytest mvbench/tests -q` from the
checkout's root.  They put the checkout's root on the import path."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a small frame of each configuration's settings, as the port's own small
# checks use: 96x160, D = 30, arms of up to 12 (the votes' regions then
# hold few enough pixels for IRV to accept votes on every frame)
SMALL = dict(num_rows=96, num_cols=160, num_rows_out=96, num_cols_out=160,
             num_disp=30, zero_disp=15, usd=12, lsd=6)
