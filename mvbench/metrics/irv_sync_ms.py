"""irv_sync_ms: host milliseconds a frame inside IRV's `irv.sync` spans,
the host blocked on a round's change flag (`ops/irv.any_changed`): time in
which it cannot queue work ahead of the device.  Read from the program's
spans (`harness/spans.py`), on the profiler's clock."""

from mvbench.harness import spans

UNIT = "ms"
MOVES = "fps"


def read(st, log):
    us = spans.span_us(st, lambda name: name == "irv.sync")
    return None if us is None else us * 1e-3 / st.frames
