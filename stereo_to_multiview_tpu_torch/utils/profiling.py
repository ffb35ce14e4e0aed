"""Stage annotation and per-stage device timing.

`stage_scope(name)` marks a pipeline stage for `torch.profiler` (it shows
as a `record_function` range in traces).  Given a `StageTimer`, it also
records a pair of CUDA events around the stage, so a caller can read the
per-stage device time after a synchronize.  The stage names are the JAX
package's: ca_cross_arms, stereo_core, dr_dcc, dr_irv, filter_median,
filter_bilateral, dibr_occl, dibr_feather, dibr_dbm (the warps, merge and
interlace in one kernel: no mux_multiview stage follows it); and
tx_scale for the lowres path's rescales.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch


class StageTimer:
    """Collects (start, end) CUDA events per stage name.  Events are read
    only in `ms()`, after a synchronize, so timing adds no host stall to
    the stages themselves."""

    def __init__(self):
        self._events = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events[name].append((start, end))

    def ms(self) -> dict:
        """Total device ms per stage over every recorded run."""
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in evs)
                for name, evs in self._events.items()}


@contextlib.contextmanager
def stage_scope(name: str, timer: StageTimer | None = None):
    """Annotate the work inside as stage `name`; with a timer, also time
    it with CUDA events (the timer must only be passed for CUDA work)."""
    with torch.profiler.record_function(name):
        if timer is None:
            yield
        else:
            with timer.time(name):
                yield
