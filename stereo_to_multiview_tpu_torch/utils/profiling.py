"""The program's annotation for `torch.profiler`: `stage_scope(name)`.

While a profiler is on, `stage_scope` opens a `record_function` range,
which the profiler records on its own clock beside the device activity;
otherwise it only checks that no profiler is on.  Three kinds of names:

- pipeline stages, the JAX package's: ca_cross_arms, stereo_core, dr_dcc,
  dr_irv, filter_median, filter_bilateral, dibr_occl, dibr_feather,
  dibr_dbm (the warps, merge and interlace in one kernel), mux_multiview
  (the XLA engine's interlace), tx_scale (the lowres path's rescales); and
  frame_in (the frame's upload at depth 1, check, split and copies).  A
  trace ties device work to the innermost range open at its launch, so
  a stage groups the device work it launches.
- a kernel's span nested in a stage: `dc_hslo`, the scanline
  optimisation's launch (B13) inside `stereo_core` (`ops/band.py`), so
  that its device work reads apart from the rest of the core's.
- host spans: the stream loop's `stream.pull`, `stream.stage_in`,
  `stream.upload`, `stream.dispatch` (around the stages), `stream.readback`,
  `stream.wait`, `stream.emit` (`models/stream.py`).  A host span nested
  in a stage would wrap host work alone: a launch inside it would move
  out of the stage.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def stage_scope(name: str):
    """Mark the work inside as `name` while a profiler is on."""
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield
