"""Timing instrumentation: a named wall-clock timer and the streaming
frames/s meter."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class Timer:
    """Named wall-clock timer printing `[[ <name> took: X ms ]]`."""

    def __init__(self, name: str, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.ms: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        if self.verbose:
            print(f"[[ {self.name} took: {self.ms:.3f} ms ]]")
        return False


class FrameMeter:
    """Streaming per-frame latency/fps meter, with warmup exclusion so the
    first frames (kernel builds, allocator growth) don't pollute the
    steady state."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def add(self, seconds: float) -> None:
        """Record one directly measured frame duration.  Unlike tick()
        (tick-to-tick deltas, so consumer work between frames lands in the
        next delta), add() lets the driver time exactly the span it
        meters."""
        self.times.append(seconds)

    @property
    def steady_times(self) -> List[float]:
        return (self.times[self.warmup:] if len(self.times) > self.warmup
                else self.times)

    @property
    def fps(self) -> float:
        ts = self.steady_times
        return len(ts) / sum(ts) if ts else 0.0

    def stats(self) -> Dict[str, Any]:
        ts = self.steady_times
        if not ts:
            return {"frames": 0, "fps": 0.0}
        return {
            "frames": len(ts),
            "fps": self.fps,
            "ms_mean": 1e3 * sum(ts) / len(ts),
            "ms_min": 1e3 * min(ts),
            "ms_max": 1e3 * max(ts),
        }
