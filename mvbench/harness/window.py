"""The measured window of a closed-loop stream, and its arithmetic.

`Window.source()` hands the stream the ring's frames in turn until the
window's seconds are up, stamping each frame as the stream takes it;
`Window.on_frame` stamps each frame as its output is complete and keeps a
seeded uniform sample of the frames' outputs for the correctness check
(reservoir sampling into device slots allocated beforehand).
"""

from __future__ import annotations

import math
import random
import time


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of all values, linear between the two
    nearest ranks (numpy's default), with no binning."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_stats(taken: dict, done: dict) -> dict:
    """fps over the whole window (frames completed / seconds from the
    first frame's hand-over to the last completion) and the latency of
    every completed frame (completion minus hand-over), in seconds."""
    if not done:
        return {"frames": 0, "seconds": 0.0, "fps": 0.0, "latency_s": []}
    t0 = min(taken.values())
    t1 = max(done.values())
    lat = [done[i] - taken[i] for i in sorted(done)]
    return {"frames": len(done), "seconds": t1 - t0,
            "fps": len(done) / (t1 - t0), "latency_s": lat}


class Window:
    """One closed-loop window over a ring of frames.

    `marks` maps frame indices to callables run just before the stream
    takes that frame (the traced stretch's start and end); `hold`, while
    it returns True, keeps the window open past its seconds (a traced
    run's stretch is not complete yet)."""

    def __init__(self, ring, seconds: float, seed: int, slots=None,
                 marks=None, clock=time.perf_counter, hold=None):
        self.ring = ring
        self.seconds = seconds
        self.clock = clock
        self.taken: dict = {}
        self.done: dict = {}
        self.slots = slots or []          # [(disp_l, disp_r, interlaced)]
        self.sampled: dict = {}           # slot -> frame index
        self.rng = random.Random(seed)
        self.marks = marks or {}
        self.hold = hold              # () -> True keeps the window open
        self.t_start = None

    def source(self):
        i = 0
        self.t_start = self.clock()
        while True:
            if i in self.marks:
                self.marks[i]()
            now = self.clock()
            if (i and now - self.t_start >= self.seconds
                    and not (self.hold and self.hold())):
                return
            self.taken[i] = now
            yield self.ring[i % len(self.ring)]
            i += 1

    def on_frame(self, i, disp_l, disp_r, interlaced):
        self.done[i] = self.clock()
        k = len(self.slots)
        if not k:
            return
        j = i if i < k else self.rng.randrange(i + 1)
        if j < k:
            for dst, src in zip(self.slots[j], (disp_l, disp_r, interlaced)):
                dst.copy_(src)
            self.sampled[j] = i

    def stats(self) -> dict:
        return window_stats(self.taken, self.done)
