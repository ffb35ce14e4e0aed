"""A traced stretch of the window: `torch.profiler` over a run of frames,
reduced from its Chrome trace to device intervals, each attributed to the
program's stage (its `record_function` range) that launched it.

A device event (kernel, memcpy, memset) is tied to the host call that
launched it by the trace's correlation id; the stage is the innermost
user annotation on that host thread that contains the call.  The stretch
runs from the mark the harness records as it starts the profiler to the
one it records as it stops it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
START, END = "mvbench.stretch_start", "mvbench.stretch_end"


@dataclass
class DeviceEvent:
    name: str
    cat: str
    start_us: float
    dur_us: float
    stage: str | None        # the launching stage, None if unattributed


@dataclass
class Stretch:
    """What a per-layer metric reads: the traced frames, the stretch's
    length, its device events, the program's launch counters over the
    stretch, and the configuration as run."""
    frames: int
    window_us: float
    events: list
    counters: dict
    config: dict
    host_gaps: list = field(default_factory=list)

    def device_us(self, pred) -> float:
        return sum(e.dur_us for e in self.events if pred(e))

    def busy_us(self) -> float:
        """Length of the union of device intervals."""
        busy, end = 0.0, None
        for e in sorted(self.events, key=lambda e: e.start_us):
            s, t = e.start_us, e.start_us + e.dur_us
            if end is None or s > end:
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        return busy


class _Ranges:
    """Per-thread user annotations, innermost lookup by time."""

    def __init__(self, anns):
        self.by_tid = defaultdict(list)
        for a in anns:
            self.by_tid[a["tid"]].append((a["ts"], a["ts"] + a["dur"],
                                          a["name"]))
        for v in self.by_tid.values():
            v.sort()
        self.starts = {t: [r[0] for r in v] for t, v in self.by_tid.items()}

    def innermost(self, tid, ts):
        """Name of the latest-starting annotation on `tid` open at
        `ts`, or None."""
        rs = self.by_tid.get(tid, [])
        for s, e, name in reversed(rs[:bisect.bisect_right(
                self.starts.get(tid, []), ts)]):
            if e >= ts:
                return name
        return None


def _window(events):
    marks = {e["name"]: e["ts"] for e in events
             if e.get("cat") == "user_annotation" and e["name"] in (START,
                                                                     END)}
    if START not in marks or END not in marks:
        return None
    return marks[START], marks[END]


def reduce_trace(trace: dict, frames: int, counters: dict,
                 config: dict) -> Stretch:
    """The Stretch of a Chrome trace written by `torch.profiler`."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    win = _window(events)
    if win is None:
        raise ValueError("the trace holds no stretch marks")
    t0, t1 = win
    anns = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] not in (START, END)]
    ranges = _Ranges(anns)
    calls = {}
    for e in events:
        if e.get("cat") in HOST_CALL_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls[corr] = (e["tid"], e["ts"])
    dev = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d <= t0 or s >= t1:
            continue
        # clip to the stretch
        s2, t2 = max(s, t0), min(s + d, t1)
        call = calls.get(e.get("args", {}).get("correlation"))
        stage = ranges.innermost(*call) if call else None
        dev.append(DeviceEvent(e["name"], e["cat"], s2, t2 - s2, stage))
    main_tid = next(e["tid"] for e in events if e["name"] == START)
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                  "cuda_runtime",
                                                  "cuda_driver")
            and e["tid"] == main_tid and e["name"] not in (START, END)]
    st = Stretch(frames, t1 - t0, dev, counters, config)
    st.host_gaps = _idle_gaps(dev, t0, t1, host)
    return st


def _idle_gaps(dev, t0, t1, host_src):
    """[(label, seconds)] of every stretch of the window in which no
    device event runs, labelled with the two innermost events open on the
    main host thread at the gap's middle; where none is, with the host
    events that ended last before it and start first after it."""
    spans = sorted((e.start_us, e.start_us + e.dur_us) for e in dev)
    gaps, cur = [], t0
    for s, t in spans:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if cur < t1:
        gaps.append((cur, t1))
    host = sorted((e["ts"], -e.get("dur", 0.0), e["name"])
                  for e in host_src)
    ends = sorted((e["ts"] + e.get("dur", 0.0), e["name"]) for e in host_src)
    out, stack, k = [], [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= mid:
            s, neg, name = host[k]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((s - neg, name))
            k += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        names = [n for e, n in stack if e >= mid]
        if names:
            label = " > ".join(names[-2:])
        else:
            # nothing open: the host was between two recorded calls
            j = bisect.bisect_left(ends, (mid,)) - 1
            before = ends[j][1] if j >= 0 else "start"
            after = host[k][2] if k < len(host) else "end"
            label = f"host, after {before}, before {after}"
        out.append((label, (b - a) * 1e-6))
    return out


def breakdown(st: Stretch, top: int = 10) -> dict:
    """The device operations with the most time and the longest idle
    gaps, seconds each, at most `top` of each."""
    by_name = defaultdict(float)
    for e in st.events:
        by_name[e.name[:160]] += e.dur_us * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(st.host_gaps, key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}
