"""The program's spans over a traced stretch, and the arithmetic that puts
the device's idle time and the host's waits down to them.

A span is a `record_function` range the program opens on the stream
loop's thread (`stereo_to_multiview_tpu_torch/utils/profiling.py`): its
pipeline stages and its host spans (`stream.*`, `irv.sync`).  The
profiler records them on the clock of the device activity.  A `Stretch`
carries the device events but not the host ranges, so the spans are read
from the Chrome trace that `runner.Profiled.export` writes before the
per-layer metrics are read (`trace_path()`), and only where that trace's
stretch marks give the Stretch's window.  Where no span of a name is
there (a program that opens none), the readers give None.
"""

from __future__ import annotations

import json
import os
import tempfile

from mvbench.harness.trace import END, START

TRACE_FILE = "mvbench_trace.json"     # the name `Profiled.export` writes


def trace_path() -> str:
    return os.path.join(tempfile.gettempdir(), TRACE_FILE)


def loop_spans(trace: dict):
    """(t0, t1, spans) of a Chrome trace: the stretch marks and
    [(name, start_us, dur_us)] of the user annotations on the marks'
    thread, clipped to [t0, t1]; None without both marks."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    marks = {e["name"]: e for e in events if e["name"] in (START, END)}
    if START not in marks or END not in marks:
        return None
    t0, t1 = marks[START]["ts"], marks[END]["ts"]
    tid = marks[START]["tid"]
    spans = []
    for e in events:
        if e["tid"] != tid or e["name"] in (START, END):
            continue
        s, t = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0.0), t1)
        if t > s:
            spans.append((e["name"], s, t - s))
    return t0, t1, spans


def _load(st):
    try:
        with open(trace_path()) as f:
            got = loop_spans(json.load(f))
    except (OSError, ValueError):
        return None
    if got is None or abs(got[1] - got[0] - st.window_us) > 0.5:
        return None                   # not this stretch's trace
    return got


def spans_of(st):
    """The stretch's (t0, t1, spans), read once and kept on `st`; None
    where the trace is not there or is another stretch's."""
    if "_loop_spans" not in vars(st):
        st._loop_spans = _load(st)
    return st._loop_spans


def union(intervals) -> list:
    """Sorted disjoint [(start, end)] covering `intervals`."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def length(intervals) -> float:
    return sum(t - s for s, t in intervals)


def intersect(a, b) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if t > s:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(st, t0: float, t1: float) -> list:
    """The intervals of [t0, t1] in which no device event runs."""
    busy = union((e.start_us, e.start_us + e.dur_us) for e in st.events)
    gaps, cur = [], t0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, t)
    if cur < t1:
        gaps.append((cur, t1))
    return gaps


def covered(spans, pred) -> list:
    """The union of the spans whose name satisfies `pred`."""
    return union((s, s + d) for name, s, d in spans if pred(name))


def idle_us(st, pred):
    """Device-idle microseconds inside the spans whose name satisfies
    `pred`; None without device events or without such a span."""
    got = spans_of(st) if st.events else None
    if got is None:
        return None
    t0, t1, spans = got
    cov = covered(spans, pred)
    return length(intersect(idle(st, t0, t1), cov)) if cov else None


def span_us(st, pred):
    """Microseconds the spans whose name satisfies `pred` cover; None
    without device events (no device run to wait on) or without such a
    span."""
    got = spans_of(st) if st.events else None
    if got is None:
        return None
    cov = covered(got[2], pred)
    return length(cov) if cov else None


def top_level(spans) -> list:
    """The spans that no other span holds (the loop's own steps)."""
    out, end = [], None
    for name, s, d in sorted(spans, key=lambda x: (x[1], -x[2])):
        if end is None or s >= end:
            out.append((name, s, d))
            end = s + d
    return out


def idle_by_top_level(st):
    """{name: device-idle us} over the top-level spans of each name, plus
    "unnamed" (idle inside no span) and "total"; None without device
    events or spans."""
    got = spans_of(st) if st.events else None
    if got is None or not got[2]:
        return None
    t0, t1, spans = got
    gaps = idle(st, t0, t1)
    tops = top_level(spans)
    out = {}
    for name in sorted({n for n, _, _ in tops}):
        out[name] = length(intersect(gaps, covered(tops, name.__eq__)))
    out["unnamed"] = length(gaps) - length(intersect(
        gaps, covered(tops, lambda n: True)))
    out["total"] = length(gaps)
    return out
