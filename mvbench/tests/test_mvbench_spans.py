"""The program's spans over a traced stretch (`harness/spans.py`) and the
metrics read from them, on a synthetic Chrome trace: device idle time put
down to the loop thread's spans adds up to the stretch's idle time, host
spans that launch nothing move no device time out of a stage, and a
trace without the spans, or another stretch's, gives no reading."""

import json
import os
import tempfile

import pytest

from mvbench.harness import spans
from mvbench.harness.cells import load_metric
from mvbench.harness.trace import END, START, breakdown, reduce_trace

FRAMES = 2
CONFIG = {"num_rows": 1080, "irv_row_chunk": 0}
NEW = ("idle_ms.stage_in", "idle_ms.dr_irv", "irv_sync_ms",
       "idle_ms.unnamed")
OLD = ("copy_ms", "stage_ms.stereo_core", "stage_ms.dr_irv", "irv_rounds",
       "device_idle_pct")


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


# the loop thread's host spans, which launch nothing (the stages and the
# launches are in DEVICE_WORK)
HOST_SPANS = [
    ev("user_annotation", "stream.pull", 100, 5),
    ev("user_annotation", "stream.stage_in", 105, 20),
    ev("user_annotation", "stream.upload", 125, 3),
    ev("user_annotation", "stream.dispatch", 128, 112),
    ev("user_annotation", "frame_in", 128, 2),
    ev("user_annotation", "irv.sync", 191, 14),
    ev("user_annotation", "stream.readback", 240, 2),
    ev("user_annotation", "stream.wait", 242, 13),
    ev("user_annotation", "stream.emit", 255, 5),
    ev("user_annotation", "stream.pull", 270, 60),     # past the end
]

DEVICE_WORK = [
    ev("user_annotation", "stereo_core", 130, 30),
    ev("cuda_runtime", "cudaLaunchKernel", 132, 2, corr=1),
    ev("user_annotation", "dr_irv", 160, 60),
    ev("cuda_runtime", "cudaLaunchKernel", 162, 2, corr=3),
    ev("cuda_runtime", "cudaLaunchKernel", 210, 2, corr=4),
    ev("cuda_runtime", "cudaMemcpyAsync", 240, 1, corr=5),
    ev("kernel", "vpass_kernel(int const*)", 135, 40, tid=7, corr=1),
    ev("kernel", "irv_vote_kernel<1>", 180, 10, tid=7, corr=3),
    ev("kernel", "irv_rowspan_kernel", 215, 10, tid=7, corr=4),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 242, 8, tid=7,
       corr=5),
]

# idle in [100, 300): [100, 135) [175, 180) [190, 215) [225, 242)
# [250, 300), 132 us; of it [260, 270) lies in no span
IDLE_US = 35 + 5 + 25 + 17 + 50


def trace(host=HOST_SPANS):
    return {"traceEvents": [ev("user_annotation", START, 100, 0)] + host
            + DEVICE_WORK + [ev("user_annotation", END, 300, 0)]}


@pytest.fixture
def tmpdir_trace(tmp_path, monkeypatch):
    """Writes a trace where `Profiled.export` puts it and reduces it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def put(t):
        with open(spans.trace_path(), "w") as f:
            json.dump(t, f)
        return reduce_trace(t, FRAMES, {"irv_vote": 20}, CONFIG)
    return put


def read(st, name, log=None):
    return load_metric(name).read(st, [] if log is None else log)


def test_the_new_metrics(tmpdir_trace):
    st = tmpdir_trace(trace())
    assert read(st, "idle_ms.stage_in") == pytest.approx(20e-3 / FRAMES)
    # dr_irv [160, 220): idle [175, 180) and [190, 215)
    assert read(st, "idle_ms.dr_irv") == pytest.approx(30e-3 / FRAMES)
    assert read(st, "irv_sync_ms") == pytest.approx(14e-3 / FRAMES)
    assert read(st, "idle_ms.unnamed") == pytest.approx(10e-3 / FRAMES)


def test_the_idle_time_closes(tmpdir_trace):
    st = tmpdir_trace(trace())
    by = spans.idle_by_top_level(st)
    assert by == {"stream.dispatch": 52.0, "stream.emit": 5.0,
                  "stream.pull": 35.0, "stream.readback": 2.0,
                  "stream.stage_in": 20.0, "stream.upload": 3.0,
                  "stream.wait": 5.0, "unnamed": 10.0, "total": 132.0}
    named = sum(v for k, v in by.items() if k not in ("unnamed", "total"))
    assert named + by["unnamed"] == by["total"] == IDLE_US
    idle_pct = read(st, "device_idle_pct")
    assert by["total"] == pytest.approx(idle_pct / 100 * st.window_us)
    log = []
    read(st, "idle_ms.unnamed", log)
    assert log and "stream.stage_in 0.010000" in log[0]


def test_host_spans_move_no_device_time(tmpdir_trace):
    """The existing metrics and the busiest operations read the same with
    the host spans as without them; the longest idle gap is named."""
    with_spans = tmpdir_trace(trace())
    without = tmpdir_trace(trace(host=[]))
    for name in OLD:
        assert read(with_spans, name) == read(without, name), name
    # a launch in no stage before is now in its span; staged ones stay
    assert [(e.stage or "stream.readback") for e in without.events] == [
        e.stage for e in with_spans.events]
    assert (breakdown(with_spans)["device_ops"]
            == breakdown(without)["device_ops"])
    gaps = breakdown(with_spans)["idle_gaps"]
    assert [g[0] for g in gaps[:2]] == ["stream.pull", "stream.stage_in"]
    assert [g[1] for g in gaps[:2]] == pytest.approx([50e-6, 35e-6])


def test_a_sync_span_over_no_launch_keeps_the_stage(tmpdir_trace):
    st = tmpdir_trace(trace())
    assert read(st, "stage_ms.dr_irv") == pytest.approx(20e-3 / FRAMES)
    assert {e.stage for e in st.events} == {"stereo_core", "dr_irv",
                                            "stream.readback"}


def test_without_the_stream_spans_only_dr_irv_reads(tmpdir_trace):
    """The program before the spans: stages alone."""
    st = tmpdir_trace(trace(host=[]))
    got = {n: read(st, n) for n in NEW}
    assert got["idle_ms.dr_irv"] == pytest.approx(30e-3 / FRAMES)
    assert got["idle_ms.stage_in"] is None
    assert got["irv_sync_ms"] is None
    assert got["idle_ms.unnamed"] is None


def test_another_stretch_or_no_trace_reads_nothing(tmpdir_trace):
    st = tmpdir_trace(trace())
    other = trace()
    other["traceEvents"][-1]["ts"] = 400             # another window
    with open(spans.trace_path(), "w") as f:
        json.dump(other, f)
    assert all(read(st, n) is None for n in NEW)
    st = reduce_trace(trace(), FRAMES, {}, CONFIG)   # not memoised yet
    os.remove(spans.trace_path())
    assert all(read(st, n) is None for n in NEW)


def test_no_device_events_reads_nothing(tmpdir_trace):
    t = trace()
    t["traceEvents"] = [e for e in t["traceEvents"]
                        if e["cat"] not in ("kernel", "gpu_memcpy")]
    st = tmpdir_trace(t)
    assert all(read(st, n) is None for n in NEW)


def test_interval_arithmetic():
    assert spans.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10),
                                                              (20, 25)]
    assert spans.top_level([("a", 0, 10), ("b", 2, 3), ("c", 10, 1)]) == [
        ("a", 0, 10), ("c", 10, 1)]
