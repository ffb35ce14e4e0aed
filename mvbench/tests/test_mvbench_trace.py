"""The traced stretch from a Chrome trace: device events tied to the
stage that launched them, the union of device time, idle gaps labelled
with what the host was doing, and the per-layer metrics read from it."""

import pytest

from mvbench.harness.cells import load_metric
from mvbench.harness.trace import END, START, breakdown, reduce_trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def trace():
    return {"traceEvents": [
        ev("user_annotation", START, 100, 0),
        ev("user_annotation", "stereo_core", 110, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=1),
        ev("user_annotation", "dr_irv", 170, 40),
        ev("cpu_op", "aten::item", 180, 25),
        ev("cuda_runtime", "cudaMemcpyAsync", 182, 20, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 172, 2, corr=3),
        ev("kernel", "vpass_kernel(int const*)", 125, 30, tid=7, corr=1),
        ev("kernel", "irv_vote_kernel<1>", 155, 10, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 195, 5, tid=7,
           corr=2),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 230, 20, tid=8),
        ev("kernel", "late", 260, 100, tid=7, corr=9),
        ev("user_annotation", END, 300, 0),
    ]}


def test_stretch_attributes_and_clips():
    st = reduce_trace(trace(), 2, {"irv_vote": 20},
                      {"num_rows": 1080, "irv_row_chunk": 0})
    assert st.window_us == 200
    stages = {e.name: e.stage for e in st.events}
    assert stages["vpass_kernel(int const*)"] == "stereo_core"
    assert stages["Memcpy DtoH (Device -> Pinned)"] == "dr_irv"
    assert stages["Memcpy HtoD (Pinned -> Device)"] is None
    late = next(e for e in st.events if e.name == "late")
    assert late.dur_us == 40                   # clipped at the stretch end
    # union: [125, 165) + [195, 200) + [230, 250) + [260, 300)
    assert st.busy_us() == 40 + 5 + 20 + 40


def test_idle_gaps_name_the_host():
    st = reduce_trace(trace(), 2, {}, {})
    gaps = [(label, round(s * 1e6)) for label, s in st.host_gaps]
    assert gaps == [("stereo_core", 25),                 # [100, 125)
                    ("dr_irv > aten::item", 30),         # [165, 195)
                    ("host, after dr_irv, before end", 30),   # [200, 230)
                    ("host, after dr_irv, before end", 10)]   # [250, 260)
    out = breakdown(st)
    assert out["device_ops"][0][0] == "late"
    assert len(out["idle_gaps"]) <= 10


def test_metrics_from_the_stretch():
    st = reduce_trace(trace(), 2, {"irv_vote": 20},
                      {"num_rows": 1080, "irv_row_chunk": 0})
    read = lambda n: load_metric(n).read(st, [])
    assert read("copy_ms") == pytest.approx(25e-3 / 2)
    assert read("stage_ms.stereo_core") == pytest.approx(30e-3 / 2)
    assert read("stage_ms.dr_irv") == pytest.approx(15e-3 / 2)
    assert read("irv_rounds") == 5.0
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 105 / 200))


def test_irv_rounds_count_the_row_chunks():
    st = reduce_trace(trace(), 2, {"irv_vote": 40},
                      {"num_rows": 2160, "irv_row_chunk": 1080})
    assert load_metric("irv_rounds").read(st, []) == 5.0


def test_a_trace_without_marks_is_refused():
    t = trace()
    t["traceEvents"] = [e for e in t["traceEvents"] if e["name"] != END]
    with pytest.raises(ValueError):
        reduce_trace(t, 1, {}, {})
