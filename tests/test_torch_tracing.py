"""The program's spans (`utils.profiling.stage_scope`) on the CPU: a tiny
stream under `torch.profiler` records the stream loop's spans, the
pipeline's stages and IRV's `irv.sync`, nested as the benchmark reads
them; with no profiler on no range is opened; IRV's host read gives the
fixed rounds' disparities and labels bit for bit."""

import json

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models import stream as tstream
from stereo_to_multiview_tpu_torch.ops import irv as tirv
from stereo_to_multiview_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = PipelineConfig(num_rows=24, num_cols=32, num_rows_out=24,
                     num_cols_out=32, num_disp=4, zero_disp=2, usd=4, lsd=2,
                     num_views=2, irv_iterations=3, bilateral_radius=2,
                     feather_radius=2)
N_FRAMES = 3
LOOP = ("stream.pull", "stream.dispatch", "stream.wait", "stream.emit")
STAGES = ("frame_in", "ca_cross_arms", "stereo_core", "dr_dcc", "dr_irv",
          "filter_bilateral", "dibr_occl", "dibr_feather", "dibr_dbm")


def _frames():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (24, 64, 3), dtype=np.uint8)
            for _ in range(N_FRAMES)]


def _traced(fn, tmp_path):
    """[(cat, name, start, end)] of the trace of fn() on the CPU."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e.get("cat"), e["name"], e["ts"], e["ts"] + e.get("dur", 0))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op")]


def _parents(spans, child):
    """Names of the spans that hold `child` (cat, name, start, end)."""
    _, name, s, t = child
    return {p[1] for p in spans if p is not child and p[2] <= s
            and t <= p[3] and (p[2], -p[3]) < (s, -t)}


@pytest.fixture(scope="module")
def traced_stream(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace")
    seen = []
    evs = _traced(lambda: tstream.stream(
        iter(_frames()), CFG, on_frame=lambda i, *o: seen.append(i),
        prefetch=0, verbose=False, depth=1, device="cpu"), tmp)
    assert seen == list(range(N_FRAMES))
    return [e for e in evs if e[0] == "user_annotation"]


def test_stream_records_every_span(traced_stream):
    names = [e[1] for e in traced_stream]
    for n in LOOP + STAGES:
        assert n in names, n
    assert names.count("stream.pull") == N_FRAMES + 1   # the last finds
    for n in ("stream.dispatch", "stream.wait", "stream.emit", "frame_in"):
        assert names.count(n) == N_FRAMES, n
    # each round but the last of each eye reads its change flag
    assert 0 < names.count("irv.sync") <= N_FRAMES * 2 * (
        CFG.irv_iterations - 1)


@pytest.mark.parametrize("name", LOOP)
def test_loop_spans_are_top_level(traced_stream, name):
    for e in traced_stream:
        if e[1] == name:
            assert _parents(traced_stream, e) == set(), e


@pytest.mark.parametrize("name", STAGES)
def test_stages_nest_in_dispatch(traced_stream, name):
    for e in traced_stream:
        if e[1] == name:
            assert _parents(traced_stream, e) == {"stream.dispatch"}, e


def test_irv_sync_nests_in_dr_irv(traced_stream):
    syncs = [e for e in traced_stream if e[1] == "irv.sync"]
    assert syncs
    for e in syncs:
        assert _parents(traced_stream, e) == {"stream.dispatch", "dr_irv"}


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.stage_scope("stereo_core"):
        pass
    seen = []
    tstream.stream(iter(_frames()[:2]), CFG,
                   on_frame=lambda i, *o: seen.append(i), prefetch=0,
                   verbose=False, depth=2, device="cpu")
    assert seen == [0, 1]


def test_stage_scope_passes_exceptions():
    with pytest.raises(ValueError):
        with profiling.stage_scope("stream.dispatch"):
            raise ValueError("frame")


class _FakeStream:
    """A CUDA stream's wait, logged, for the CPU."""

    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append("synchronize")


@pytest.fixture
def fake_cuda(monkeypatch):
    log = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _FakeStream(log))
    return log


@pytest.mark.parametrize("hit", [False, True])
def test_any_changed_with_a_flag_launches_nothing_in_the_span(
        fake_cuda, tmp_path, hit):
    """The device route of IRV's read, with a host flag and a logged
    stream: the reduction and the flag's copy come before the span, the
    span holds the wait and the read alone."""
    changed = torch.zeros((6, 7), dtype=torch.bool)
    changed[3, 4] = hit
    flag = torch.empty((), dtype=torch.bool)
    out = []
    evs = _traced(lambda: out.append(tirv.any_changed(changed, flag)),
                  tmp_path)
    assert out == [hit] and fake_cuda == ["synchronize"]
    (sync,) = [e for e in evs if e[1] == "irv.sync"]
    inside = {e[1] for e in evs if e[0] == "cpu_op"
              and sync[2] <= e[2] and e[3] <= sync[3]}
    assert not inside & {"aten::any", "aten::copy_"}, inside
    before = {e[1] for e in evs if e[0] == "cpu_op" and e[3] <= sync[2]}
    assert {"aten::any", "aten::copy_"} <= before


def _irv_case(share, seed):
    rng = np.random.default_rng(seed)
    h, w = 40, 56
    disp = torch.from_numpy(rng.integers(-3, 4, (h, w)).astype(np.float32))
    outl = torch.from_numpy((rng.random((h, w)) < share).astype(np.uint8))
    arms = torch.from_numpy(rng.integers(0, 5, (4, h, w)).astype(np.int32))
    return disp, outl, arms


@pytest.mark.parametrize("share,row_chunk", [(0.3, 0), (0.6, 16), (0.05, 0)])
def test_irv_read_with_a_flag_is_bit_equal_to_dr_irv(fake_cuda, monkeypatch,
                                                     share, row_chunk):
    """dr_irv_early_stop with every round's read through the device route
    (a host flag, a logged stream) equals the fixed rounds bit for bit."""
    read = tirv.any_changed
    monkeypatch.setattr(tirv, "any_changed", lambda changed, flag: read(
        changed, torch.empty((), dtype=torch.bool)))
    disp, outl, arms = _irv_case(share, 17)
    args = (disp, outl, arms, 5, 0.4, 8, 4, 4, 5)
    fixed = tirv.dr_irv(*args)
    rounds = []
    early = tirv.dr_irv_early_stop(*args, rounds, row_chunk=row_chunk)
    assert torch.equal(fixed[0], early[0]) and torch.equal(fixed[1], early[1])
    assert fake_cuda.count("synchronize") == min(rounds[0], 4)
