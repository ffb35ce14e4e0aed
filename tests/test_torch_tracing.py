"""The program's spans (`utils.profiling.stage_scope`) on the CPU: a tiny
stream under `torch.profiler` records the stream loop's spans and the
pipeline's stages, nested as the benchmark reads them; with no profiler
on no range is opened; IRV's round loop reads nothing on the host (no
`irv.sync`, no scalar read) unless asked for its rounds, which it then
reads once, after the last round, and it gives the fixed rounds'
disparities and labels bit for bit.  On the scanline route the scanline
optimisation's work falls in its `dc_hslo` span inside `stereo_core`,
once a frame and eye pair."""

import json

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models import pipeline as tpipe
from stereo_to_multiview_tpu_torch.models import stream as tstream
from stereo_to_multiview_tpu_torch.ops import hslokern
from stereo_to_multiview_tpu_torch.ops import irv as tirv
from stereo_to_multiview_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = PipelineConfig(num_rows=24, num_cols=32, num_rows_out=24,
                     num_cols_out=32, num_disp=4, zero_disp=2, usd=4, lsd=2,
                     num_views=2, irv_iterations=3, bilateral_radius=2,
                     feather_radius=2)
# the scanline route with the median, to an output twice the input's size
HSLO = CFG.replace(use_hslo=True, use_median=True, num_rows_out=48,
                   num_cols_out=64, hslo_H1=8.0, hslo_H2=24.0)
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
    # IRV's rounds are queued under the device-side frontier: no read
    assert "irv.sync" not in names


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
    """No host span nests in `dr_irv`: the host no longer waits there for
    a round's change flag (`irv.sync` is gone)."""
    assert [e for e in traced_stream if e[1] == "dr_irv"]
    for e in traced_stream:
        assert e[1] != "irv.sync", e
        assert "dr_irv" not in _parents(traced_stream, e), e


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


@pytest.fixture
def fake_cuda(monkeypatch):
    """A log of every wait on a CUDA stream or device, for the CPU."""
    log = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: log.append("synchronize"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: log.append("current_stream"))
    return log


def _irv_case(share, seed):
    rng = np.random.default_rng(seed)
    h, w = 40, 56
    disp = torch.from_numpy(rng.integers(-3, 4, (h, w)).astype(np.float32))
    outl = torch.from_numpy((rng.random((h, w)) < share).astype(np.uint8))
    arms = torch.from_numpy(rng.integers(0, 5, (4, h, w)).astype(np.int32))
    return disp, outl, arms


IRV_ARGS = (5, 0.4, 8, 4, 4, 5)     # thresholds, D, zero_disp, usd, rounds


def _first_still_round(disp, outl, arms, iterations):
    """The first of `iterations` plain rounds that changes no label
    (`iterations` if each does): where a loop that read a change flag
    after every round stopped."""
    for k in range(1, iterations + 1):
        disp, new = tirv.irv_round(disp, outl, arms, *IRV_ARGS[:5])
        if torch.equal(new, outl):
            return k
        outl = new
    return iterations


@pytest.mark.parametrize("share,row_chunk", [(0.3, 0), (0.6, 16), (0.05, 0)])
def test_irv_read_with_a_flag_is_bit_equal_to_dr_irv(fake_cuda, share,
                                                     row_chunk):
    """dr_irv_early_stop without `rounds_run` waits on no stream or device
    (the change flag and its read are gone) and equals the fixed rounds
    bit for bit, whole-frame and over row chunks."""
    disp, outl, arms = _irv_case(share, 17)
    args = (disp, outl, arms, *IRV_ARGS)
    fixed = tirv.dr_irv(*args)
    early = tirv.dr_irv_early_stop(*args, row_chunk=row_chunk)
    assert fake_cuda == []
    assert torch.equal(fixed[0], early[0]) and torch.equal(fixed[1], early[1])


SCALAR_READS = {"aten::item", "aten::_local_scalar_dense"}


@pytest.mark.parametrize("share,seed,still", [(0.05, 17, 2), (0.6, 17, 5)],
                         ids=["converges", "does-not-converge"])
def test_irv_loop_queues_every_round_without_a_read(tmp_path, share, seed,
                                                    still):
    """Under the profiler the round loop holds no `irv.sync` range and no
    scalar read, and runs every round (one vote each), whether its labels
    settle before the last round or not."""
    disp, outl, arms = _irv_case(share, seed)
    assert _first_still_round(disp, outl, arms, IRV_ARGS[-1]) == still
    evs = _traced(lambda: tirv.dr_irv_early_stop(disp, outl, arms,
                                                 *IRV_ARGS), tmp_path)
    names = [e[1] for e in evs]
    assert "irv.sync" not in names
    assert not SCALAR_READS & set(names)
    assert names.count("aten::argmax") == IRV_ARGS[-1]


@pytest.mark.parametrize("row_chunk", [0, 16])
def test_irv_rounds_run_is_read_once_after_the_last_round(tmp_path,
                                                          row_chunk):
    """With `rounds_run` the loop reads its device tally once, after the
    last round's vote, and appends the rounds up to and including the
    first that changed no label: 1 at the fixpoint, 3 where the labels
    settle in round 3."""
    still = torch.zeros((20, 30), dtype=torch.uint8)
    fixpoint = (torch.zeros((20, 30)), still,
                torch.full((4, 20, 30), 3, dtype=torch.int32))
    for (disp, outl, arms), want in ((fixpoint, 1),
                                     (_irv_case(0.3, 2), 3)):
        assert _first_still_round(disp, outl, arms, IRV_ARGS[-1]) == want
        rounds = []
        evs = _traced(lambda: rounds.append(tirv.dr_irv_early_stop(
            disp, outl, arms, *IRV_ARGS, rounds, row_chunk=row_chunk)),
            tmp_path)
        early = rounds.pop()
        assert rounds == [want]
        fixed = tirv.dr_irv(disp, outl, arms, *IRV_ARGS)
        assert torch.equal(fixed[0], early[0])
        assert torch.equal(fixed[1], early[1])
        reads = [e for e in evs if e[1] == "aten::_local_scalar_dense"]
        votes = [e for e in evs if e[1] == "aten::argmax"]
        assert len(reads) == 1 and len(votes) >= IRV_ARGS[-1]
        assert reads[0][2] >= max(v[3] for v in votes)


@pytest.mark.parametrize("cfg", [HSLO, CFG], ids=["hslo", "wta"])
def test_scanline_work_falls_in_dc_hslo_inside_the_core(tmp_path, cfg):
    """With use_hslo the scanline optimisation's work (its WTA's argmin,
    the only one in the core then) lies in one `dc_hslo` range nested in
    `stereo_core`; without it no `dc_hslo` range is opened."""
    sbs = _frames()[0]
    evs = _traced(lambda: tpipe.process_frame(sbs, cfg, device="cpu"),
                  tmp_path)
    spans = [e for e in evs if e[1] == "dc_hslo"]
    if not cfg.use_hslo:
        assert spans == []
        return
    assert len(spans) == 1
    assert _parents(evs, spans[0]) == {"stereo_core"}
    argmins = [e for e in evs if e[1] == "aten::argmin"
               and "stereo_core" in _parents(evs, e)]
    assert argmins
    assert all("dc_hslo" in _parents(evs, e) for e in argmins)
    assert "filter_median" in [e[1] for e in evs]


@pytest.mark.parametrize("cfg,calls", [(HSLO, [2] * N_FRAMES), (CFG, [])],
                         ids=["hslo", "wta"])
def test_b13_is_one_counted_launch_a_frame(monkeypatch, cfg, calls):
    """The launch counter the benchmark reads (`kernels.wrappers()`) holds
    B13's wrapper, which a frame of the scanline route calls once with
    both eyes' volumes (one launch on the card), and the other route
    never."""
    wrapper = kernels.wrappers()["dc_hslo_wta_eyes"]
    assert wrapper is hslokern.dc_hslo_wta_eyes
    seen = []
    monkeypatch.setattr(hslokern, "dc_hslo_wta_eyes", lambda vols, *a:
                        seen.append(len(vols)) or wrapper(vols, *a))
    tstream.stream(iter(_frames()), cfg, prefetch=0, verbose=False,
                   device="cpu")
    assert seen == calls
