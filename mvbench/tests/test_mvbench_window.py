import itertools
import statistics

import pytest
import torch

from mvbench.harness.window import Window, percentile, window_stats


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert percentile(xs, 0) == 1.0
    assert percentile(xs, 100) == 5.0
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 95) == pytest.approx(4.8)
    assert percentile([7.0], 95) == 7.0


def test_p95_is_over_all_frames_not_over_chunk_medians():
    # nine fast frames a chunk and one slow one: every chunk's median is
    # fast, the tail of all frames is not
    lat = [1.0] * 9 + [10.0]
    lats = lat * 20
    taken = {i: float(i) for i in range(len(lats))}
    done = {i: taken[i] + lats[i] for i in taken}
    st = window_stats(taken, done)
    chunk_medians = [statistics.median(lats[i:i + 10])
                     for i in range(0, len(lats), 10)]
    assert max(chunk_medians) == 1.0
    assert percentile([x for x in st["latency_s"]], 95) == 10.0


def test_fps_is_frames_over_the_whole_window():
    # hand-over at 0, 1, 2, 3; completions late and uneven
    taken = {0: 0.0, 1: 1.0, 2: 2.0, 3: 3.0}
    done = {0: 1.5, 1: 2.0, 2: 4.0, 3: 8.0}
    st = window_stats(taken, done)
    assert st["seconds"] == 8.0
    assert st["fps"] == 4 / 8.0
    assert st["latency_s"] == [1.5, 1.0, 2.0, 5.0]


class Clock:
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_window_stops_at_its_seconds_and_marks_run_once():
    seen = []
    win = Window(ring=["a", "b", "c"], seconds=1.0, seed=1,
                 clock=Clock(0.1), marks={2: lambda: seen.append(2)})
    frames = list(win.source())
    assert frames[:4] == ["a", "b", "c", "a"]
    assert len(frames) == len(win.taken) and seen == [2]
    assert max(win.taken.values()) - win.t_start < 1.0


def test_hold_keeps_the_window_open():
    state = {"open": True}
    win = Window(ring=[0], seconds=0.0, seed=1, clock=Clock(0.1),
                 marks={5: lambda: state.update(open=False)},
                 hold=lambda: state["open"])
    assert len(list(win.source())) == 5


def test_sample_is_uniform_seeded_and_copied():
    def run(seed, n=200):
        slots = [(torch.zeros(1), torch.zeros(1), torch.zeros(1))
                 for _ in range(3)]
        win = Window(ring=[0], seconds=1.0, seed=seed, slots=slots)
        for i in range(n):
            v = torch.full((1,), float(i))
            win.on_frame(i, v, v, v)
        for j, i in win.sampled.items():
            assert all(float(t) == i for t in slots[j])
        return sorted(win.sampled.values())
    assert run(11) == run(11)
    assert run(11) != run(12)
    picks = list(itertools.chain.from_iterable(run(s) for s in range(300)))
    # uniform over the 200 frames: about half the picks in each half
    assert 0.4 < sum(p < 100 for p in picks) / len(picks) < 0.6
