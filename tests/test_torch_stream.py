"""The port's runtime layer on the CPU: its native host library, frame
sources, stream driver, dump API and preview server; the torch twins of
tests/test_runtime.py, with device="cpu", and the port's stream held
against the JAX package's stream frame by frame.

The meter test checks, instead of a wall-clock bound, that no metered
interval holds any part of a consumer's call.  Against JAX `stream`
(engine="band" on both sides, the JAX kernels in interpret mode) the
frames come in the same order and differ only as the whole frame does
(tests/test_torch_pipeline.py): the disparities to the bit with
bilateral radius 0, within an ulp of the bilateral's exp with radius 2;
the interlace by +-1 at a few subpixels, where JAX's fused band warp
departs from its own unfused synthesis, which the port's equals.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models import stream as tstream
from stereo_to_multiview_tpu_torch.models.pipeline import process_frame
from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp, write_bmp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = PipelineConfig(num_rows=24, num_cols=32, num_rows_out=24,
                     num_cols_out=32, num_disp=4, zero_disp=2, usd=4, lsd=2,
                     num_views=2, irv_iterations=1, bilateral_radius=2,
                     feather_radius=2)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """Four tiny SBS frames on disk."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(7)
    for i in range(4):
        write_bmp(str(d / f"frame_{i:03d}.bmp"),
                  rng.integers(0, 256, (24, 64, 3), dtype=np.uint8))
    return str(d)


def _native():
    from stereo_to_multiview_tpu_torch import native
    if not native.available():
        pytest.skip("no host C++ compiler")
    return native


def test_native_bmp_matches_python():
    native = _native()
    p = os.path.join(DATA, "bud_2.bmp")
    np.testing.assert_array_equal(native.read_bmp(p), read_bmp(p))


def test_native_bmp_write_roundtrip(tmp_path):
    native = _native()
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (17, 31, 3), dtype=np.uint8)  # odd row pad
    p = str(tmp_path / "t.bmp")
    native.write_bmp(p, img)
    np.testing.assert_array_equal(read_bmp(p), img)
    np.testing.assert_array_equal(native.read_bmp(p), img)
    # and the port's own numpy writer
    q = str(tmp_path / "u.bmp")
    write_bmp(q, img)
    np.testing.assert_array_equal(native.read_bmp(q), img)


def test_native_queue_order_and_loops(frames_dir):
    _native()
    src = tstream.native_source(frames_dir, loops=2, depth=2, threads=3)
    frames = list(src)
    assert len(frames) == 8
    # in-order delivery across loops, even with 3 decode threads
    ref = [read_bmp(os.path.join(frames_dir, f"frame_{i:03d}.bmp"))
           for i in range(4)]
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f, ref[i % 4])


def test_frame_source_pair_mode_nonoverlapping(tmp_path):
    """Pair mode takes sorted files two at a time -- (f0,f1), (f2,f3) --
    never overlapping pairs; a trailing unpaired file is dropped and a
    shape-mismatched pair is skipped."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)
            for _ in range(4)]
    for i, img in enumerate(imgs):
        write_bmp(str(tmp_path / f"a_{i + 1}.bmp"), img)
    write_bmp(str(tmp_path / "a_5.bmp"),
              rng.integers(0, 256, (16, 20, 3), dtype=np.uint8))  # unpaired
    frames = list(tstream.FrameSource(str(tmp_path), pair_mode=True,
                                      loop=False))
    assert len(frames) == 2
    np.testing.assert_array_equal(frames[0],
                                  np.concatenate([imgs[0], imgs[1]], axis=1))
    np.testing.assert_array_equal(frames[1],
                                  np.concatenate([imgs[2], imgs[3]], axis=1))
    write_bmp(str(tmp_path / "a_0.bmp"),
              rng.integers(0, 256, (18, 20, 3), dtype=np.uint8))
    frames = list(tstream.FrameSource(str(tmp_path), pair_mode=True,
                                      loop=False))
    assert len(frames) == 2   # (a_0,a_1) bad, (a_2,a_3), (a_4,a_5)


def test_stream_driver(frames_dir):
    seen = []
    stats = tstream.stream(tstream.FrameSource(frames_dir, loop=False), CFG,
                           on_frame=lambda i, dl, dr, il: seen.append(i),
                           verbose=False, device="cpu")
    assert seen == [0, 1, 2, 3]
    assert stats["frames"] >= 1


def test_stream_driver_meter_excludes_consumer(frames_dir, monkeypatch):
    """At depth 1 the meter times exactly the upload+compute+fetch span:
    no metered interval holds any part of a slow consumer's call (the
    intervals are recorded as the meter takes them)."""
    spans, calls = [], []

    class Meter(tstream.FrameMeter):
        def add(self, seconds):
            end = time.perf_counter()
            spans.append((end - seconds, end))
            super().add(seconds)

    def consumer(i, dl, dr, il):
        t = time.perf_counter()
        time.sleep(0.05)
        calls.append((t, time.perf_counter()))

    monkeypatch.setattr(tstream, "FrameMeter", Meter)
    stats = tstream.stream(tstream.FrameSource(frames_dir, loop=False), CFG,
                           on_frame=consumer, verbose=False, depth=1,
                           device="cpu")
    assert stats["frames"] >= 1 and len(spans) == len(calls) == 4
    for s0, s1 in spans:
        for c0, c1 in calls:
            assert c1 <= s0 or c0 >= s1


@pytest.mark.parametrize("readback", ["full", "sync"])
def test_stream_driver_pipelined(frames_dir, readback):
    """depth >= 2 (frames in flight) delivers every frame, in order, with
    outputs identical to the serial loop and to process_frame frame by
    frame."""
    got = {}
    for d in (1, 3):
        seen, outs = [], []
        tstream.stream(tstream.FrameSource(frames_dir, loop=False), CFG,
                       on_frame=lambda i, dl, dr, il: (seen.append(i),
                                                       outs.append((dl, dr,
                                                                    il))),
                       verbose=False, depth=d, readback=readback,
                       device="cpu")
        assert seen == [0, 1, 2, 3]
        got[d] = outs
    frames = list(tstream.FrameSource(frames_dir, loop=False))
    for a, b, sbs in zip(got[1], got[3], frames):
        ref = process_frame(sbs, CFG, device="cpu")
        for x, y, z in zip(a, b, ref):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_stream_failure_policy(frames_dir, tmp_path):
    """A bad frame is skipped; more than max_consecutive_failures in a
    row abort the stream."""
    bad = np.zeros((10, 10, 3), np.uint8)
    good = list(tstream.FrameSource(frames_dir, loop=False))
    seen = []
    tstream.stream([good[0], bad, good[1]], CFG, prefetch=0, verbose=False,
                   on_frame=lambda i, *a: seen.append(i), device="cpu")
    assert seen == [0, 2]
    with pytest.raises(ValueError, match="uint8 frame"):
        tstream.stream([good[0]] + [bad] * 4, CFG, prefetch=0,
                       verbose=False, max_consecutive_failures=3,
                       device="cpu")


def test_stream_without_gpu_raises(frames_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstream.stream(tstream.FrameSource(frames_dir, loop=False), CFG,
                       verbose=False)
    with pytest.raises(ValueError, match="readback"):
        tstream.stream([], CFG, readback="all", device="cpu")


def test_dump_writer(tmp_path):
    from stereo_to_multiview_tpu_torch.utils.dump import (
        DumpWriter, dump_pipeline_intermediates)
    rng = np.random.default_rng(11)
    l = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    r = np.roll(l, -2, axis=1)
    cfg = CFG.replace(num_views=3)
    w = DumpWriter(str(tmp_path), png=True, npy=True)
    outs = dump_pipeline_intermediates(w, l, r, cfg, device="cpu")
    names = os.listdir(str(tmp_path))
    for expected in ("00_left.png", "06_disp_l.png", "09_interlaced.png",
                     "08_view_0.png", "08_view_2.png", "06_disp_l.npy"):
        assert expected in names, f"missing {expected}"
    assert outs["interlaced"].shape == (24, 32, 3)


def test_y4m_native_matches_python(tmp_path):
    """The native C++ Y4M reader and the NumPy one decode bit-identical
    BGR; the roundtrip through C444 stays within the BT.601 integer
    conversion's error."""
    from stereo_to_multiview_tpu_torch import native
    from stereo_to_multiview_tpu_torch.utils.y4m import Y4MReader, write_y4m
    rng = np.random.default_rng(21)
    # 25-wide frames: odd width exercises the C422 cw=(w+1)/2 sizing
    for shape in ((16, 24, 3), (16, 25, 3)):
        frames = [rng.integers(0, 256, shape, dtype=np.uint8)
                  for _ in range(3)]
        for cs in ("C444", "C422", "C420jpeg"):
            path = str(tmp_path / f"clip_{cs}_{shape[1]}.y4m")
            write_y4m(path, frames, colorspace=cs)
            py = list(Y4MReader(path))
            assert len(py) == 3
            if native.available():
                nat = list(native.NativeY4M(path))
                assert len(nat) == 3
                for a, b in zip(py, nat):
                    np.testing.assert_array_equal(a, b)
    frames = [rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
              for _ in range(3)]
    path = str(tmp_path / "clip_C444.y4m")
    write_y4m(path, frames, colorspace="C444")
    for orig, back in zip(frames, Y4MReader(path)):
        assert np.abs(orig.astype(int) - back.astype(int)).max() <= 4


def test_y4m_stream_through_pipeline(tmp_path):
    """Y4M video -> Y4MSource -> the pipeline, looping past EOF; each
    frame equal to process_frame on the decoded frame."""
    from stereo_to_multiview_tpu_torch.utils.y4m import Y4MReader, write_y4m
    rng = np.random.default_rng(22)
    base = rng.integers(0, 256, (24, 36, 3), dtype=np.uint8)
    sbs_frames = []
    for t in range(3):
        l = np.roll(base, t, axis=1)[:, :32]
        r = np.roll(base, t + 2, axis=1)[:, :32]
        sbs_frames.append(np.concatenate([l, r], axis=1))
    path = str(tmp_path / "clip.y4m")
    write_y4m(path, sbs_frames, colorspace="C444")
    decoded = list(Y4MReader(path))
    src = tstream.Y4MSource(path, loop=True, max_frames=5)
    assert src.reader in ("native", "python")
    seen = []

    def check(i, dl, dr, il):
        seen.append(i)
        ref = process_frame(decoded[i % 3], CFG, device="cpu")
        assert torch.equal(il, ref[2]) and torch.equal(dl, ref[0])

    tstream.stream(src, CFG, on_frame=check, verbose=False, depth=2,
                   device="cpu")
    assert seen == [0, 1, 2, 3, 4]


def test_ffmpeg_pipe_source(tmp_path):
    """FFmpegSource: ingestion through a yuv4mpegpipe subprocess into the
    Y4M parser.  The producer is a stub command streaming a generated
    clip (ffmpeg emits the same format): the pipe, the respawn at EOF,
    max_frames, a second iteration, and the missing-binary error."""
    from stereo_to_multiview_tpu_torch.utils.y4m import Y4MReader, write_y4m
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)
              for _ in range(3)]
    clip = str(tmp_path / "clip.y4m")
    write_y4m(clip, frames, colorspace="C420")

    class StubSource(tstream.FFmpegSource):
        def _command(self):
            return [sys.executable, "-c",
                    "import sys, shutil; "
                    "shutil.copyfileobj(open(sys.argv[1], 'rb'), "
                    "sys.stdout.buffer)", self.path]

    src = StubSource(clip, loop=True, max_frames=7, ffmpeg=sys.executable)
    got = list(src)
    assert len(got) == 7                      # EOF respawn looped 3+3+1
    ref = list(Y4MReader(clip))
    for i, fr in enumerate(got):
        np.testing.assert_array_equal(fr, ref[i % 3])
    assert src.h == 32 and src.w == 64
    src2 = StubSource(clip, loop=False, ffmpeg=sys.executable)
    assert len(list(src2)) == 3
    assert len(list(src2)) == 3
    with pytest.raises(FileNotFoundError):
        tstream.FFmpegSource(clip, ffmpeg="definitely-not-ffmpeg-xyz")


def test_preview_server():
    """The live-preview HTTP server: frames as PNG snapshots, the index
    page, and the pause/resume flag."""
    import urllib.error
    import urllib.request
    from stereo_to_multiview_tpu_torch.utils.imageio import png_bytes
    from stereo_to_multiview_tpu_torch.utils.preview import PreviewServer

    pv = PreviewServer(port=0, host="127.0.0.1")
    try:
        img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
        pv.update(interlaced=img, skipped=None)
        base = f"http://127.0.0.1:{pv.port}"
        got = urllib.request.urlopen(f"{base}/frame/interlaced").read()
        assert got == png_bytes(img, level=1)
        page = urllib.request.urlopen(base).read().decode()
        assert "interlaced" in page and "frame 1" in page
        urllib.request.urlopen(f"{base}/pause").read()
        assert pv.paused
        urllib.request.urlopen(f"{base}/resume").read()
        assert not pv.paused
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/frame/nope")
    finally:
        pv.close()


def test_timing_utilities():
    from stereo_to_multiview_tpu_torch.utils.timing import FrameMeter, Timer
    with Timer("t", verbose=False) as t:
        pass
    assert t.ms >= 0.0
    m = FrameMeter(warmup=1)
    for s in (1.0, 0.5, 0.25):
        m.add(s)
    assert m.stats() == {"frames": 2, "fps": 2 / 0.75, "ms_mean": 375.0,
                         "ms_min": 250.0, "ms_max": 500.0}


@pytest.mark.parametrize("radius", [0, 2])
def test_stream_matches_jax_stream(tmp_path, radius):
    """The port's stream and JAX `stream`, engine="band" on both sides,
    on the same 4 SBS frames (shifted crops of the bud pair): the same
    frames in the same order; the disparities equal to the bit with
    bilateral radius 0 (a range weight of e^0 on both sides) and within
    1e-5 with radius 2 (the bilateral's exp); the interlace equal but for
    +-1 at no more than 0.5% of subpixels (JAX's fused band warp
    contracts its lerp; at radius 0 the port's frame equals JAX's
    unfused synthesis of the same disparities, exactly)."""
    import jax.numpy as jnp
    from stereo_to_multiview_tpu import ops as jops
    from stereo_to_multiview_tpu.config import PipelineConfig as JaxConfig
    from stereo_to_multiview_tpu.models import pipeline as jpipe
    from stereo_to_multiview_tpu.models.stream import (
        FrameSource as JaxSource, stream as jax_stream)

    l = read_bmp(os.path.join(DATA, "bud_2.bmp"))[100:172:2, 200:304:2]
    r = read_bmp(os.path.join(DATA, "bud_3.bmp"))[100:172:2, 200:304:2]
    for i in range(4):
        write_bmp(str(tmp_path / f"f_{i}.bmp"),
                  np.concatenate([np.roll(l, 2 * i, 1), np.roll(r, 2 * i, 1)],
                                 axis=1))
    knobs = dict(num_rows=36, num_cols=52, num_rows_out=36, num_cols_out=52,
                 num_disp=12, zero_disp=6, usd=5, lsd=2, num_views=8,
                 irv_iterations=3, irv_thresh_s=5, bilateral_radius=radius,
                 feather_radius=3, engine="band")
    theirs, ours = [], []
    jax_stream(JaxSource(str(tmp_path), loop=False), JaxConfig(**knobs),
               on_frame=lambda i, *o: theirs.append(
                   (i, [np.asarray(x) for x in o])), verbose=False, depth=2)
    tstream.stream(tstream.FrameSource(str(tmp_path), loop=False),
                   PipelineConfig(**knobs),
                   on_frame=lambda i, *o: ours.append(
                       (i, [x.numpy() for x in o])), verbose=False, depth=2,
                   device="cpu")
    assert [i for i, _ in ours] == [i for i, _ in theirs] == [0, 1, 2, 3]
    jcfg = JaxConfig(**knobs)
    frames = list(tstream.FrameSource(str(tmp_path), loop=False))
    for (_, a), (_, b), sbs in zip(ours, theirs, frames):
        tol = 0.0 if radius == 0 else 1e-5
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=tol)
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=tol)
        if radius == 0:
            jl, jr = jops.demux_sbs(jnp.asarray(sbs))
            views = jpipe.synthesize_views(jl, jr, jnp.asarray(b[0]),
                                           jnp.asarray(b[1]),
                                           jcfg.replace(engine="xla"))
            np.testing.assert_array_equal(a[2], np.asarray(
                jops.mux_multiview(views, 36, 52, jcfg.angle)))
        diff = a[2] != b[2]
        assert np.all(np.abs(a[2].astype(int) - b[2])[diff] == 1)
        assert np.mean(diff) <= 5e-3
