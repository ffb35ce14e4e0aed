"""The port's two apps (`stereo_to_multiview_tpu_torch.apps.image_io`,
`.video_io`) run through their `main([...])` with --cpu on tiny inputs,
against the JAX package's apps on the same inputs and arguments.

The image app's NPY dumps equal the JAX app's to the bit, under the same
file names: its stages are the XLA engine's functions evaluated one by
one, as the JAX app's dump evaluates them.  The video app writes the
files the JAX app writes, under the same names.  Without a GPU and
without --cpu each app exits non-zero and writes nothing.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "apps"))

import image_io as jimage_io          # noqa: E402  the JAX package's apps
import video_io as jvideo_io          # noqa: E402

from stereo_to_multiview_tpu_torch.apps import (  # noqa: E402
    image_io, video_io)
from stereo_to_multiview_tpu_torch.utils.bmp import (  # noqa: E402
    read_bmp, write_bmp)

torch.set_num_threads(1)

DATA = os.path.join(REPO, "tests", "data")
# AD_COEFF CENSUS_COEFF NDISP ZERODISP UCD LCD USD LSD NVIEWS ANGLE OUT_W
# OUT_H THRESH_S THRESH_H of a 36x52 pair
IMAGE_ARGS = ["10", "30", "12", "6", "20", "6", "5", "2", "8", "18.43",
              "52", "36", "5", "0.4"]
# NVIEWS ANGLE OUT_W OUT_H NDISP ZERODISP AD_COEFF CENSUS_COEFF UCD LCD
# USD LSD THRESH_S THRESH_H
VIDEO_ARGS = ["8", "18.43", "52", "36", "12", "6", "10", "30", "20", "6",
              "5", "2", "5", "0.4"]


def _crop(name):
    img = read_bmp(os.path.join(DATA, name))[100:172:2, 200:304:2]
    return np.ascontiguousarray(img)


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("img")
    write_bmp(str(d / "left.bmp"), _crop("bud_2.bmp"))
    write_bmp(str(d / "right.bmp"), _crop("bud_3.bmp"))
    return str(d)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """Four SBS frames: shifted crops of the bud pair."""
    d = tmp_path_factory.mktemp("frames")
    l, r = _crop("bud_2.bmp"), _crop("bud_3.bmp")
    for i in range(4):
        write_bmp(str(d / f"frame_{i:03d}.bmp"),
                  np.concatenate([np.roll(l, 3 * i, 1), np.roll(r, 3 * i, 1)],
                                 axis=1))
    return str(d)


def test_image_app_dumps_equal_the_jax_app(img_dir, tmp_path):
    argv = ["left", "right", *IMAGE_ARGS, "--img-dir", img_dir, "--npy",
            "--cpu"]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert image_io.main(argv + ["--out-dir", str(ours)]) == 0
    assert jimage_io.main(argv + ["--out-dir", str(theirs)]) == 0
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    assert "09_interlaced.npy" in names and "08_view_7.png" in names
    npys = [n for n in names if n.endswith(".npy")]
    assert len(npys) == 2 + 2 + 2 + 2 + 2 + 8 + 1
    for n in npys:
        a, b = np.load(ours / n), np.load(theirs / n)
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_image_app_cost_slices_and_irv_rounds(img_dir, tmp_path):
    """--cost-slices and --irv-iterations, the app's other options: the
    same files and values as the JAX app's."""
    argv = ["left", "right", *IMAGE_ARGS, "--img-dir", img_dir, "--npy",
            "--cost-slices", "--irv-iterations", "3", "--cpu"]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert image_io.main(argv + ["--out-dir", str(ours)]) == 0
    assert jimage_io.main(argv + ["--out-dir", str(theirs)]) == 0
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    assert "02_cost_l.npy" in names and "03_acost_l_d008.png" in names
    for n in ("02_cost_l.npy", "03_acost_l.npy", "06_disp_l.npy",
              "06_disp_r.npy", "09_interlaced.npy"):
        np.testing.assert_array_equal(np.load(ours / n), np.load(theirs / n),
                                      err_msg=n)


@pytest.mark.parametrize("extra", [
    ["--depth", "2", "--readback", "sync"], ["--depth", "1"],
    ["--lowres", "18x26:0.5"]], ids=["depth2_sync", "depth1", "lowres"])
def test_video_app_writes_the_jax_apps_files(frames_dir, tmp_path, extra):
    argv = [frames_dir, *VIDEO_ARGS, "--frames", "5", "--no-loop", "--cpu"]
    if extra[0] == "--lowres":
        # the lowres disparity range: D=8, zero_disp 4
        argv[5:7] = ["8", "4"]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert video_io.main(argv + extra + ["--out-dir", str(ours)]) == 0
    assert jvideo_io.main(argv + extra + ["--out-dir", str(theirs)]) == 0
    names = sorted(os.listdir(ours))
    # --no-loop: the four frames once
    assert names == [f"{k}_{i:04d}.png" for k in ("disp_l", "interlaced")
                     for i in range(4)]
    assert names == sorted(os.listdir(theirs))


def test_video_app_reads_y4m(frames_dir, tmp_path):
    """A Y4M file in place of the frame directory, looping past its end
    (--frames 6 of 4 frames)."""
    from stereo_to_multiview_tpu_torch.utils.y4m import write_y4m
    frames = [read_bmp(os.path.join(frames_dir, f)) for f in
              sorted(os.listdir(frames_dir))]
    clip = str(tmp_path / "clip.y4m")
    write_y4m(clip, frames, colorspace="C444")
    out = tmp_path / "out"
    assert video_io.main([clip, *VIDEO_ARGS, "--frames", "6", "--cpu",
                          "--out-dir", str(out)]) == 0
    assert len(os.listdir(out)) == 12


@pytest.mark.parametrize("app", ["image", "video"])
def test_apps_without_gpu_exit_nonzero(monkeypatch, img_dir, frames_dir,
                                       tmp_path, capsys, app):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    if app == "image":
        rc = image_io.main(["left", "right", *IMAGE_ARGS, "--img-dir",
                            img_dir, "--out-dir", str(out)])
    else:
        rc = video_io.main([frames_dir, *VIDEO_ARGS, "--frames", "2",
                            "--out-dir", str(out)])
    assert rc != 0
    assert "device='cpu'" in capsys.readouterr().err
    assert not out.exists()
