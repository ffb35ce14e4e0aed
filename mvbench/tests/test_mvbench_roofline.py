"""The stereo core's bound functions reproduce the bounds the port's
kernel table gives (1080p, and the 680x3840 chunk of the 4K frame)."""

import importlib.util

import pytest

from mvbench.harness.cells import load_json, load_metric
from mvbench.harness.trace import DeviceEvent, Stretch

from conftest import ROOT

roof = load_metric("core_roofline")


@pytest.mark.parametrize("start,rows,h,w,want", [
    (0, 1080, 1080, 1920, (0.088, 0.164, 0.401, 0.639, 0.324)),
    (1012, 680, 2160, 3840, (0.108, 0.203, 0.505, 0.804, 0.408)),
])
def test_bounds_of_each_kernel(start, rows, h, w, want):
    b = roof.launch_bounds(start, rows, h, w, 128, 64)
    got = tuple(round(b[k], 3) for k in ("B2", "B3", "B4", "B5", "B6"))
    assert got == want


def test_chunks_are_the_programs():
    from stereo_to_multiview_tpu_torch.ops.chunks import chunk_bounds
    for h, chunk, halo in ((2160, 540, 68), (1080, 1080, 68), (96, 24, 12)):
        ext, bounds = chunk_bounds(h, chunk, halo)
        assert roof.chunk_rows(h, chunk, halo) == [(s, ext)
                                                   for s, _ in bounds]


def test_frame_bounds_sum_as_the_kernel_table():
    hd = load_json(ROOT / "mvbench/configs/hd1080_d128.json")["pipeline"]
    b = roof.mean_bounds(hd)
    frame = b["B2"] + b["B3"] + 2 * (b["B4"] + b["B5"] + b["B6"])
    assert frame == pytest.approx(2.98, abs=0.01)
    uhd = load_json(ROOT / "mvbench/configs/uhd4k_16v.json")["pipeline"]
    b = roof.mean_bounds(uhd)
    frame = 4 * (b["B2"] + b["B3"] + 2 * (b["B4"] + b["B5"] + b["B6"]))
    assert frame == pytest.approx(14.98, abs=0.05)


@pytest.mark.parametrize("name,kind", [
    ("void cost_pair_kernel<unsigned char, true, 1>(CostArgs)", "B2"),
    ("void shear_stream_kernel<unsigned char, 32, 1>(unsigned char const*)",
     "B3"),
    ("void hpass_kernel<unsigned char, false, 32, true, false>(x)", "B4"),
    ("void hpass_kernel<int, true, 32, true, false>(int const*)", "B6"),
    ("_Z12hpass_kernelIhLb0ELi32ELb1ELb0EEvPKT_x", "B4"),
    ("_Z12hpass_kernelIiLb1ELi32ELb1ELb0EEvPKT_x", "B6"),
    ("vpass_kernel(int const*, int const*)", "B5"),
    ("void at::native::CatArrayBatchedCopy<int>()", None),
])
def test_kernel_kinds(name, kind):
    assert roof.kind(name) == kind


def test_share_is_bound_over_device_time_with_unbounded_work_counted():
    hd = load_json(ROOT / "mvbench/configs/hd1080_d128.json")["pipeline"]
    b = roof.mean_bounds(hd)
    evs = [DeviceEvent("vpass_kernel(x)", "kernel", 0.0,
                       2 * b["B5"] * 1e3, "stereo_core"),
           DeviceEvent("copy", "kernel", 0.0, 2 * b["B5"] * 1e3,
                       "stereo_core"),
           DeviceEvent("vpass_kernel(x)", "kernel", 0.0, 5.0, "dr_irv")]
    log = []
    st = Stretch(frames=1, window_us=1.0, events=evs, counters={}, config=hd)
    assert roof.read(st, log) == pytest.approx(25.0)
    assert len(log) == 1 and "copy" in log[0]
