"""The plain reference against the port's plain versions
(`process_frame(..., device="cpu")`) on a small frame of each
configuration's settings: disparities and the interlaced frame agree bit
for bit (the same arithmetic, on the same device)."""

import dataclasses

import numpy as np
import pytest
import torch

from mvbench.harness.cells import load_json
from mvbench.harness.frames import make_ring
from mvbench.reference import plain
from stereo_to_multiview_tpu_torch.config import config_from_dict
from stereo_to_multiview_tpu_torch.models.pipeline import process_frame

from conftest import ROOT, SMALL


def small_cfg(name, **kw):
    pipe = load_json(ROOT / "mvbench" / "configs" / f"{name}.json")[
        "pipeline"]
    return dict(pipe, **dict(SMALL, **kw))


@pytest.mark.parametrize("name", ["hd1080_d128", "uhd4k_16v"])
@pytest.mark.parametrize("block", [96, 40])
@pytest.mark.parametrize("arms", [{}, {"usd": 34, "lsd": 17}])
def test_reference_equals_the_ports_plain_versions(name, block, arms):
    pipe = small_cfg(name, **arms)
    sbs = make_ring(2 ** 31 + 5, 96, 160, 1.0, "cpu", n=1)[0]
    got = process_frame(sbs.numpy(), config_from_dict(pipe), device="cpu")
    ref = plain.process_frame(sbs, pipe, block=block)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_reference_at_the_row_chunks_of_the_4k_preset():
    # chunked core and IRV in the program, other blocks in the reference
    pipe = small_cfg("uhd4k_16v", usd=6, lsd=3, band_row_chunk=24,
                     irv_row_chunk=32)
    sbs = make_ring(77, 96, 160, 1.0, "cpu", n=1)[0]
    got = process_frame(sbs.numpy(), config_from_dict(pipe), device="cpu")
    ref = plain.process_frame(sbs, pipe, block=20)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_reference_refuses_what_it_does_not_compute():
    pipe = small_cfg("hd1080_d128", band_lossy_wta=True)
    sbs = torch.zeros((96, 320, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        plain.process_frame(sbs, pipe)


def test_rescale_shifts_are_the_configurations():
    assert plain.rescale_shifts(34, 3, 127.0) == [0, 3, 6]
    assert plain.rescale_shifts(34, 2, 127.0) == [0, 6, 6]


def test_cost_table_is_built_from_the_formula():
    t = plain.cost_table(10.0, 30.0, 127.0)
    assert t.dtype == torch.uint8 and t.numel() == 766 * 49
    ad, ham = 300, 20
    c = (1 - np.exp(-(ad * np.float32(0.33333333333)) / 10.0)
         + 1 - np.exp(-ham / 30.0))
    assert abs(int(t[ad * 49 + ham]) - round(127 * c)) <= 1
