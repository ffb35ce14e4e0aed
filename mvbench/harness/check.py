"""The comparison that decides `correct`: the program's outputs of sampled
frames of the window against the cell's plain reference (the module its
configuration names) on the same input.

Two numbers, each summed over the sampled frames: the pixels of both eyes
whose final disparity differs from the reference's in any bit, and the
subpixels of the interlaced frame that differ.  The reference follows the
same integer aggregation and the same float operations in the same order,
so a sound program reads 0 in both (the limits, 0, and the readings they
were set from are in PERF.md).
"""

from __future__ import annotations

import torch

LIMITS = {"disp_px_off": 0, "interlace_sub_off": 0}


def compare(outputs, ref) -> dict:
    """{number: value} of one frame: outputs and ref are (disp_l, disp_r,
    interlaced)."""
    px = sum(int(torch.count_nonzero(a.view(torch.int32)
                                     != b.view(torch.int32)))
             for a, b in zip(outputs[:2], ref[:2]))
    sub = int(torch.count_nonzero(outputs[2] != ref[2]))
    return {"disp_px_off": px, "interlace_sub_off": sub}


def check_samples(samples, frame_of, pipeline: dict, reference) -> dict:
    """Sum of `compare` over the samples [(frame index, outputs)];
    `frame_of(i)` is frame i's SBS input on the outputs' device and
    `reference` the module whose process_frame(sbs, pipeline) recomputes
    the outputs."""
    total = {k: 0 for k in LIMITS}
    for i, outputs in samples:
        with torch.no_grad():
            ref = reference.process_frame(frame_of(i), pipeline)
        for k, v in compare(outputs, ref).items():
            total[k] += v
        del ref
    return total


def verdict(values: dict) -> tuple:
    """(correct, {number: {"value", "limit"}})."""
    checks = {k: {"value": values[k], "limit": LIMITS[k]} for k in LIMITS}
    return all(values[k] <= LIMITS[k] for k in LIMITS), checks
