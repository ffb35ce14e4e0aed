"""Frames in host memory: the seeded ring of `harness/frames.py`, made on
the run's device and copied into numpy arrays, which the stream takes as
a decoder would hand them over and uploads itself."""

import torch

from mvbench.harness.frames import Frames, make_ring


def make(seed: int, cfg, mix: dict, device) -> Frames:
    ring = make_ring(seed, cfg.num_rows, cfg.num_cols, mix["noise_sigma"],
                     device)
    host = [f.cpu().numpy() for f in ring]
    del ring
    return Frames(host, lambda i: torch.from_numpy(host[i % len(host)]).to(
        device))
