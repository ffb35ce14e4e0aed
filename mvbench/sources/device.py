"""Frames in device memory: the seeded ring of `harness/frames.py`, made
on the run's device and handed to the stream there, as a decoder that
writes device memory would (the stream's transfers are bypassed)."""

from mvbench.harness.frames import Frames, make_ring


def make(seed: int, cfg, mix: dict, device) -> Frames:
    ring = make_ring(seed, cfg.num_rows, cfg.num_cols, mix["noise_sigma"],
                     device)
    return Frames(ring, lambda i: ring[i % len(ring)])
