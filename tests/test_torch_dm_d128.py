"""Kernel B16's plain version at the main path's disparity range, D=128
and zero_disp=64, against the JAX package's stacked cost kernel (Pallas,
interpret mode on the CPU).  In a file of its own: the JAX side takes
about a minute to trace its 256 unrolled planes, and the test runner
hands a file to one worker.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu.ops import costkern as jck

from stereo_to_multiview_tpu_torch.ops import costkern as tck

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def d128_volumes():
    rng = np.random.default_rng(31)
    left = rng.integers(0, 256, (6, 40, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (6, 40, 3), dtype=np.uint8)
    ref = jck.ci_adcensus_kern_stacked(
        jnp.asarray(left), jnp.asarray(right), 10.0, 30.0, 128, 64,
        quant=True, interpret=True)
    got = tck.ci_adcensus_kern_stacked(
        torch.from_numpy(left), torch.from_numpy(right), 10.0, 30.0, 128, 64)
    return np.asarray(ref), got


@pytest.mark.parametrize("eye", ["left", "right"])
def test_ci_adcensus_kern_stacked_d128_matches_jax(eye, d128_volumes):
    """On a 40-column frame every disparity reaches past a border, so
    both clamps are exercised on every plane; u8, exact."""
    ref, got = d128_volumes
    sl = slice(0, 128) if eye == "left" else slice(128, 256)
    assert got.shape == (256, 6, 40) and got.dtype == torch.uint8
    np.testing.assert_array_equal(ref[sl], got.numpy()[sl])
