"""`ci_adcensus_kern(shift_extract=True)` at the main path's reach, D=128
and zero_disp=64, on a 385-column frame (its right border strip straddles
two of the JAX package's 128-column tiles), against the JAX package's
shift extraction (Pallas, interpret mode on the CPU).  In a file of its
own: the JAX side traces four kernels of 128 unrolled planes, about a
minute and a half, and the test runner hands a file to one worker.
"""

import numpy as np
import jax.numpy as jnp
import torch

from stereo_to_multiview_tpu.ops import costkern as jck

from stereo_to_multiview_tpu_torch.ops import costkern as tck

torch.set_num_threads(1)


def test_shift_extract_d128_matches_jax_and_the_direct_path():
    """u8 against JAX exactly; u8 and float32 against the port's direct
    path in every element of both eyes."""
    h, w, nd, zd = 8, 385, 128, 64
    rng = np.random.default_rng(55)
    left = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    assert tck.shift_extract_applies(w, nd, zd)
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    for quant in (True, False):
        got = tck.ci_adcensus_kern(l, r, 10.0, 30.0, nd, zd, quant=quant,
                                   shift_extract=True)
        direct = tck.ci_adcensus_kern(l, r, 10.0, 30.0, nd, zd, quant=quant)
        assert all(torch.equal(a, b) for a, b in zip(got, direct))
        if quant:
            u8 = got
    ref = jck.ci_adcensus_kern(jnp.asarray(left), jnp.asarray(right), 10.0,
                               30.0, nd, zd, quant=True, interpret=True,
                               shift_extract=True)
    for g, rf in zip(u8, ref):
        np.testing.assert_array_equal(g.numpy().astype(np.float32),
                                      np.asarray(rf).astype(np.float32))
