"""B1's halo-shard mode (`cross_arms(_lr)(..., row_offset=, global_h=)`)
against the JAX package's two answers on the CPU, at the top, a middle
and the bottom shard of a frame cut into four row shards, each extended
by the halo path's image halo of 3 * usd rows (edge rows replicated
outside the frame, as `halo_exchange(edge="clamp")` fills them).

- JAX `ops.cross_arms(row_offset=, global_h=)` (XLA, the golden's
  clamp): equal on every row.
- JAX `cross_arms_kern_lr(..., row_offset=, global_h=, interpret=True)`
  (Pallas): equal on every row of the frame whose vertical walk stays
  inside the tensor.  Elsewhere the JAX package has two answers: the
  Pallas kernel pads the planes with zero rows above the tensor and
  bounds a walk by clip(global border distance, 0, usd), counting steps
  that lie outside the frame, where the XLA op reads the tensor's edge
  row and counts only the steps inside the frame.  The port follows the
  XLA op; those rows lie in the halo, which the halo path crops away.

Integer thresholds throughout: the Pallas kernel compares with bf16(t).
Exact, no tolerance.  On the CPU the wrapper takes its plain version,
which chip_smoke.py holds bit-equal to the CUDA kernel on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereo_to_multiview_tpu import ops as jops
from stereo_to_multiview_tpu.ops.postkern import cross_arms_kern_lr

from stereo_to_multiview_tpu_torch.ops import cross as tcross

torch.set_num_threads(1)

GH, W, N_SHARDS = 96, 64, 4
ARMS = (6.0, 20.0, 7, 3)            # ucd, lcd, usd, lsd


def _frame(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (GH + 4, W + 8, 3)).astype(np.float32)
    sm = sum(base[i:i + GH, j:j + W + 4] for i in range(3) for j in range(3))
    img = (sm / 9).astype(np.uint8)
    return img[:, :W].copy(), img[:, 4:].copy()


def _extended(img, shard, usd):
    """The shard's rows with the image halo, clamped at the frame's
    borders, and its row offset."""
    rows_loc, halo = GH // N_SHARDS, 3 * usd
    row0 = shard * rows_loc - halo
    idx = np.clip(np.arange(row0, row0 + rows_loc + 2 * halo), 0, GH - 1)
    return img[idx], row0


def _inside_rows(h, row0, usd):
    """Rows of the frame whose vertical walks stay inside the tensor."""
    y = np.arange(h)
    g = y + row0
    inside = (g >= 0) & (g <= GH - 1)
    up = np.minimum(usd, np.maximum(g, 0))
    dn = np.minimum(usd, np.maximum(GH - 1 - g, 0))
    return inside & (y - up >= 0) & (y + dn <= h - 1)


@pytest.fixture(scope="module")
def shards():
    img_l, img_r = _frame(5)
    usd = ARMS[2]
    out = {}
    for name, shard in (("top", 0), ("middle", 1), ("bottom", N_SHARDS - 1)):
        ext_l, row0 = _extended(img_l, shard, usd)
        ext_r, _ = _extended(img_r, shard, usd)
        port = tcross.cross_arms_lr(torch.from_numpy(ext_l),
                                    torch.from_numpy(ext_r), *ARMS,
                                    row_offset=row0, global_h=GH)
        xla = [np.asarray(jops.cross_arms(jnp.asarray(e), *ARMS,
                                          row_offset=row0, global_h=GH))
               for e in (ext_l, ext_r)]
        pallas = [np.asarray(a) for a in cross_arms_kern_lr(
            jnp.asarray(ext_l), jnp.asarray(ext_r), *ARMS,
            row_offset=row0, global_h=GH, interpret=True)]
        out[name] = (row0, [p.numpy() for p in port], xla, pallas)
    return out


@pytest.mark.parametrize("shard", ["top", "middle", "bottom"])
def test_halo_arms_match_xla_every_row(shards, shard):
    """The port equals JAX `ops.cross_arms(row_offset=, global_h=)` on
    every row of the extended shard, halo rows included, both eyes."""
    _, port, xla, _ = shards[shard]
    for eye in range(2):
        np.testing.assert_array_equal(port[eye], xla[eye])


@pytest.mark.parametrize("shard", ["top", "middle", "bottom"])
def test_halo_arms_match_pallas_inside(shards, shard):
    """The port equals JAX `cross_arms_kern_lr(..., interpret=True)` on
    every row of the frame whose vertical walk stays in the tensor, and
    the horizontal arms on every row."""
    row0, port, _, pallas = shards[shard]
    rows = _inside_rows(port[0].shape[1], row0, ARMS[2])
    assert rows.sum() >= GH // N_SHARDS
    for eye in range(2):
        np.testing.assert_array_equal(port[eye][:, rows],
                                      pallas[eye][:, rows])
        np.testing.assert_array_equal(port[eye][2:], pallas[eye][2:])


def test_halo_arms_pallas_edge_rows_differ(shards):
    """The pinned difference: outside those rows the JAX package's two
    answers part.  In the middle shard's first row the Pallas kernel
    compares the walk UP with zero rows above the tensor (a failure at
    k = 1), where the XLA op and the port read the edge row again (no
    failure against itself); in the top shard's rows above the frame the
    Pallas kernel counts DOWN steps outside the frame, the port does not.
    The rows that part are all in the halo the halo path crops."""
    usd, halo = ARMS[2], 3 * ARMS[2]
    for name, (row0, port, xla, pallas) in shards.items():
        rows = _inside_rows(port[0].shape[1], row0, usd)
        differ = np.zeros_like(rows)
        for eye in range(2):
            differ |= (port[eye][:2] != pallas[eye][:2]).any(axis=(0, 2))
        kept = np.zeros_like(rows)
        kept[halo:halo + GH // N_SHARDS] = True
        assert not (differ & kept).any(), name
        assert not (differ & rows).any(), name
    row0, port, _, pallas = shards["middle"]
    assert (pallas[0][0, 0] == 1).all()
    assert (port[0][0, 0] > 1).any()
    row0, port, _, pallas = shards["top"]
    above = np.arange(port[0].shape[1]) + row0 < 0
    assert (port[0][1, above] < pallas[0][1, above]).any()


def test_halo_arms_without_offset_unchanged():
    """Without an offset the arms stop at the tensor's own border, as
    before; row_offset=0 with global_h=H is the same walk."""
    img_l, _ = _frame(5)
    t = torch.from_numpy(img_l)
    plain = tcross.cross_arms(t, *ARMS)
    np.testing.assert_array_equal(
        plain.numpy(), tcross.cross_arms(t, *ARMS, row_offset=0,
                                         global_h=GH).numpy())
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jops.cross_arms(jnp.asarray(img_l),
                                                  *ARMS)))
    with pytest.raises(ValueError):
        tcross.cross_arms(t, *ARMS, row_offset=3)
