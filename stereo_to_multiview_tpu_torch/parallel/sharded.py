"""Row-sharded whole frames on the XLA engine (strategy A).

The JAX package's strategy A hands its XLA engine to the pjit
partitioner: the SBS input and the outputs are annotated as row-sharded
and XLA inserts the collectives of every cross-row dependency.  PyTorch
has no partitioner, so here strategy A runs the port's XLA engine
row-sharded with the explicit halos of parallel.halo: the collectives
XLA would insert, written out.  Unlike parallel.halo it runs the median
where the config asks for it (a 3x3 stencil: a halo of one row), since
the partitioned JAX graph is the whole `process_frame`.  It equals the
port's unsharded XLA engine wherever the JAX strategy equals its own:
bit for bit at xla_agg_qscale > 0.  It takes the geometry parallel.halo
takes (num_rows divisible by the row axis, shards at least as tall as
the largest halo).
"""

from __future__ import annotations

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.parallel.halo import (
    row_sharded_disparities, row_sharded_frame)
from stereo_to_multiview_tpu_torch.parallel.mesh import Mesh


def sharded_process_frame(mesh: Mesh, cfg: PipelineConfig,
                          row_axis: str = "row", device=None):
    """A function of this rank's SBS rows -> its (disp_l, disp_r,
    interlaced) rows, the XLA engine row-sharded over `row_axis`."""
    cfg = cfg.replace(engine="xla")
    return row_sharded_frame(mesh, cfg, row_axis, None, device,
                             median=cfg.use_median)


def sharded_compute_disparities(mesh: Mesh, cfg: PipelineConfig,
                                row_axis: str = "row", device=None):
    """The stereo-matching half: this rank's (img_l, img_r) rows -> their
    (disp_l, disp_r, out_l, out_r), disparities float32 and outlier
    labels u8, the XLA engine row-sharded over `row_axis`."""
    cfg = cfg.replace(engine="xla")
    return row_sharded_disparities(mesh, cfg, row_axis, device,
                                   median=cfg.use_median)
