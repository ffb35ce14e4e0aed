from stereo_to_multiview_tpu_torch.parallel.mesh import (
    make_mesh, shard_rows, gather_rows)
from stereo_to_multiview_tpu_torch.parallel.sharded import (
    sharded_process_frame, sharded_compute_disparities)
from stereo_to_multiview_tpu_torch.parallel.halo import (
    halo_exchange, halo_process_frame)
from stereo_to_multiview_tpu_torch.parallel.dispshard import (
    disp_sharded_disparities, disp_sharded_process_frame)
from stereo_to_multiview_tpu_torch.parallel import distributed

__all__ = [
    "make_mesh", "shard_rows", "gather_rows",
    "sharded_process_frame", "sharded_compute_disparities",
    "halo_exchange", "halo_process_frame",
    "disp_sharded_disparities", "disp_sharded_process_frame",
    "distributed",
]
