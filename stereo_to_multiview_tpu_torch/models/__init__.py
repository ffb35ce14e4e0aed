from stereo_to_multiview_tpu_torch.models.pipeline import (
    process_frame, process_frame_lowres, compute_disparities,
    synthesize_views, make_process_frame)

__all__ = [
    "process_frame", "process_frame_lowres", "compute_disparities",
    "synthesize_views", "make_process_frame",
]
