"""The JAX package's entry name of its fused IRV round
(stereo_to_multiview_tpu/ops/irvkern.py `irv_round_kern`), as a thin
wrapper over the port's round: kernels B8 and B9 (`ops.irv.irv_round`).
`interpret` is accepted for the JAX signature and has no effect: the
tensor's device chooses the plain version or the kernels."""

from __future__ import annotations

import torch

from stereo_to_multiview_tpu_torch.ops.irv import irv_round

USD_MAX = 64        # the JAX kernel's bound (256-wide windows)


def irv_round_kern(disp: torch.Tensor, outliers: torch.Tensor,
                   arms: torch.Tensor, thresh_s: int, thresh_h: float,
                   num_disp: int, zero_disp: int, usd: int,
                   interpret: bool = False, need: torch.Tensor = None):
    """One synchronous IRV voting round: (disp, outliers) after it, equal
    to `ops.irv.dr_irv` with one iteration.  `need` (bool (H, W)): only
    the outliers there vote; every other pixel keeps its state."""
    if usd > USD_MAX:
        raise ValueError("usd must be <= 64 (256-wide kernel windows)")
    return irv_round(disp, outliers, arms, thresh_s, thresh_h, num_disp,
                     zero_disp, usd, need)
