"""Winner-takes-all disparity of the XLA engine's (D, H, W) volume."""

from __future__ import annotations

import torch


def dc_wta(cost: torch.Tensor, zero_disp: int) -> torch.Tensor:
    """disp = argmin_d cost[d] - zero_disp, float32; the first minimum
    wins, as `jnp.argmin` and the reference's strict scan."""
    return (torch.argmin(cost, dim=0) - zero_disp).to(torch.float32)
