"""Cross-based adaptive support: arm lengths, kernel B1 and its plain
PyTorch version.

Arm order: UP, DOWN, LEFT, RIGHT.  The aggregation over the arms is the
band engine's (ops.band).  The wrapper takes the plain version only for
a CPU tensor; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.cost import clamp_index
from stereo_to_multiview_tpu_torch.ops.mux import f32

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3


def _arm_length(img_i32: torch.Tensor, dy: int, dx: int, ucd: float,
                lcd: float, usd: int, lsd: int) -> torch.Tensor:
    """Arm length (H, W) int32 in direction (dy, dx).

    The arm is written *before* the color test, so a color failure at
    distance k yields arm k while running off the image at distance k
    yields k-1:  arm = sum_k [in_bounds(k) and no color failure at j < k].
    Within lsd a step fails when it differs by more than lcd from the
    anchor or from the previous pixel; beyond lsd, by more than ucd from
    the anchor (max over channels, compared in float32)."""
    h, w = img_i32.shape[:2]
    dev = img_i32.device
    axis = 0 if dy else 1
    step = dy if dy else dx
    n = h if dy else w
    pos = torch.arange(n, device=dev)
    t_lcd, t_ucd = f32(lcd), f32(ucd)

    arm = torch.zeros((h, w), dtype=torch.int32, device=dev)
    no_fail_before = torch.ones((h, w), dtype=torch.bool, device=dev)
    prev = img_i32
    for k in range(1, usd + 1):
        idx = clamp_index(n, step * k, n + step * k, dev)
        cur = img_i32.index_select(axis, idx)
        ac = (cur - img_i32).abs().amax(dim=-1).to(torch.float32)
        cp = (cur - prev).abs().amax(dim=-1).to(torch.float32)
        if k <= lsd:
            fail = (ac > t_lcd) | (cp > t_lcd)
        else:
            fail = ac > t_ucd
        in_b = (pos + step * k >= 0) & (pos + step * k <= n - 1)
        in_b = in_b[:, None] if dy else in_b[None, :]
        arm += (in_b & no_fail_before).to(torch.int32)
        no_fail_before &= ~fail
        prev = cur
    return arm


def cross_arms_plain(img: torch.Tensor, ucd: float, lcd: float, usd: int,
                     lsd: int) -> torch.Tensor:
    """Plain version of `cross_arms`: one shifted image per step k."""
    c = img.to(torch.int32)
    return torch.stack([
        _arm_length(c, -1, 0, ucd, lcd, usd, lsd),
        _arm_length(c, +1, 0, ucd, lcd, usd, lsd),
        _arm_length(c, 0, -1, ucd, lcd, usd, lsd),
        _arm_length(c, 0, +1, ucd, lcd, usd, lsd),
    ])


@kernels.kernel_wrapper
def cross_arms(img: torch.Tensor, ucd: float, lcd: float, usd: int,
               lsd: int) -> torch.Tensor:
    """(4, H, W) int32 arm lengths (UP, DOWN, LEFT, RIGHT) of an (H, W, 3)
    uint8 image.  Every arm stops at the image border.  Kernel B1
    (csrc/arms.cu)."""
    if kernels.on_cpu(img):
        return cross_arms_plain(img, ucd, lcd, usd, lsd)
    kernels.require(img, "img", torch.uint8, 3, img.device)
    h, w, ch = img.shape
    if ch != 3:
        raise ValueError(f"cross_arms: expected (H, W, 3), got "
                         f"{tuple(img.shape)}")
    out = torch.empty((4, h, w), dtype=torch.int32, device=img.device)
    rc = kernels.lib("arms").stm_cross_arms(
        img.data_ptr(), out.data_ptr(), h, w, float(f32(ucd)),
        float(f32(lcd)), usd, lsd, kernels.stream_of(out))
    kernels.check_launch(rc, "cross_arms")
    cross_arms.launches += 1
    return out
