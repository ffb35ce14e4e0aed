"""Cross-based adaptive support: arm lengths, kernel B1 and its plain
PyTorch version.

Arm order: UP, DOWN, LEFT, RIGHT.  The aggregation over the arms is the
band engine's (ops.band).  `cross_arms` (one eye) and `cross_arms_lr`
(both eyes, one launch) go through the one wrapper `cross_arms_eyes`,
which takes the plain version only for a CPU tensor; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from stereo_to_multiview_tpu_torch import kernels
from stereo_to_multiview_tpu_torch.ops.cost import clamp_index
from stereo_to_multiview_tpu_torch.ops.mux import f32

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3


def _arm_length(img_i32: torch.Tensor, dy: int, dx: int, ucd: float,
                lcd: float, usd: int, lsd: int, row_offset: int | None = None,
                global_h: int | None = None) -> torch.Tensor:
    """Arm length (H, W) int32 in direction (dy, dx).

    The arm is written *before* the color test, so a color failure at
    distance k yields arm k while running off the image at distance k
    yields k-1:  arm = sum_k [in_bounds(k) and no color failure at j < k].
    Within lsd a step fails when it differs by more than lcd from the
    anchor or from the previous pixel; beyond lsd, by more than ucd from
    the anchor (max over channels, compared in float32).

    row_offset/global_h: the image is a halo-extended row shard of a
    frame of global_h rows whose row y is the frame's row y + row_offset;
    the vertical in-bounds test then uses that global row, while the
    reads stay clamped to the tensor's rows."""
    h, w = img_i32.shape[:2]
    dev = img_i32.device
    axis = 0 if dy else 1
    step = dy if dy else dx
    n = h if dy else w
    pos = torch.arange(n, device=dev)
    g_pos, g_n = pos, n
    if dy and row_offset is not None:
        g_pos, g_n = pos + int(row_offset), int(global_h)
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
        in_b = (g_pos + step * k >= 0) & (g_pos + step * k <= g_n - 1)
        in_b = in_b[:, None] if dy else in_b[None, :]
        arm += (in_b & no_fail_before).to(torch.int32)
        no_fail_before &= ~fail
        prev = cur
    return arm


def cross_arms_plain(img: torch.Tensor, ucd: float, lcd: float, usd: int,
                     lsd: int, row_offset: int | None = None,
                     global_h: int | None = None) -> torch.Tensor:
    """Plain version of `cross_arms`: one shifted image per step k."""
    c = img.to(torch.int32)
    return torch.stack([
        _arm_length(c, -1, 0, ucd, lcd, usd, lsd, row_offset, global_h),
        _arm_length(c, +1, 0, ucd, lcd, usd, lsd, row_offset, global_h),
        _arm_length(c, 0, -1, ucd, lcd, usd, lsd),
        _arm_length(c, 0, +1, ucd, lcd, usd, lsd),
    ])


def arm_threshold(t: float) -> int:
    """The integer c with (a > float32(t)) == (a >= c) for every integer
    a in 0..255: floor(t) + 1 clamped to [0, 256] (256 for NaN: no step
    fails; 0 below zero: every step fails).  Exact, with no rounding of
    t, as the reference's float32 compare (d_ca_cross.cu:41-69).  The
    JAX Pallas kernel compares with bf16(t) instead (postkern.py:138,
    144), which moves a threshold such as 5.99 up to 6."""
    t = float(f32(t))
    if math.isnan(t) or t >= 255.0:
        return 256
    return 0 if t < 0.0 else math.floor(t) + 1


@kernels.kernel_wrapper
def cross_arms_eyes(imgs, ucd: float, lcd: float, usd: int, lsd: int,
                    row_offset: int | None = None,
                    global_h: int | None = None) -> tuple:
    """(4, H, W) int32 arm lengths (UP, DOWN, LEFT, RIGHT) of each of one
    or two (H, W, 3) uint8 images of one shape, in one launch of kernel
    B1 (csrc/arms.cu).  Every arm stops at its image's border; with
    row_offset/global_h (the halo-shard mode) the vertical arms stop at
    the border of a frame of global_h rows, the image's row y being the
    frame's row y + row_offset, and reads past the image's rows clamp
    to its edge rows.  The kernel stages a block's cross in shared
    memory, which bounds the reach: min(usd, H - 1) (in the halo-shard
    mode up to usd) and min(usd, W - 1) up to 281 (the band engine
    takes usd <= 64); beyond it the launch fails and this raises."""
    if not 1 <= len(imgs) <= 2:
        raise ValueError("cross_arms: one or two images")
    if row_offset is not None and (global_h is None or global_h < 1):
        raise ValueError("cross_arms: row_offset needs global_h >= 1")
    if kernels.on_cpu(imgs[0]):
        return tuple(cross_arms_plain(img, ucd, lcd, usd, lsd, row_offset,
                                      global_h)
                     for img in imgs)
    for name, img in zip(("img_l", "img_r"), imgs):
        kernels.require(img, name, torch.uint8, 3, imgs[0].device)
        if img.shape != imgs[0].shape or img.shape[2] != 3:
            raise ValueError(f"cross_arms: expected (H, W, 3) images of "
                             f"one shape, got {tuple(img.shape)}")
    h, w = imgs[0].shape[:2]
    row0, g_h = (0, h) if row_offset is None else (int(row_offset),
                                                   int(global_h))
    outs = [torch.empty((4, h, w), dtype=torch.int32, device=img.device)
            for img in imgs]
    last = len(imgs) - 1
    rc = kernels.lib("arms").stm_cross_arms(
        imgs[0].data_ptr(), imgs[last].data_ptr(), outs[0].data_ptr(),
        outs[last].data_ptr(), len(imgs), h, w, arm_threshold(ucd),
        arm_threshold(lcd), usd, lsd, row0, g_h, kernels.stream_of(outs[0]))
    kernels.check_launch(rc, "cross_arms")
    cross_arms_eyes.launches += 1
    return tuple(outs)


def cross_arms(img: torch.Tensor, ucd: float, lcd: float, usd: int,
               lsd: int, row_offset: int | None = None,
               global_h: int | None = None) -> torch.Tensor:
    """(4, H, W) int32 arm lengths (UP, DOWN, LEFT, RIGHT) of an (H, W, 3)
    uint8 image.  Every arm stops at the image border, or with
    row_offset/global_h at the frame's (`cross_arms_eyes`).  Kernel B1
    (csrc/arms.cu), one eye."""
    return cross_arms_eyes((img,), ucd, lcd, usd, lsd, row_offset,
                           global_h)[0]


def cross_arms_lr(img_l: torch.Tensor, img_r: torch.Tensor, ucd: float,
                  lcd: float, usd: int, lsd: int,
                  row_offset: int | None = None,
                  global_h: int | None = None):
    """(arms_l, arms_r), each equal to `cross_arms` of its image, in one
    launch of kernel B1: the JAX package's `cross_arms_kern_lr`."""
    return cross_arms_eyes((img_l, img_r), ucd, lcd, usd, lsd, row_offset,
                           global_h)


# ---- the XLA engine's aggregation: float32 prefix windows --------------

SCAN_BLOCK = 16


def _scan_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums along dim 0 in the order of XLA's
    CPU cumsum: up to 16 values a sequential running sum; beyond, blocks
    of 16 each summed sequentially, then each block's sums plus the
    prefix (this same scan) of the totals of the blocks before it."""
    n = x.shape[0]
    nb = -(-n // SCAN_BLOCK)
    if nb > 1:
        pad = x.new_zeros((nb * SCAN_BLOCK - n, *x.shape[1:]))
        x = torch.cat([x, pad]).reshape(nb, SCAN_BLOCK, *x.shape[1:])
    else:
        x = x[None]
    inner = torch.empty_like(x)
    inner[:, 0] = x[:, 0]
    for j in range(1, x.shape[1]):
        inner[:, j] = inner[:, j - 1] + x[:, j]
    if nb > 1:
        carry = _scan_f32(inner[:nb - 1, -1])
        inner[1:] += carry[:, None]
    return inner.reshape(-1, *inner.shape[2:])[:n]


def prefix_sum_f32(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """Exclusive float32 prefix sums of a volume along `axis`, one longer
    than it (a leading 0), summed in the order of XLA's CPU cumsum
    (`_scan_f32`), the same on every device.  torch.cumsum accumulates in
    float64 on the CPU and in a tree on the card."""
    x = vol.to(torch.float32).movedim(axis, 0)
    out = torch.cat([x.new_zeros((1, *x.shape[1:])), _scan_f32(x)])
    return out.movedim(0, axis)


def _span_sum(vol: torch.Tensor, arm_neg: torch.Tensor,
              arm_pos: torch.Tensor, axis: int, max_arm: int | None):
    """Half-open span sum along `axis` (1: rows, 2: columns) of a (D, H,
    W) float32 volume: out[i] = sum vol[i - arm_neg[i] : i + arm_pos[i]],
    from the exclusive float32 prefix sums read at the two endpoints.  An
    endpoint offset outside [0, m] (m = min(max_arm, n)) reads at the
    range's low end, as the JAX package's bounded select chain does."""
    n = vol.shape[axis]
    m = n if max_arm is None else min(int(max_arm), n)
    cs = prefix_sum_f32(vol, axis)
    h, w = arm_neg.shape
    dev = vol.device
    pos = torch.arange(n, device=dev)
    pos = pos[:, None] if axis == 1 else pos[None, :]
    hi_off = torch.where((arm_pos >= 0) & (arm_pos <= m), arm_pos, 0)
    lo_off = torch.where((arm_neg >= 0) & (arm_neg <= m), -arm_neg, -m)
    hi = (pos + hi_off).clamp(0, n)
    lo = (pos + lo_off).clamp(0, n)
    if axis == 1:
        cols = torch.arange(w, device=dev)[None, :].expand(h, w)
        return cs[:, hi, cols] - cs[:, lo, cols]
    rows = torch.arange(h, device=dev)[:, None].expand(h, w)
    return cs[:, rows, hi] - cs[:, rows, lo]


def cross_aggregate(cost: torch.Tensor, arms: torch.Tensor,
                    max_arm: int | None = None) -> torch.Tensor:
    """The XLA engine's four-pass aggregation of a (D, H, W) float32
    volume in the order H, V, V, H, each pass over the previous one's
    output; `max_arm` bounds the arms (the config's usd)."""
    a = _span_sum(cost, arms[LEFT], arms[RIGHT], 2, max_arm)
    a = _span_sum(a, arms[UP], arms[DOWN], 1, max_arm)
    a = _span_sum(a, arms[UP], arms[DOWN], 1, max_arm)
    return _span_sum(a, arms[LEFT], arms[RIGHT], 2, max_arm)
