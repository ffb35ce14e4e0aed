"""tx_scale_roofline: the low-resolution route's two rescales (G2)
against their bound.

The work is each eye's (H, W, C) u8 image scaled bilinearly to the
disparity size (num_rows_disp, num_cols_disp), and each eye's float32
disparity scaled back to (H, W) and multiplied by 1 / disp_scale.  Its
bound is the least time the card could take for it: each input byte read
once and each output byte written once at 3.35 TB/s (`core_roofline`'s
peak; a few float32 operations a byte, far below the operation bound).
The time is the device time of the two kernels, found by name; each
launch counts its own direction's bound, so a frame is counted by its
launches.  Where the program launches neither kernel this reads nothing.
"""

import re

from mvbench.harness.cells import load_metric

UNIT = "%"
MOVES = "fps"
CHANNELS = 3
DOWN = re.compile(r"tx_scale_bilinear_kernel")
UP = re.compile(r"tx_disp_scale_kernel")

core = load_metric("core_roofline")


def down_bytes(cfg: dict) -> int:
    """Both eyes' u8 images read at (H, W) and written at the disparity
    size."""
    full = cfg["num_rows"] * cfg["num_cols"]
    low = cfg["num_rows_disp"] * cfg["num_cols_disp"]
    return 2 * CHANNELS * (full + low)


def up_bytes(cfg: dict) -> int:
    """Both eyes' float32 disparities read at the disparity size and
    written at (H, W)."""
    full = cfg["num_rows"] * cfg["num_cols"]
    low = cfg["num_rows_disp"] * cfg["num_cols_disp"]
    return 2 * 4 * (low + full)


def frame_bytes(cfg: dict) -> int:
    return down_bytes(cfg) + up_bytes(cfg)


def frame_bound_ms(cfg: dict) -> float:
    return core.bound_ms(frame_bytes(cfg), 0)


def read(st, log):
    down = [e for e in st.events if DOWN.search(e.name)]
    up = [e for e in st.events if UP.search(e.name)]
    total_us = sum(e.dur_us for e in down + up)
    if total_us <= 0:
        return None
    cfg = st.config
    bound_us = 1e3 * (len(down) * core.bound_ms(down_bytes(cfg), 0)
                      + len(up) * core.bound_ms(up_bytes(cfg), 0))
    log.append(f"tx_scale_roofline: {len(down)} downscale and {len(up)} "
               f"upscale launches; bound {frame_bound_ms(cfg):.6f} ms a "
               f"frame")
    return 100.0 * bound_us / total_us
