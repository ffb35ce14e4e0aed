"""hslo_roofline: the scanline route's work from the pass-3 volume to the
two disparity maps, against its bound.

The work, whatever kernels implement it, is each eye's pass-4 window sum,
the two-direction scanline DP and the first-min WTA.  Its bound is the
least time the card could take for it: each eye's int32 (H, W, D) pass-3
volume, its two horizontal arms (int32) and the two grey images (u8)
read once and its disparity map (float32) written once at 3.35 TB/s, or
its operations at 67 T/s, whichever is larger (`core_roofline`'s peaks).
The time is the device time of the launches in the program's `dc_hslo`
span (B13) and of the pass-4 sums in `stereo_core` (B6's sum-only entry,
picked out by kernel name as `core_roofline` picks out its kernels); a
frame is counted by its B13 launches, and pass-4 sums launched after the
stretch's last B13 launch, whose frame the stretch cut, are left out.
Where the program opens no `dc_hslo` span this reads nothing.
"""

import re

from mvbench.harness.cells import load_metric

UNIT = "%"
MOVES = "fps"
SPAN = "dc_hslo"
CORE = "stereo_core"
B13 = re.compile(r"hslo_kernel")
# B6's sum-only pass 4: the int32 input, the WTA flag clear (demangled or
# mangled)
PASS4_SUM = re.compile(r"hpass_kernel(<int, false|IiLb0E)")
# operations a (pixel, disparity) of an eye: the pass-4 window sum's
# prefix add and two-end difference (3, as `core_roofline` counts B6);
# a DP step of each direction (the row minimum, mn + p2, the neighbours'
# minimum, + p1, two minima, + C, - mn: 8, twice); the average (2); the
# WTA's compare (1)
OPS_PER_ELEMENT = 3 + 2 * 8 + 2 + 1

core = load_metric("core_roofline")


def eye_bytes(rows: int, w: int, nd: int) -> int:
    """Bytes one eye's work reads and writes once: the int32 pass-3
    volume, two int32 arms, two u8 grey images, the float32 disparity."""
    return rows * w * (4 * nd + 2 * 4 + 2 + 4)


def eye_ops(rows: int, w: int, nd: int) -> int:
    return OPS_PER_ELEMENT * rows * w * nd


def frame_bound_ms(cfg: dict) -> float:
    """Bound ms of one frame's two eyes."""
    h, w, nd = cfg["num_rows"], cfg["num_cols"], cfg["num_disp"]
    return core.bound_ms(2 * eye_bytes(h, w, nd), 2 * eye_ops(h, w, nd))


def b13_frames(st) -> float:
    """Frames whose B13 launches the stretch holds: one launch a frame and
    row chunk of the stereo core (0 where the stretch holds none)."""
    launches = sum(1 for e in st.events
                   if e.stage == SPAN and B13.search(e.name))
    if not launches:
        return 0
    cfg = st.config
    h = cfg["num_rows"]
    return launches / len(core.chunk_rows(h, cfg["band_row_chunk"] or h,
                                          2 * cfg["usd"]))


def read(st, log):
    frames = b13_frames(st)
    if not frames:
        return None
    hslo = [e for e in st.events if e.stage == SPAN]
    cfg = st.config
    last = max(e.start_us + e.dur_us for e in hslo)
    pass4 = [e for e in st.events if e.stage == CORE
             and PASS4_SUM.search(e.name) and e.start_us < last]
    total_us = sum(e.dur_us for e in hslo + pass4)
    if total_us <= 0:
        return None
    log.append(f"hslo_roofline: {frames:g} frames of B13 launches, "
               f"{len(pass4)} pass-4 sums; bound "
               f"{frame_bound_ms(cfg):.6f} ms a frame")
    return 100.0 * frame_bound_ms(cfg) * 1e3 * frames / total_us
