"""stage_ms.dc_hslo: device milliseconds a frame of the kernels, copies and
memsets launched inside the program's `dc_hslo` span (its record_function
range around the scanline optimisation, B13, nested in `stereo_core`).

A frame is counted by its B13 launches, as `hslo_roofline` counts it, so
a frame whose launch falls outside the traced stretch is left out of both
the time and the count."""

from mvbench.harness.cells import load_metric

UNIT = "ms"
MOVES = "fps"
STAGE = "dc_hslo"

roof = load_metric("hslo_roofline")


def read(st, log):
    frames = roof.b13_frames(st)
    if not frames:
        return None
    us = st.device_us(lambda e: e.stage == STAGE)
    return us * 1e-3 / frames if us > 0 else None
