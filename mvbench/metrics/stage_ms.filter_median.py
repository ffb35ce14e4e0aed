"""stage_ms.filter_median: device milliseconds a frame of the kernels,
copies and memsets launched inside the program's `filter_median` stage
(its record_function range: the 3x3 median of both eyes' disparities)."""

UNIT = "ms"
MOVES = "fps"
STAGE = "filter_median"


def read(st, log):
    if not st.events:
        return None
    us = st.device_us(lambda e: e.stage == STAGE)
    return us * 1e-3 / st.frames if us > 0 else None
