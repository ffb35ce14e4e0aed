"""stage_ms.stereo_core: device milliseconds a frame of the kernels, copies and
memsets launched inside the program's `stereo_core` stage (its
record_function range)."""

UNIT = "ms"
MOVES = "fps"
STAGE = "stereo_core"


def read(st, log):
    if not st.events:
        return None
    us = st.device_us(lambda e: e.stage == STAGE)
    return us * 1e-3 / st.frames if us > 0 else None
