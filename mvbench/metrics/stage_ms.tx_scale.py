"""stage_ms.tx_scale: device milliseconds a frame of the kernels, copies
and memsets launched inside the program's `tx_scale` stage (its
record_function ranges around the low-resolution route's two rescales:
both eyes scaled down, both disparities scaled up).  Where the program
opens no such range (a route without the rescales) this reads nothing."""

UNIT = "ms"
MOVES = "fps"
STAGE = "tx_scale"


def read(st, log):
    if not st.events:
        return None
    us = st.device_us(lambda e: e.stage == STAGE)
    return us * 1e-3 / st.frames if us > 0 else None
