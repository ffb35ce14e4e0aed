"""stage_ms.dr_irv: device milliseconds a frame of the kernels, copies and
memsets launched inside the program's `dr_irv` stage (its
record_function range)."""

UNIT = "ms"
MOVES = "fps"
STAGE = "dr_irv"


def read(st, log):
    if not st.events:
        return None
    us = st.device_us(lambda e: e.stage == STAGE)
    return us * 1e-3 / st.frames if us > 0 else None
