"""idle_ms.dr_irv: device-idle milliseconds a frame inside the program's
`dr_irv` stage: the device waiting while the host reads a round's change
flag and launches the next round (`ops/irv.dr_irv_early_stop`), read from
the program's spans (`harness/spans.py`)."""

from mvbench.harness import spans

UNIT = "ms"
MOVES = "fps"


def read(st, log):
    us = spans.idle_us(st, lambda name: name == "dr_irv")
    return None if us is None else us * 1e-3 / st.frames
