"""idle_ms.stage_in: device-idle milliseconds a frame inside the stream's
`stream.stage_in` spans, the host's copy of each frame into its pinned
slot (`models/stream._Transfers.upload`), read from the program's spans
(`harness/spans.py`)."""

from mvbench.harness import spans

UNIT = "ms"
MOVES = "fps"


def read(st, log):
    us = spans.idle_us(st, lambda name: name == "stream.stage_in")
    return None if us is None else us * 1e-3 / st.frames
