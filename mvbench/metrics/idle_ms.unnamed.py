"""idle_ms.unnamed: device-idle milliseconds a frame inside no span of
the program on the stream loop's thread: the idle time its spans cannot
name yet.  Read where the program has the stream's spans
(`harness/spans.py`); the run's log gives the idle time under each
top-level span beside it, which adds up to the stretch's idle time."""

from mvbench.harness import spans

UNIT = "ms"
MOVES = "fps"


def read(st, log):
    by = spans.idle_by_top_level(st)
    if by is None or not any(n.startswith("stream.") for n in by):
        return None
    log.append("device idle, ms a frame, by top-level span: " + ", ".join(
        f"{n} {us * 1e-3 / st.frames:.6f}" for n, us in by.items()))
    return by["unnamed"] * 1e-3 / st.frames
