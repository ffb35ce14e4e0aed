"""irv_rounds: voting rounds a frame and eye, from the program's launch
counter of the vote kernel (`irv_vote`, one launch a round, eye and IRV
row chunk) over the traced stretch."""

UNIT = "rounds"
MOVES = "frame_ms_p95"


def irv_chunks(rows: int, chunk: int) -> int:
    """Row chunks of one IRV round (0: the whole frame)."""
    return len(range(0, rows, chunk or rows))


def read(st, log):
    launches = st.counters.get("irv_vote") if st.counters else None
    if not launches:
        return None
    cfg = st.config
    return launches / st.frames / (2 * irv_chunks(cfg["num_rows"],
                                                  cfg["irv_row_chunk"]))
