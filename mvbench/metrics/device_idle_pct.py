"""device_idle_pct: the share of the traced stretch in which no kernel,
copy or memset runs on the device (the complement of the union of the
device's intervals)."""

UNIT = "%"
MOVES = "fps"


def read(st, log):
    if not st.events or st.window_us <= 0:
        return None
    return 100.0 * (1.0 - st.busy_us() / st.window_us)
