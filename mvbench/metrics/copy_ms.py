"""copy_ms: device milliseconds a frame of host-to-device and
device-to-host copies (the trace's memcpy activity), the stream's
uploads and readbacks and the program's host reads."""

UNIT = "ms"
MOVES = "fps"


def read(st, log):
    if not st.events:
        return None
    us = st.device_us(lambda e: e.cat == "gpu_memcpy"
                      and ("HtoD" in e.name or "DtoH" in e.name))
    return us * 1e-3 / st.frames
