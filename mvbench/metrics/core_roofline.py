"""core_roofline: the stereo core's kernels against their bounds.

The sum of the bound milliseconds over the sum of device milliseconds of
every kernel, copy and memset launched in the `stereo_core` stage.  A
launch's bound is the least time the card could take for it: every input
byte read once and every output byte written once at 3.35 TB/s, or its
operations at 67 T/s, whichever is larger (the published peaks of one
H100 SXM at its 700 W limit; the run reports the card's limit beside).
The bounds are computed from the configuration's shapes for B2 (the
pair's cost volume), B3 (the right eye's shear), B4 (pass 1), B5 (passes
2 and 3) and B6 (pass 4 and the WTA), per row chunk; a launch of such a
kernel counts its kind's mean bound over the frame's chunks.  Work in the
stage that has no bound here counts in the denominator only and is named
on the run's standard error.
"""

import math
import re

UNIT = "%"
MOVES = "fps"
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
STAGE = "stereo_core"
AD_VALUES, HAM_VALUES = 766, 49


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S) * 1e3


def chunk_rows(h: int, chunk: int, halo: int):
    """[(start, rows)] of the stereo core's row chunks: `chunk` output
    rows and `halo` rows each side, rounded up to 8, inside the frame."""
    ext = min(h, -(-(chunk + 2 * halo) // 8) * 8)
    return [(min(max(0, c0 - halo), h - ext), ext)
            for c0 in range(0, h, chunk)]


def launch_bounds(start: int, rows: int, h: int, w: int, nd: int, zd: int,
                  esize: int = 1) -> dict:
    """Bound ms of each kernel of one chunk of `rows` frame rows from
    `start`: {kind: ms}, per launch (B4-B6 run once an eye)."""
    margin = max(zd, nd - zd)
    read = min(h, start + rows + 3) - max(0, start - 3)  # the census' rows
    pair = rows * (w + 2 * margin) * nd
    vol = rows * w * nd
    hw = rows * w
    return {
        "B2": bound_ms(2 * read * w * 3 + (AD_VALUES + HAM_VALUES) * 4
                       + pair * esize, 10 * pair + 2 * 48 * hw),
        "B3": bound_ms((pair + vol) * esize, 0),
        "B4": bound_ms(vol * esize + 2 * hw * 4 + vol * 4, 3 * vol),
        "B5": bound_ms(vol * 4 + 2 * hw * 4 + vol * 4, 2 * 4 * vol),
        "B6": bound_ms(vol * 4 + 2 * hw * 4 + hw * 4, 3 * vol),
    }


def mean_bounds(cfg: dict) -> dict:
    """{kind: mean bound ms a launch} over the frame's chunks."""
    h, w = cfg["num_rows"], cfg["num_cols"]
    esize = 1 if round(2.0 * cfg["band_qscale"]) <= 255 else 2
    parts = [launch_bounds(s, r, h, w, cfg["num_disp"], cfg["zero_disp"],
                           esize)
             for s, r in chunk_rows(h, cfg["band_row_chunk"] or h,
                                    2 * cfg["usd"])]
    return {k: sum(p[k] for p in parts) / len(parts) for k in parts[0]}


_KINDS = (
    ("B2", re.compile(r"cost_pair_kernel")),
    ("B3", re.compile(r"shear_(stream|scalar)_kernel")),
    ("B5", re.compile(r"vpass_kernel")),
    # pass 4 + WTA: the template's WTA flag set (demangled or mangled)
    ("B6", re.compile(r"hpass_kernel(<[^,]+, true|I[a-z]Lb1E)")),
    ("B4", re.compile(r"hpass_kernel(<[^,]+, false|I[a-z]Lb0E)")),
)


def kind(name: str):
    for k, pat in _KINDS:
        if pat.search(name):
            return k
    return None


def read(st, log):
    evs = [e for e in st.events if e.stage == STAGE]
    if not evs:
        return None
    cfg = st.config
    if cfg.get("use_hslo"):
        return None                      # B13's route has no bounds here
    bounds = mean_bounds(cfg)
    total_us = sum(e.dur_us for e in evs)
    bound_us, other = 0.0, {}
    for e in evs:
        k = kind(e.name)
        if k is None:
            other[e.name[:120]] = other.get(e.name[:120], 0.0) + e.dur_us
        else:
            bound_us += bounds[k] * 1e3
    for name, us in sorted(other.items(), key=lambda kv: -kv[1]):
        log.append(f"core_roofline: no bound for {name} "
                   f"({us * 1e-3 / st.frames:.6f} ms a frame)")
    if total_us <= 0 or math.isclose(bound_us, 0.0):
        return None
    return 100.0 * bound_us / total_us
