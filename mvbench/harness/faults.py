"""Faults planted in the program under test, to show that the check
catches them: each a context manager that replaces one function of the
port's pipeline module while it is open.

- `irv_unchanged`: the voting stage returns its state unchanged;
- `half_rows`: the stereo core leaves the lower half of the rows out;
- `one_disparity`: one final disparity altered where it is produced;
- `one_subpixel`: one subpixel of the interlaced frame altered.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(name: str, wrap):
    from stereo_to_multiview_tpu_torch.models import pipeline
    orig = getattr(pipeline, name)
    setattr(pipeline, name, wrap(orig))
    try:
        yield
    finally:
        setattr(pipeline, name, orig)


def irv_unchanged():
    return _patched("dr_irv_early_stop",
                    lambda orig: lambda disp, outliers, *a, **kw:
                    (disp, outliers))


def half_rows():
    def wrap(orig):
        def core(*args, **kw):
            dl, dr = orig(*args, **kw)
            h = dl.shape[0]
            dl, dr = dl.clone(), dr.clone()
            dl[h // 2:] = 0
            dr[h // 2:] = 0
            return dl, dr
        return core
    return _patched("band_stereo_core_chunked", wrap)


def one_disparity():
    def wrap(orig):
        def disparities(*args, **kw):
            dl, dr, ol, orr = orig(*args, **kw)
            dl = dl.clone()
            dl[dl.shape[0] // 2, dl.shape[1] // 2] += 1.0
            return dl, dr, ol, orr
        return disparities
    return _patched("compute_disparities", wrap)


def one_subpixel():
    def wrap(orig):
        def synth(*args, **kw):
            out = orig(*args, **kw).clone()
            out[out.shape[0] // 2, out.shape[1] // 2, 1] ^= 1
            return out
        return synth
    return _patched("synthesize_interlace", wrap)


FAULTS = {"irv_unchanged": irv_unchanged, "half_rows": half_rows,
          "one_disparity": one_disparity, "one_subpixel": one_subpixel}
