"""Build, load and launch-check the hand-written CUDA kernels.

Each source `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own
shared library with a plain C interface, loaded with ctypes.  The build
happens on first use (or through `build_kernels()`), all sources at once,
one nvcc process each, into `_build/` inside the package (listed in
.gitignore).  A library's file name carries a hash of its sources and
flags, so an edited source rebuilds and an unchanged one loads as is.

Every C entry point returns `cudaGetLastError()` after its launches; the
wrappers raise on a non-zero code.  Wrappers launch on PyTorch's current
stream, allocate their outputs with torch, and count their launches in a
plain int attribute `launches` (see `kernel_wrapper`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = ("arms", "cost", "shear", "hpass", "vpass", "hslo", "occl", "irv",
           "bilateral", "warp", "cost_dm", "band_dm", "vvdm", "span",
           "shear_dm", "feather", "scale")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# C signatures: every pointer (device or host) and the stream as void*,
# sizes as int, float parameters as float.
_SIGS = {
    "stm_cross_arms": [_P] * 4 + [_I] * 9 + [_P],
    "stm_cost_pair": [_P] * 6 + [_I] * 9 + [_P],
    "stm_shear_right": [_P, _P] + [_I] * 5 + [_P],
    "stm_hpass_sum_u8": [_P, _LL, _P, _P, _P] + [_I] * 5 + [_P],
    "stm_hpass_sum_i16": [_P, _LL, _P, _P, _P] + [_I] * 5 + [_P],
    "stm_hpass_sum_i32": [_P, _P, _P, _P] + [_I] * 5 + [_P],
    "stm_hpass_wta_i32": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "stm_hslo_wta": [_P] * 7 + [_I] * 6 + [_F, _P, _P, _P],
    "stm_hslo_scratch": [_I] * 4,
    "stm_vv_pass": [_P] * 4 + [_I] * 6 + [_P],
    "stm_vv_stages": [_I] * 3,
    "stm_dcc": [_P] * 4 + [_I, _I, _F, _I, _P],
    "stm_irv_rowspan": [_P] * 7 + [_I] * 5 + [_P],
    "stm_irv_vote": [_P] * 9 + [_I] * 6 + [_F, _P],
    "stm_irv_vote_stages": [_I] * 2,
    "stm_irv_frontier": [_P] * 3 + [_I] * 3 + [_P],
    "stm_bilateral": [_P] * 3 + [_I] * 3 + [_F, _F, _P],
    "stm_bleed_mask": [_P, _P, _I, _I, _I, _F, _P],
    "stm_occl_masks": [_P] * 6 + [_I] * 3 + [_F, _P],
    "stm_occl_masks_rmax": [_I],
    "stm_warp_merge": [_P] * 9 + [_I] * 3 + [_P],
    "stm_warp_merge_interlace": [_P] * 15 + [_I] * 6 + [_F, _P],
    "stm_feather": [_P] * 5 + [_I] * 3 + [_F, _P],
    "stm_feather_rmax": [],
    "stm_tx_scale_u8": [_P] * 4 + [_I] * 5 + [_P],
    "stm_tx_disp_scale": [_P] * 4 + [_I] * 4 + [_F, _P],
    "stm_warp_views": [_P] * 8 + [_I] * 3 + [_P],
    "stm_warp_views_bounded": [_P] * 8 + [_I] * 3 + [_P],
    "stm_cost_dm": [_P] * 6 + [_I] * 12 + [_P],
    "stm_shear_dm": [_P, _P] + [_I] * 5 + [_P],
    "stm_span_sum": [_P] * 4 + [_I] * 7 + [_P],
    "stm_pass1_dm": [_P] * 6 + [_I] * 4 + [_P],
    "stm_vv_dm": [_P] * 6 + [_I] * 6 + [_P],
    "stm_pass4_wta_dm": [_P] * 7 + [_I] * 5 + [_P],
}

_libs: dict = {}
_wrappers: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels() -> dict:
    """Compile every missing library in parallel; returns {name: nvcc
    output} for the sources built now, its first line "nvcc <s> s" (the
    seconds that source took), then the ptxas register/shared-memory
    report.  Raises if any build fails."""
    BUILD.mkdir(exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()

    def build(name, path):
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        out = f"nvcc {time.perf_counter() - t0:.1f} s\n" + proc.stdout
        if proc.returncode == 0:
            os.replace(tmp, path)
        return out, proc.returncode == 0

    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        done = {n: pool.submit(build, n, p) for n, p in todo.items()}
    logs, failed = {}, []
    for name, fut in done.items():
        logs[name], ok = fut.result()
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def lib(name: str):
    """The loaded library of csrc/<name>.cu (built on first use)."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_kernels()
        so = ctypes.CDLL(str(path))
        for fn, args in _SIGS.items():
            if hasattr(so, fn):
                f = getattr(so, fn)
                f.argtypes = args
                f.restype = ctypes.c_int
        _libs[name] = so
    return _libs[name]


def check_launch(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def host_f32(values):
    """A host float32 array for a C entry point that copies a few
    constants into its kernel's arguments (it must outlive the call)."""
    values = [float(v) for v in values]
    return (ctypes.c_float * len(values))(*values)


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper takes the plain version), False
    for a CUDA tensor (it launches the kernel); raises for any other
    device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, not "
                         f"{t.device}")
    return False


def require(t: torch.Tensor, name: str, dtype, ndim: int, device,
            contiguous: bool = True):
    """Raise on a tensor the kernel does not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def kernel_wrapper(fn=None, *, counters=()):
    """Register a kernel wrapper and give it a launch counter `launches`
    and the further plain int `counters` it names (as
    `@kernel_wrapper(counters=("staged",))`), all zeroed by
    `reset_launch_counts`."""
    def register(fn):
        fn.counters = ("launches", *counters)
        for name in fn.counters:
            setattr(fn, name, 0)
        _wrappers[fn.__name__] = fn
        return fn
    return register if fn is None else register(fn)


def wrappers() -> dict:
    return dict(_wrappers)


def reset_launch_counts():
    for fn in _wrappers.values():
        for name in fn.counters:
            setattr(fn, name, 0)
