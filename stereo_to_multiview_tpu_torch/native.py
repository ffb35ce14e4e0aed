"""ctypes binding for the native host runtime (native/stm_native.cpp):
BMP read/write, a multi-threaded decode-ahead frame queue, and a Y4M
reader.

The port compiles that source (read only) with the host C++ compiler into
its own library under `_build/` (beside the CUDA kernels' libraries; the
file name carries a hash of the source and flags), on first use.  Where
no compiler or source is present, `load()` returns None and the callers
take the pure-Python readers, which decode the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "stm_native.cpp"
BUILD = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """The library's path: a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"libstm_native-{h.hexdigest()[:12]}.so"


def _build(path: Path):
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler")
    BUILD.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, path)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except Exception:
            return None
        lib.stm_wall_time.restype = ctypes.c_double
        lib.stm_cpu_time.restype = ctypes.c_double
        lib.stm_bmp_read.restype = ctypes.c_int
        lib.stm_bmp_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.stm_bmp_write.restype = ctypes.c_int
        lib.stm_bmp_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
        lib.stm_queue_create.restype = ctypes.c_void_p
        lib.stm_queue_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.stm_queue_next.restype = ctypes.c_int
        lib.stm_queue_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.stm_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.stm_y4m_open.restype = ctypes.c_void_p
        lib.stm_y4m_open.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.stm_y4m_next.restype = ctypes.c_int
        lib.stm_y4m_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.stm_y4m_rewind.argtypes = [ctypes.c_void_p]
        lib.stm_y4m_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def read_bmp(path: str) -> np.ndarray:
    """Native BMP read -> (H, W, 3) uint8 BGR."""
    lib = load()
    if lib is None:
        from stereo_to_multiview_tpu_torch.utils.bmp import read_bmp as py_read
        return py_read(path)
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.stm_bmp_read(path.encode(), None, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"stm_bmp_read({path}) header failed: {rc}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.stm_bmp_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                          ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"stm_bmp_read({path}) failed: {rc}")
    return out


def write_bmp(path: str, img: np.ndarray) -> None:
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if lib is None:
        from stereo_to_multiview_tpu_torch.utils.bmp import write_bmp as py_write
        py_write(path, img)
        return
    h, w = img.shape[:2]
    rc = lib.stm_bmp_write(path.encode(),
                           img.ctypes.data_as(ctypes.c_void_p), h, w)
    if rc != 0:
        raise IOError(f"stm_bmp_write({path}) failed: {rc}")


class NativeFrameQueue:
    """Multi-threaded decode-ahead frame queue (SBS frames or stitched L/R
    pairs).  Iterates (H, W_sbs, 3) uint8 frames in order."""

    def __init__(self, paths: List[str], pair_mode: bool = False,
                 depth: int = 4, loops: int = 1, threads: int = 2):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._q = lib.stm_queue_create(arr, len(paths), int(pair_mode),
                                       depth, loops, threads)
        if not self._q:
            raise RuntimeError("stm_queue_create failed")
        # output buffer geometry from the first frame's BMP header
        # (pair mode stitches L|R side by side)
        h, w = read_bmp(paths[0]).shape[:2]
        self._shape: Tuple[int, int] = (h, 2 * w if pair_mode else w)

    def __iter__(self):
        h = ctypes.c_int32()
        w = ctypes.c_int32()
        while True:
            out = np.empty((self._shape[0], self._shape[1], 3), np.uint8)
            rc = self._lib.stm_queue_next(
                self._q, out.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(h), ctypes.byref(w))
            if rc == 1:
                return
            if rc == -1:
                continue  # skip undecodable/mismatched frame
            if rc != 0:
                raise IOError(f"stm_queue_next failed: {rc}")
            yield out[: h.value, : w.value]

    def close(self):
        if self._q:
            self._lib.stm_queue_destroy(self._q)
            self._q = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeY4M:
    """Native Y4M video reader (stm_y4m_*): sequential BGR uint8 frames
    with rewind support.  Bit-identical output to utils.y4m.Y4MReader."""

    def __init__(self, path: str):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        self._r = lib.stm_y4m_open(path.encode(), ctypes.byref(w),
                                   ctypes.byref(h))
        if not self._r:
            raise IOError(f"stm_y4m_open({path}) failed")
        self.w, self.h = w.value, h.value

    def read_frame(self) -> Optional[np.ndarray]:
        out = np.empty((self.h, self.w, 3), np.uint8)
        rc = self._lib.stm_y4m_next(self._r,
                                    out.ctypes.data_as(ctypes.c_void_p))
        if rc == 1:
            return None
        if rc != 0:
            raise IOError(f"stm_y4m_next failed: {rc}")
        return out

    def rewind(self) -> None:
        self._lib.stm_y4m_rewind(self._r)

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self):
        if self._r:
            self._lib.stm_y4m_close(self._r)
            self._r = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
