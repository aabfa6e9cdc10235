"""ctypes bindings of the port's native TIFF codec and batch loader
(`tiffio.cpp`; counterpart of `lgteun_tpu/native/__init__.py`).

At first use `g++` compiles `tiffio.cpp` into
`build/lgteun_tpu_torch/libtiffio_<hash>.so` at the repository root (the
hash of the source and the flags; written under a temporary name and
renamed, so concurrent processes never load a half-written library).
Where it does not build or load, `get_lib()` logs one line and returns
None, and each entry point returns None / False: the callers
(`data.dataset.read_tiff`) then use the Python codec,
`lgteun_tpu_torch/data/tiff.py`.

    read_tiff_native(path)           uint16 [H, W] or [H, W, C], or None
                                     (no library, or a file the native
                                     parser refuses: big-endian,
                                     compressed, float, malformed)
    write_tiff_native(path, array)   a single-strip uint16 TIFF; False
                                     without the library
    read_batch_native(paths, (H, W, C), scale, threads)
                                     float32 [N, H, W, C] (times `scale`
                                     when nonzero) decoded by `threads`
                                     workers, or None (any file not of
                                     that shape, or unreadable)
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["BUILD_DIR", "get_lib", "read_tiff_native", "write_tiff_native",
           "read_batch_native"]

SRC = Path(__file__).resolve().parent / "tiffio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lgteun_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
_log = logging.getLogger("lgteun_torch.native")


def _build() -> Path:
    """The library's path, compiled first if it is not there; raises on a
    failed compile."""
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    out = BUILD_DIR / f"libtiffio_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_lib():
    """The native library with its C signatures declared, or None (after
    one logged line) where it does not build or load."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            why = (getattr(e, "stderr", None) or str(e)).strip()
            _log.warning("native TIFF codec unavailable (%s); reading TIFFs "
                         "with the Python codec",
                         why.splitlines()[-1] if why else type(e).__name__)
            return None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.lg_tiff_read_u16_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
            c_int_p, c_int_p, c_int_p]
        lib.lg_tiff_write_u16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.lg_tiff_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
            ctypes.c_int]
        for fn in (lib.lg_tiff_read_u16_dims, lib.lg_tiff_write_u16,
                   lib.lg_tiff_read_batch):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def read_tiff_native(path: str) -> np.ndarray | None:
    """uint16 [H, W] or [H, W, C], or None where the native path cannot
    read `path`. The file is read once, into a buffer of as many values
    as it has bytes (no TIFF holds more samples than bytes)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        capacity = os.path.getsize(path)
    except OSError:
        return None
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    out = np.empty(capacity, np.uint16)
    if lib.lg_tiff_read_u16_dims(
            os.fsencode(path), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint16)), capacity, ctypes.byref(h),
            ctypes.byref(w), ctypes.byref(c)) != 0:
        return None
    out = out[:h.value * w.value * c.value]
    if c.value > 1:
        return out.reshape(h.value, w.value, c.value)
    return out.reshape(h.value, w.value)


def write_tiff_native(path: str, array: np.ndarray) -> bool:
    """Write `array` ([H, W] or [H, W, C]) as a uint16 TIFF; False without
    the library or where the file cannot be opened."""
    lib = get_lib()
    if lib is None:
        return False
    arr = np.ascontiguousarray(array, np.uint16)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    return lib.lg_tiff_write_u16(
        os.fsencode(path), arr.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)), h, w, c) == 0


def read_batch_native(paths: list[str], shape_hwc: tuple[int, int, int],
                      scale: float = 0.0,
                      threads: int = 8) -> np.ndarray | None:
    """float32 [N, H, W, C] of `paths` (every file of shape `shape_hwc`),
    times `scale` when nonzero, or None."""
    lib = get_lib()
    if lib is None:
        return None
    h, w, c = shape_hwc
    elems = h * w * c
    out = np.empty((len(paths), elems), np.float32)
    names = (ctypes.c_char_p * len(paths))(*map(os.fsencode, paths))
    if lib.lg_tiff_read_batch(names, len(paths), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), elems, ctypes.c_float(scale),
            threads) != 0:
        return None
    return out.reshape(len(paths), h, w, c)
