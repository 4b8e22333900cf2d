"""The native JPEG batch decoder: libjpeg decode, bilinear resize and
letterbox of a list of files, OpenMP-parallel over the files.

The port of ``yolov5_tpu/native``: ``yolo_native.cpp`` is that file's
decoder, arithmetic unchanged, so the two libraries give the same bytes when
built with the same flags on the same host. It is host code, compiled by g++
(not a CUDA kernel) at first use into ``build/libyolo_native-<hash>.so``,
keyed on the source, the flags and the host CPU (``-march=native``), and
loaded with ``ctypes``; importing the module builds nothing. Where g++, libjpeg's header or its library is
missing, ``available()`` is False and ``unavailable_reason()`` gives g++'s
first error line.

The library needs ``libgomp.so.1``. Where torch has loaded its own copy of
that runtime first (its OpenMP build does), the dynamic loader binds the
library to torch's copy by its soname, so one OpenMP runtime and one thread
pool serve both; ``tests/test_torch_native.py`` interleaves the two.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from yolov5_tpu_torch import _build

SOURCE = Path(__file__).parent / "yolo_native.cpp"
# the JAX package's flags (yolov5_tpu/native/__init__.py): -march=native and
# FMA contraction fix the rounding, so bit-equality needs both
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_LIB = None
_ERROR = None  # why the library cannot be built or loaded, once it failed


def _host_cpu() -> str:
    """The host CPU's model and feature flags: what ``-march=native``
    compiles for, so a library built on another CPU is not reused."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return ""
    return "\n".join(next((ln for ln in lines if ln.startswith(k)), "")
                     for k in ("model name", "flags"))


def library_path() -> Path:
    return _build.hashed_path("libyolo_native", CXX_FLAGS + LIBS + (_host_cpu(),), [SOURCE])


def _first_error(text: str) -> str:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    return next((ln for ln in lines if "error" in ln), lines[0] if lines else "no output")


def build() -> Path:
    """Compile the library unless it already exists; raise RuntimeError with
    g++'s first error line if it cannot be built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("g++ not found on PATH") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(_first_error(proc.stderr + proc.stdout))
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load():
    """The loaded library, built on first use; raises RuntimeError with the
    reason where it cannot be built or loaded (the failure is remembered)."""
    global _LIB, _ERROR
    with _lock:
        if _LIB is None:
            if _ERROR is not None:
                raise RuntimeError(_ERROR)
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as e:
                _ERROR = str(e)
                raise RuntimeError(_ERROR) from None
            lib.decode_letterbox_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.decode_letterbox_batch.restype = None
            lib.native_version.argtypes, lib.native_version.restype = [], ctypes.c_int
            _LIB = lib
        return _LIB


def available() -> bool:
    """True exactly where the library builds and loads."""
    try:
        return load().native_version() == 1
    except RuntimeError:
        return False


def unavailable_reason():
    """Why ``available()`` is False (g++'s first error line), else None."""
    return None if available() else _ERROR


def decode_letterbox_batch(paths, size, scaleup=True):
    """Decode and letterbox a list of JPEG paths natively.

    Returns (images (n, size, size, 3) uint8 RGB, hw0 (n, 2) int32, ok (n,)
    bool). A file that fails to decode has ok False (the caller falls back)."""
    lib = load()
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    hws = np.zeros((n, 2), np.int32)
    oks = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.decode_letterbox_batch(
        arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        size, int(scaleup),
        hws.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        oks.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out, hws, oks.astype(bool)
