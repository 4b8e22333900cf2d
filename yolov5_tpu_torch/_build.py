"""Build the package's CUDA kernels with nvcc at first use and load them.

Every ``.cu`` file under ``csrc/`` is compiled to an object by its own nvcc,
all at once, and the objects are linked into one shared library with a plain
C interface, ``build/libyolov5_kernels-<hash>.so``, keyed on a hash of the
sources and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. The library is loaded with ``ctypes``; the wrappers pass pointers
from ``Tensor.data_ptr()`` and PyTorch's current stream, and the kernels
allocate nothing. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
_SIGNATURES = {
    # boxes, scores, keep, bs, K, thres, max_det, stream
    "yolo_greedy_nms": (_P, _P, _P, _I, _I, _F, _I, _P),
    # x, w_hi, w_lo (or None), b, y, B, H, W, c2, dtype, stream
    "yolo_stem_conv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}
_ERROR_STRING = "yolo_cuda_error_string"

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libyolov5_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels of yolov5_tpu_torch cannot be built")


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one nvcc per source, started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(_run, [[nvcc, *compile_flags, "-c", "-o", str(o), str(src)]
                             for src, o in zip(srcs, objs)]))
    _run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(o) for o in objs)])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, _ERROR_STRING)
            err.argtypes, err.restype = (_I,), ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = getattr(load(), _ERROR_STRING)(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
