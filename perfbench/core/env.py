"""A run's environment: the compile caches at fixed paths inside the
checkout, the libraries kept from loading JAX, the card the cell needs, and
the check that nothing of JAX, TensorFlow or the JAX package was imported.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# compared whole with the part of each module name before its first dot, so
# the port (yolov5_tpu_torch) does not match the JAX package (yolov5_tpu)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "yolov5_tpu", "tensorflow"})


def prepare(pkg: Path) -> None:
    """Set, before torch is imported, what the run's libraries read: the
    Triton cache under ``perfbench/`` (the port's own kernels build into its
    ``build/`` directory, keyed on their hash), and no JAX or TensorFlow
    behind transformers-style imports."""
    os.environ["TRITON_CACHE_DIR"] = str(Path(pkg) / "cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(Path(pkg) / "cache" / "torch_extensions")
    for k in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[k] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names in ``modules`` (default ``sys.modules``) that are
    JAX, jaxlib, flax, TensorFlow or the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def require_cards(n: int) -> str | None:
    """None where ``n`` CUDA cards are present, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < n:
        return f"the cell needs {n} cards, torch.cuda.device_count() is {torch.cuda.device_count()}"
    return None
