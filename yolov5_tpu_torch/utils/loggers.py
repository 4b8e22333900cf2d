"""Training loggers: ``results.csv`` only.

``CSVLogger`` is a copy of ``yolov5_tpu/utils/loggers.py::CSVLogger``;
``Loggers`` is that module's facade with the CSV sink alone. The
TensorBoard, W&B, ClearML and Comet sinks are not ported.
"""

from __future__ import annotations

import csv
from pathlib import Path


class CSVLogger:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._keys = None
        # resume: adopt the existing header instead of appending a second
        # one mid-file
        if self.path.exists():
            with open(self.path, newline="") as f:
                first = f.readline().strip()
            if first:
                self._keys = [k.strip() for k in first.split(",")]

    def log(self, row: dict):
        write_header = self._keys is None
        if write_header:
            self._keys = list(row.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


class Loggers:
    """The JAX package's logger facade with its CSV sink only."""

    def __init__(self, save_dir):
        self.save_dir = Path(save_dir)
        self.csv = CSVLogger(self.save_dir / "results.csv")

    def log_metrics(self, row: dict, step: int):
        self.csv.log({"step": step, **row})
