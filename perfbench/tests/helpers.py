"""Small cells on the CPU for the tests: yolov5n at 128 px, the runners'
own code, the port on the CPU (its kernels' plain versions)."""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench.core import spec

HERE = Path(__file__).resolve().parent
SMALL = {
    "detect-b32": {"batch": 2, "pool_batches": 2, "frame_hw": [144, 256], "imgsz": 128,
                   "half": False, "det_per_img": 40, "trace_batches": 2},
    "val-b32": {"batch": 4, "images": 8, "imgsz": 128, "half": False, "cand_per_img": 3000,
                "shapes": [[72, 128], [96, 128]], "workers": 2},
}


@dataclass
class Ctx:
    cell: object
    seed: int = 20240917
    seconds: float = 0.5
    trace: bool = False
    device: object = torch.device("cpu")
    t_start: float = 0.0
    notes: list = field(default_factory=list)

    def note(self, **kv):
        self.notes.append(kv)


def small_cell(name: str, cell_of=spec.cell, **traffic) -> spec.Cell:
    """The benchmark's cell ``name`` with yolov5n and small traffic."""
    cell = copy.deepcopy(cell_of(name))
    cfg = json.loads((HERE.parent / "configs" / "yolov5s.json").read_text())
    cfg["yaml"] = str(HERE / "yolov5n.yaml")
    cell.config = cfg
    cell.traffic.update(SMALL[cell.traffic_name], **traffic)
    return cell
