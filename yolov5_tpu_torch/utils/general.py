"""Run directories, image-size rounding, dataset configs and seeding.

Copies of ``increment_path``, ``check_img_size``, ``check_dataset``,
``init_seeds`` and ``labels_to_class_weights`` from
``yolov5_tpu/utils/general.py``, tested equal to them. Dataset presets are
read by path from ``yolov5_tpu/data/configs``.
"""

from __future__ import annotations

import math
import os
import random
from pathlib import Path

import numpy as np
import torch
import yaml

DATA_CONFIG_DIR = Path(__file__).resolve().parents[2] / "yolov5_tpu" / "data" / "configs"


def increment_path(path, exist_ok=False, sep="", mkdir=False):
    """runs/exp -> runs/exp2, exp3, ... (reference general.py:864-891)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def run_dir(save_dir, project, name, exist_ok=False):
    """A run's directory: ``save_dir``, else ``increment_path(project/name)``
    as rank 0 finds it, the same on every rank (nothing is created)."""
    from yolov5_tpu_torch.parallel.distributed import broadcast_object, is_main

    if save_dir:
        return Path(save_dir)
    return Path(broadcast_object(increment_path(Path(project) / name, exist_ok=exist_ok)
                                 if is_main() else None))


def init_seeds(seed=0):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def check_img_size(imgsz, s=32, floor=0):
    """Round image size up to a stride multiple (reference general.py:266)."""
    if isinstance(imgsz, int):
        new = max(math.ceil(imgsz / s) * s, floor)
        if new != imgsz:
            print(f"WARNING: --imgsz {imgsz} not multiple of stride {s}, using {new}")
        return new
    return [check_img_size(x, s, floor) for x in imgsz]


def check_dataset(data):
    """Load + validate a dataset config (dict, yaml path, or the name of a
    preset in ``yolov5_tpu/data/configs``). Schema: {path?, train, val?,
    test?, names|nc}. A missing split raises: nothing is downloaded.
    ``clearml://<dataset_id>`` is a ClearML dataset version, fetched by the
    ClearML SDK (``utils.loggers.construct_clearml_dataset``)."""
    if isinstance(data, str) and data.startswith("clearml://"):
        from yolov5_tpu_torch.utils.loggers import construct_clearml_dataset

        data = construct_clearml_dataset(data)
    if isinstance(data, (str, Path)):
        p = Path(data)
        if not p.exists():
            cand = DATA_CONFIG_DIR / p.with_suffix(".yaml").name
            if cand.exists():
                p = cand
        with open(p) as f:
            d = yaml.safe_load(f)
        d.setdefault("yaml_file", str(p))
    else:
        d = dict(data)
    if "names" in d:
        if isinstance(d["names"], (list, tuple)):
            d["names"] = dict(enumerate(d["names"]))
        d["nc"] = d.get("nc", len(d["names"]))
    elif "nc" in d:
        d["names"] = {i: f"class{i}" for i in range(d["nc"])}
    else:
        raise ValueError("dataset config needs 'names' or 'nc'")
    root = Path(d.get("path", "."))
    for split in ("train", "val", "test"):
        if d.get(split):
            v = d[split]
            paths = [v] if isinstance(v, (str, Path)) else list(v)
            resolved = []
            for p in paths:
                p = Path(p)
                if not p.is_absolute() and not p.exists() and (root / p).exists():
                    p = root / p  # split given relative to the dataset root
                if not p.exists():
                    raise FileNotFoundError(
                        f"dataset split '{split}' missing: {p} (nothing is "
                        "downloaded; generate or mount the data)")
                resolved.append(str(p))
            d[split] = resolved if len(resolved) > 1 else resolved[0]
    return d


def labels_to_class_weights(labels_list, nc):
    """Inverse-frequency class weights, summing to 1 (reference
    general.py:530-541): a class no label has weighs 0."""
    counts = np.zeros(nc)
    for lb in labels_list:
        if len(lb):
            counts += np.bincount(lb[:, 0].astype(int), minlength=nc)
    weights = 1.0 / np.maximum(counts, 1)
    weights[counts == 0] = 0
    return weights / max(weights.sum(), 1e-9)
