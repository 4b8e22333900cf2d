"""Hyperparameter presets (the reference ships these as data/hyps/*.yaml;
values from hyp.scratch-low/med/high.yaml). A copy of
``yolov5_tpu/utils/hyp.py``, tested equal to it."""

from __future__ import annotations

from pathlib import Path

import yaml

SCRATCH_LOW = {
    "lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "box": 0.05, "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
    "iou_t": 0.20, "anchor_t": 4.0, "fl_gamma": 0.0,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
    "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0,
    "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
    "mosaic": 1.0, "mixup": 0.0, "copy_paste": 0.0,
    "label_smoothing": 0.0,
}

SCRATCH_MED = {**SCRATCH_LOW, "cls": 0.3, "obj": 0.7, "scale": 0.9,
               "mixup": 0.1, "copy_paste": 0.1}

SCRATCH_HIGH = {**SCRATCH_MED, "cls": 0.3, "obj": 0.7, "mixup": 0.1,
                "copy_paste": 0.1, "scale": 0.9, "lr0": 0.01}

NO_AUGMENTATION = {**SCRATCH_LOW, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0,
                   "translate": 0.0, "scale": 0.0, "fliplr": 0.0,
                   "mosaic": 0.0, "mixup": 0.0}

# evolved dataset presets (reference data/hyps/hyp.VOC.yaml — GA generation
# 467 — and hyp.Objects365.yaml; "anchors" = evolved anchors-per-layer count)
VOC = {
    **SCRATCH_LOW,
    "lr0": 0.00334, "lrf": 0.15135, "momentum": 0.74832,
    "weight_decay": 0.00025, "warmup_epochs": 3.3835,
    "warmup_momentum": 0.59462, "warmup_bias_lr": 0.18657,
    "box": 0.02, "cls": 0.21638, "cls_pw": 0.5, "obj": 0.51728,
    "obj_pw": 0.67198, "anchor_t": 3.3744,
    "hsv_h": 0.01041, "hsv_s": 0.54703, "hsv_v": 0.27739,
    "translate": 0.04591, "scale": 0.75544,
    "mosaic": 0.85834, "mixup": 0.04266, "anchors": 3.412,
}

OBJECTS365 = {
    **SCRATCH_LOW,
    "lr0": 0.00258, "lrf": 0.17, "momentum": 0.779,
    "weight_decay": 0.00058, "warmup_epochs": 1.33,
    "warmup_momentum": 0.86, "warmup_bias_lr": 0.0711,
    "box": 0.0539, "cls": 0.299, "cls_pw": 0.825, "obj": 0.632,
    "anchor_t": 3.44, "anchors": 3.2,
    "hsv_h": 0.0188, "hsv_s": 0.704, "hsv_v": 0.36,
    "translate": 0.0902, "scale": 0.491,
}

PRESETS = {
    "scratch-low": SCRATCH_LOW,
    "scratch-med": SCRATCH_MED,
    "scratch-high": SCRATCH_HIGH,
    "no-augmentation": NO_AUGMENTATION,
    "VOC": VOC,
    "Objects365": OBJECTS365,
}


def load_hyp(hyp=None) -> dict:
    """None/preset-name/yaml-path/dict -> full hyp dict."""
    if hyp is None:
        return dict(SCRATCH_LOW)
    if isinstance(hyp, dict):
        return {**SCRATCH_LOW, **hyp}
    name = str(hyp)
    key = name.removeprefix("hyp.").removesuffix(".yaml")
    if key in PRESETS:
        return dict(PRESETS[key])
    with open(name) as f:
        return {**SCRATCH_LOW, **yaml.safe_load(f)}
