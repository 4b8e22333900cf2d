"""Tensor ops: box geometry, NMS, and the hand-written CUDA kernels' wrappers.

The package re-exports the names of ``yolov5_tpu/ops/__init__.py``. No
kernel builds at import: each builds at its first launch."""

from yolov5_tpu_torch.ops.boxes import (
    bbox_iou,
    bbox_ioa,
    box_iou,
    clip_boxes,
    scale_boxes,
    xywh2xyxy,
    xywhn2xyxy,
    xyxy2xywh,
    xyxy2xywhn,
)
from yolov5_tpu_torch.ops.nms import non_max_suppression

__all__ = [
    "bbox_iou",
    "bbox_ioa",
    "box_iou",
    "clip_boxes",
    "scale_boxes",
    "xywh2xyxy",
    "xywhn2xyxy",
    "xyxy2xywh",
    "xyxy2xywhn",
    "non_max_suppression",
]
