"""Model graph, layers and weight conversion; the package re-exports the
names of ``yolov5_tpu/models/__init__.py``."""

from yolov5_tpu_torch.models.yolo import (
    ClassificationModel,
    DetectionModel,
    SegmentationModel,
    build_model,
    load_config,
)

__all__ = [
    "ClassificationModel",
    "DetectionModel",
    "SegmentationModel",
    "build_model",
    "load_config",
]
