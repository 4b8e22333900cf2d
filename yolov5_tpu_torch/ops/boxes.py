"""Box geometry on tensors: the subset of ``yolov5_tpu/ops/boxes.py`` that the
detection serving path uses, with the same arithmetic.

Box formats:
  xyxy  — (x1, y1, x2, y2) absolute corner coordinates
  xywh  — (cx, cy, w, h) absolute center + size
"""

from __future__ import annotations

import math

import torch


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner boxes -> center boxes."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center boxes -> corner boxes."""
    cx, cy, w, h = x.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)


def clip_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Clip (..., 4) xyxy boxes to image bounds ``shape`` = (h, w)."""
    h, w = shape[0], shape[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                        x2.clamp(0, w), y2.clamp(0, h)], -1)


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape,
                ratio_pad=None) -> torch.Tensor:
    """Rescale xyxy boxes from a letterboxed ``img1_shape`` (h, w) back to the
    original ``img0_shape`` (h, w)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    boxes = torch.stack([(x1 - pad[0]) / gain, (y1 - pad[1]) / gain,
                         (x2 - pad[0]) / gain, (y2 - pad[1]) / gain], -1)
    return clip_boxes(boxes, img0_shape)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of two xyxy box sets: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    a1 = box1[..., :, None, :2]
    a2 = box1[..., :, None, 2:]
    b1 = box2[..., None, :, :2]
    b2 = box2[..., None, :, 2:]
    inter_wh = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area1 = (box1[..., 2:] - box1[..., :2]).prod(-1)
    area2 = (box2[..., 2:] - box2[..., :2]).prod(-1)
    union = area1[..., :, None] + area2[..., None, :] - inter + eps
    return inter / union


def make_divisible(x, divisor=8):
    """Round channel count up to the nearest multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)
