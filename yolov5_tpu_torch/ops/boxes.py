"""Box geometry on tensors: the port of ``yolov5_tpu/ops/boxes.py``, with the
same arithmetic.

Box formats:
  xyxy  — (x1, y1, x2, y2) absolute corner coordinates
  xywh  — (cx, cy, w, h) absolute center + size
  xywhn — xywh divided by the image's width and height
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


def xywhn2xyxy(x: torch.Tensor, w=640, h=640, padw=0, padh=0) -> torch.Tensor:
    """Normalized center boxes -> absolute corner boxes (with optional pad offset)."""
    cx, cy, bw, bh = x.unbind(-1)
    return torch.stack([w * (cx - bw * 0.5) + padw, h * (cy - bh * 0.5) + padh,
                        w * (cx + bw * 0.5) + padw, h * (cy + bh * 0.5) + padh], -1)


def xyxy2xywhn(x: torch.Tensor, w=640, h=640, clip=False, eps=0.0) -> torch.Tensor:
    """Absolute corner boxes -> normalized center boxes."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5 / w, (y1 + y2) * 0.5 / h, (x2 - x1) / w,
                        (y2 - y1) / h], -1)


def xyn2xy(x: torch.Tensor, w=640, h=640, padw=0, padh=0) -> torch.Tensor:
    """Normalized (..., 2) points -> absolute pixel points."""
    px, py = x.unbind(-1)
    return torch.stack([w * px + padw, h * py + padh], -1)


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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh=True, GIoU=False, DIoU=False,
             CIoU=False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU of broadcast-compatible (..., 4)
    boxes -> (..., 1). CIoU = IoU - rho²/c² - alpha·v with
    v = (4/pi²)·(atan(w2/h2) - atan(w1/h1))²; alpha carries no gradient, as
    in the reference (its ``torch.no_grad`` block)."""
    if xywh:
        (x1, y1, w1, h1), (x2, y2, w2, h2) = box1.chunk(4, -1), box2.chunk(4, -1)
        w1_, h1_, w2_, h2_ = w1 * 0.5, h1 * 0.5, w2 * 0.5, h2 * 0.5
        b1x1, b1x2, b1y1, b1y2 = x1 - w1_, x1 + w1_, y1 - h1_, y1 + h1_
        b2x1, b2x2, b2y1, b2y2 = x2 - w2_, x2 + w2_, y2 - h2_, y2 + h2_
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.chunk(4, -1)
        b2x1, b2y1, b2x2, b2y2 = box2.chunk(4, -1)
        w1, h1 = b1x2 - b1x1, (b1y2 - b1y1) + eps
        w2, h2 = b2x2 - b2x1, (b2y2 - b2y1) + eps

    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)  # enclosing box w
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)  # enclosing box h
    if CIoU or DIoU:
        c2 = cw**2 + ch**2 + eps
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) * 0.25
        if CIoU:
            v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            return iou - (rho2 / c2 + v * alpha)
        return iou - rho2 / c2
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def bbox_ioa(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Intersection over box2's area: (N, 4) x (M, 4) xyxy -> (N, M)."""
    b1, b2 = box1[:, None, :], box2[None, :, :]
    inter = ((torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0]))
             .clamp(min=0)
             * (torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1]))
             .clamp(min=0))
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]) + eps
    return inter / area2[None, :]


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU of (w, h) pairs sharing a top-left corner: (N, 2) x (M, 2) -> (N, M)."""
    inter = torch.minimum(wh1[:, None], wh2[None, :]).prod(-1)
    return inter / (wh1.prod(-1)[:, None] + wh2.prod(-1)[None, :] - inter + eps)


def smooth_bce(eps=0.1):
    """Label-smoothing targets (positive, negative) for BCE."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def make_divisible(x, divisor=8):
    """Round channel count up to the nearest multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)
