"""Aspect-preserving resize + pad, and its inverse for boxes (host side).

A copy of ``yolov5_tpu/data/letterbox.py`` and ``yolov5_tpu.infer.scale_boxes_np``
without OpenCV: the resize is ``data.cv.resize`` (bit-exact with
``cv2.resize(..., INTER_LINEAR)``) and the constant border is written with
numpy instead of ``cv2.copyMakeBorder`` (same result).
"""

from __future__ import annotations

import numpy as np

from yolov5_tpu_torch.data.cv import resize


def letterbox(im, new_shape=(640, 640), color=(114, 114, 114), auto=False,
              scale_fill=False, scaleup=True, stride=32):
    shape = im.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:  # only downscale (val: better mAP)
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # w, h
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # pad only to stride multiple (rect inference)
        dw, dh = dw % stride, dh % stride
    elif scale_fill:  # stretch, no pad
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        im = resize(im, new_unpad, "linear")
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w = im.shape[:2]
    out = np.empty((h + top + bottom, w + left + right) + im.shape[2:], im.dtype)
    # cv2.BORDER_CONSTANT takes one value per channel (the first for 2D)
    out[...] = color if im.ndim == 3 else color[0]
    out[top:top + h, left:left + w] = im
    return out, ratio, (dw, dh)


def scale_boxes_np(img1_shape, boxes, img0_shape):
    """Numpy un-letterbox of (n, 4) xyxy boxes from ``img1_shape`` (h, w) back
    to ``img0_shape`` (h, w), clipped to the source image."""
    gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
    pad_x = (img1_shape[1] - img0_shape[1] * gain) / 2
    pad_y = (img1_shape[0] - img0_shape[0] * gain) / 2
    out = boxes.copy()
    out[:, [0, 2]] = (boxes[:, [0, 2]] - pad_x) / gain
    out[:, [1, 3]] = (boxes[:, [1, 3]] - pad_y) / gain
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, img0_shape[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, img0_shape[0])
    return out
