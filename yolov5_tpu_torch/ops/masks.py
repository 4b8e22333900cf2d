"""Mask ops for instance segmentation.

The port of ``yolov5_tpu/ops/masks.py`` and of ``crop_mask``
(``yolov5_tpu/train/loss.py``): ``crop_mask`` and ``process_mask`` run in
torch on the masks' device; ``scale_image`` and ``masks2segments`` are host
numpy. Neither needs OpenCV: ``scale_image`` resizes with
``F.interpolate`` (bilinear, half-pixel centres, as ``cv2.resize`` with
``INTER_LINEAR``), and ``masks2segments`` finds outer borders with
``find_external_contours``, a numpy copy of OpenCV's border follower that
gives the points of ``cv2.findContours(m, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)``, in its order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside their xyxy box (reference
    utils/segment/general.py:10-22). masks (n, h, w), boxes (n, 4) in mask
    pixels; pixel (x, y) is inside when x1 <= x < x2 and y1 <= y < y2."""
    n, h, w = masks.shape
    x = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None, :]
    y = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    x1, y1, x2, y2 = (boxes[:, i].reshape(n, 1, 1) for i in range(4))
    inside = (x >= x1) & (x < x2) & (y >= y1) & (y < y2)
    return masks * inside


def process_mask(protos, coeffs, boxes, img_hw, upsample=False) -> torch.Tensor:
    """Combine prototypes with per-detection coefficients.

    protos (hm, wm, nm); coeffs (n, nm); boxes (n, 4) xyxy in pixels of the
    network input of size ``img_hw`` (h, w). Returns (n, h', w') float32
    masks in [0, 1], cropped to their boxes: h' = h with ``upsample``
    (bilinear, half-pixel centres: ``jax.image.resize`` when scaling up),
    else hm."""
    hm, wm, nm = protos.shape
    ih, iw = img_hw
    masks = torch.sigmoid(coeffs.float() @ protos.float().reshape(hm * wm, nm).T)
    masks = masks.reshape(-1, hm, wm)
    boxes = boxes.float()
    if upsample:
        masks = F.interpolate(masks[None], size=(ih, iw), mode="bilinear",
                              align_corners=False)[0]
    else:
        boxes = boxes * boxes.new_tensor([wm / iw, hm / ih, wm / iw, hm / ih])
    return crop_mask(masks, boxes)


def masks_to_binary(masks, thresh=0.5):
    return masks > thresh


def scale_image(masks_hw, im0_shape, ratio_pad=None) -> np.ndarray:
    """Un-letterbox masks back to the source image's (h0, w0) (host numpy).

    masks_hw (h, w, n) or (h, w): the letterbox padding is cut off and the
    rest resized bilinearly, as ``cv2.resize`` with ``INTER_LINEAR`` does.
    Returns float32 (h0, w0, n), or (h0, w0) for a 2D input or n = 1 (the
    layout ``cv2.resize`` gives)."""
    im1_shape = masks_hw.shape[:2]
    if ratio_pad is None:
        gain = min(im1_shape[0] / im0_shape[0], im1_shape[1] / im0_shape[1])
        pad = (im1_shape[1] - im0_shape[1] * gain) / 2, (im1_shape[0] - im0_shape[0] * gain) / 2
    else:
        pad = ratio_pad[1]
    top, left = int(pad[1]), int(pad[0])
    bottom, right = int(im1_shape[0] - pad[1]), int(im1_shape[1] - pad[0])
    m = np.asarray(masks_hw[top:bottom, left:right], np.float32)
    m3 = m.reshape(*m.shape[:2], -1)
    t = torch.from_numpy(np.ascontiguousarray(m3.transpose(2, 0, 1)))[None]
    if t.shape[2:] != tuple(im0_shape[:2]):
        t = F.interpolate(t, size=tuple(im0_shape[:2]), mode="bilinear", align_corners=False)
    out = t[0].numpy().transpose(1, 2, 0)
    return out[..., 0] if out.shape[2] == 1 else np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# Outer borders (Suzuki-Abe border following, as OpenCV implements it)
# ---------------------------------------------------------------------------

# direction codes 0..7: right, up-right, up, up-left, left, down-left, down,
# down-right (image y grows downwards)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
# marks a followed border leaves in the working image: a border pixel whose
# right neighbour was examined and is background, and any other
_RIGHT_MARK = -126
_LEFT_MARK = 2


def _follow_border(img, x0, y0):
    """Follow the outer border that starts at (x0, y0) of the zero-framed
    int8 image ``img`` (0 background, 1 object, marks of borders already
    followed), marking it as it goes. Returns its points, one where the
    direction changes, in the frame's coordinates less one."""
    s = s_end = 4
    while True:  # clockwise from up-left for the last neighbour of the border
        s = (s - 1) & 7
        x1, y1 = x0 + _DX[s], y0 + _DY[s]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:  # an isolated pixel
        img[y0, x0] = _RIGHT_MARK
        return [(x0 - 1, y0 - 1)]
    pts = []
    x3, y3 = x0, y0
    prev_s = s ^ 4
    while True:
        s_end = s
        while s < 15:  # counter-clockwise from the direction we came from
            s += 1
            x4, y4 = x3 + _DX[s & 7], y3 + _DY[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the search passed the right neighbour
            img[y3, x3] = _RIGHT_MARK
        elif img[y3, x3] == 1:
            img[y3, x3] = _LEFT_MARK
        if s != prev_s:
            pts.append((x3 - 1, y3 - 1))
            prev_s = s
        if x4 == x0 and y4 == y0 and x3 == x1 and y3 == y1:
            return pts
        x3, y3 = x4, y4
        s = (s + 4) & 7


def find_external_contours(mask) -> list[np.ndarray]:
    """The outer borders of the 8-connected parts of a 2D mask (nonzero is
    object) that lie in no hole of another part: a list of (k, 1, 2) int32
    (x, y) arrays with the points where the border turns, equal to what
    ``cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)``
    returns, in its order (the last border found by the raster scan first)."""
    m = np.asarray(mask) != 0
    h, w = m.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = m
    found = []
    for y in np.flatnonzero(m.any(1)) + 1:
        row = img[y]
        lnbd = 0  # the last border pixel met in this row (0: the frame)
        prev = 0
        x = 1
        while x <= w:
            change = np.flatnonzero(row[x:w + 1] != prev)
            if not len(change):
                break
            x += int(change[0])
            p = int(row[x])
            # a new outer border, unless it lies inside one already followed
            if prev == 0 and p == 1 and img[y, lnbd] <= 0:
                found.append(_follow_border(img, x, y))
                lnbd = x
                prev = int(row[x])
            else:
                prev = p
                if p not in (0, 1):
                    lnbd = x
            x += 1
    return [np.array(c, np.int32).reshape(-1, 1, 2) for c in reversed(found)]


def masks2segments(masks, strategy="largest"):
    """Binary masks (n, h, w) -> list of (k, 2) float32 polygons: per mask,
    the outer border with the most points (the first of equals), or with
    ``strategy="concat"`` all of them in turn (reference
    segment/predict.py:45 via ultralytics)."""
    segments = []
    for m in np.asarray(masks):
        contours = find_external_contours(m)
        if contours:
            if strategy == "concat":
                c = np.concatenate([c.reshape(-1, 2) for c in contours])
            else:  # largest
                c = max(contours, key=len).reshape(-1, 2)
        else:
            c = np.zeros((0, 2))
        segments.append(c.astype(np.float32))
    return segments
