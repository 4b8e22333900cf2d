"""The plain reference of yolov5's instance segmentation (ultralytics/yolov5
v7.0: models/yolo.py Segment, models/common.py Proto, utils/segment/general.py
crop_mask, process_mask and mask_iou, utils/segment/dataloaders.py
polygons2masks_overlap, segment/val.py process_batch), in plain torch and
numpy, float32, on NCHW tensors. It builds on the detection reference
(``yolo.py``, ``nms.py``, ``metrics.py``) and imports nothing of the measured
program or of JAX.

Segment is Detect with ``nm`` mask coefficients after the classes of each
anchor (no = 5 + nc + nm) and a Proto on the first level's features: Conv
3x3 to c_ = make_divisible(npr · width_multiple, 8) channels, nearest x2
upsample, Conv 3x3, Conv 1x1 to nm prototypes (each Conv with BN and SiLU).
The graph up to the Detect convs is ``yolo.Model`` run on the "detect view"
of the YAML: the same rows with the Segment row read as a Detect of nc + nm
classes, whose convs are the Segment convs, keys and all. The decode keeps
the coefficients raw; the NMS (``nms.nms`` over the nc class columns) carries
each kept row's coefficients. A mask is σ(coefficients · prototypes).

Departures from v7.0, each shared by the port and the JAX package:
  - ``process_mask`` upsamples the proto-resolution masks to the input
    (bilinear, half-pixel centres) and then crops them to their boxes in
    input pixels, before the 0.5 threshold; v7.0 crops at proto resolution
    with the boxes scaled down, then upsamples;
  - GT polygons are scaled to mask pixels, cut to int32 and filled there
    (``cv2.fillPoly`` at 160² for 640 px), where v7.0 fills at the input
    size and shrinks the mask with ``cv2.resize``;
  - in the overlap form, instances are painted in descending order of the
    area of the scaled float polygon (``cv2.contourArea``), the smaller on
    top, and instance i of the label file is written as i + 1; v7.0 orders
    by the filled mask's pixel count and writes the rank + 1, reordering
    the labels to match;
  - the mask IoU divides by the union clamped below at 1e-9; v7.0 adds 1e-7,
    which a float32 union of one pixel or more does not notice.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import nms as ref_nms
from perfbench.reference import yolo


def segment_row(cfg: dict):
    """(index, from, nm, npr) of the Segment row of ``cfg``."""
    rows = list(cfg["backbone"]) + list(cfg["head"])
    i = len(rows) - 1
    f, _, m, args = rows[i]
    if m != "Segment":
        raise ValueError(f"the last row is {m}, not Segment")
    nm = args[2] if len(args) > 2 else 32
    npr = args[3] if len(args) > 3 else 256
    return i, f, nm, npr


def detect_view(cfg: dict) -> dict:
    """``cfg`` with its Segment row read as a Detect of nc + nm classes: the
    same convs under the same keys, no = 5 + nc + nm."""
    _, f, nm, _ = segment_row(cfg)
    view = copy.deepcopy(cfg)
    view["nc"] = cfg["nc"] + nm
    view["head"][-1] = [f, 1, "Detect", [view["nc"], "anchors"]]
    return view


def proto_specs(cfg: dict):
    """The Proto's three convs (cv1 3x3, cv2 3x3 after the upsample, cv3
    1x1 to nm), on the first Detect level's channels."""
    i, _, nm, npr = segment_row(cfg)
    view = detect_view(cfg)
    heads = [c for c in yolo.parse(view)[2] if c.head]
    c1 = heads[0].c1
    c_ = yolo._divisible(npr * cfg["width_multiple"])
    p = f"model.{i}.proto."
    return (yolo.ConvSpec(p + "cv1.", c1, c_, 3, 1, 1), yolo.ConvSpec(p + "cv2.", c_, c_, 3, 1, 1),
            yolo.ConvSpec(p + "cv3.", c_, nm, 1, 1, 0))


def leaf_shapes(cfg: dict) -> dict:
    """{key: shape} of every weight, unfused: the detect view's and the
    Proto's."""
    out = yolo.leaf_shapes(detect_view(cfg))
    for c in proto_specs(cfg):
        out[c.key + "conv.weight"] = (c.c2, c.c1, c.k, c.k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[c.key + "bn." + leaf] = (c.c2,)
    return out


class Model(yolo.Model):
    """The graph of a segmentation ``cfg`` over ``sd``: (bs, 3, H, W)
    float32 in [0, 1] -> (maps [(bs, ny, nx, na, 5 + nc + nm)], prototypes
    (bs, nm, H/4, W/4)). ``precision`` as ``yolo.Model``'s, for every conv
    (the Proto's too)."""

    def __init__(self, cfg: dict, sd: dict, precision: str = "f32"):
        super().__init__(detect_view(cfg), sd, precision)
        self.proto = proto_specs(cfg)
        self._protos = None

    def _layer(self, kind, info, x):
        if kind == "Detect":  # x: per level, a list of batches
            cv1, cv2, cv3 = self.proto
            y = self._conv(cv1, x[0])
            y = [F.interpolate(t, scale_factor=2, mode="nearest") for t in y]
            self._protos = self._conv(cv3, self._conv(cv2, y))
        return super()._layer(kind, info, x)

    def __call__(self, x: torch.Tensor):
        maps = self._run([x])[0]
        return maps, self._protos[0]


def decode(maps, cfg: dict):
    """Head maps -> (predictions (bs, N, 5 + nc) as ``yolo.decode`` gives
    them, coefficients (bs, N, nm) raw, in the same row order)."""
    nc = cfg["nc"]
    view = detect_view(cfg)
    pred = yolo.decode([m[..., :5 + nc] for m in maps], view)
    coeffs = torch.cat([m[..., 5 + nc:].float().reshape(m.shape[0], -1, m.shape[-1] - 5 - nc)
                        for m in maps], 1)
    return pred, coeffs


def nms(pred, coeffs, conf_thres, iou_thres, max_det, max_nms, multi_label=True,
        with_counts=False):
    """``nms.nms`` over the classes, each kept row followed by its
    coefficients: per image an (n, 7 + nm) float32 array [x1, y1, x2, y2,
    score, class, row of pred, coefficients]."""
    got = ref_nms.nms(pred, conf_thres, iou_thres, max_det, max_nms, multi_label=multi_label,
                      with_counts=with_counts)
    rows = got[0] if with_counts else got
    c = coeffs.cpu().numpy()
    out = [np.concatenate([r, c[b][r[:, 6].astype(np.int64)]], 1).astype(np.float32)
           for b, r in enumerate(rows)]
    return (out, *got[1:]) if with_counts else out


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero each (h, w) mask outside its xyxy box: pixel (x, y) is inside
    when x1 <= x < x2 and y1 <= y < y2."""
    n, h, w = masks.shape
    x1, y1, x2, y2 = torch.chunk(boxes[:, :, None], 4, 1)  # (n, 1, 1) each
    r = torch.arange(w, device=masks.device, dtype=boxes.dtype)[None, None, :]
    c = torch.arange(h, device=masks.device, dtype=boxes.dtype)[None, :, None]
    return masks * ((r >= x1) * (r < x2) * (c >= y1) * (c < y2))


def process_mask(protos: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor, shape):
    """protos (nm, hm, wm), coeffs (n, nm), boxes (n, 4) xyxy in input
    pixels -> (n, h, w) float32 masks in [0, 1] at the input's ``shape``:
    σ(coeffs · protos), upsampled bilinearly (half-pixel centres), then
    cropped to the boxes."""
    nm, hm, wm = protos.shape
    masks = torch.sigmoid(coeffs.float() @ protos.float().reshape(nm, -1)).reshape(-1, hm, wm)
    masks = F.interpolate(masks[None], size=tuple(shape), mode="bilinear",
                          align_corners=False)[0]
    return crop_mask(masks, boxes.float())


def polygons_to_overlap_mask(polygons, img_px: int, hm: int, wm: int) -> np.ndarray:
    """Label polygons (each (k, 2) float32 in input pixels, of a square
    input of ``img_px``) -> one (hm, wm) int32 map, instance i as i + 1, 0
    the background: each polygon scaled to mask pixels, cut to int32 and
    filled by ``cv2.fillPoly``, in descending order of its scaled float
    area (the smaller on top)."""
    import cv2

    out = np.zeros((hm, wm), np.int32)
    scale = np.float32(wm / img_px), np.float32(hm / img_px)
    polys, areas = [], []
    for seg in polygons:
        p = seg.copy()
        p[:, 0] *= scale[0]
        p[:, 1] *= scale[1]
        polys.append(p.astype(np.int32))
        areas.append(cv2.contourArea(p.astype(np.float32)))
    for i in np.argsort(-np.asarray(areas)) if areas else []:
        cv2.fillPoly(out, [polys[i]], int(i) + 1)
    return out


def instance_masks(overlap: torch.Tensor, g: int, shape) -> torch.Tensor:
    """An (hm, wm) overlap map's first ``g`` instances as (g, h, w) 0/1
    float32 masks at ``shape``: one-hot, upsampled bilinearly, > 0.5."""
    one = (overlap[None] == torch.arange(1, g + 1, device=overlap.device)[:, None, None])
    up = F.interpolate(one.float()[None], size=tuple(shape), mode="bilinear",
                       align_corners=False)[0]
    return (up > 0.5).float()


def mask_iou(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(g, P) and (n, P) 0/1 float32 masks -> (g, n) IoU; the counts are
    exact in float32 below 2^24 pixels."""
    inter = gt @ pred.T
    union = gt.sum(1)[:, None] + pred.sum(1)[None, :] - inter
    return inter / union.clamp(min=1e-9)


def image_mask_ious(protos, rows, overlap, g: int, shape, nm: int) -> torch.Tensor:
    """One image's (g, n) GT x detection mask IoUs at the input's
    resolution: the detections ``rows`` ((n, >= 6 + nm) [xyxy, score, class,
    ..., coefficients in the last nm columns]) over ``protos`` (nm, hm, wm),
    against the first g instances of the overlap map."""
    dev = protos.device
    r = torch.as_tensor(np.ascontiguousarray(rows), device=dev)
    pm = (process_mask(protos, r[:, -nm:], r[:, :4], shape) > 0.5).reshape(len(r), -1).float()
    gm = instance_masks(overlap.to(dev), g, shape).reshape(g, -1)
    return mask_iou(gm, pm)


def match(iou: np.ndarray, label_cls: np.ndarray, det_cls: np.ndarray, iouv) -> np.ndarray:
    """segment/val.py process_batch on a given (g, n) IoU matrix: at each
    threshold, the pairs of one class at or above it, best IoU first, each
    detection and each label taken once. Returns (n, len(iouv)) bool."""
    correct = np.zeros((iou.shape[1], len(iouv)), bool)
    if not iou.size:
        return correct
    iou = iou * (label_cls[:, None] == det_cls[None, :])
    for i, thr in enumerate(iouv):
        li, di = np.nonzero(iou >= thr)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if li.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def read_polygons(path):
    """The rows of a polygon label file: (classes (n,) float32, polygons [(k,
    2) float32 normalised])."""
    cls, polys = [], []
    with open(path) as f:
        for line in f.read().strip().splitlines():
            v = line.split()
            cls.append(float(v[0]))
            polys.append(np.array(v[1:], np.float32).reshape(-1, 2))
    return np.asarray(cls, np.float32), polys


def params(cfg: dict) -> int:
    """Parameters of the unfused model (BN running statistics left out)."""
    return sum(math.prod(s) for k, s in leaf_shapes(cfg).items() if "running" not in k)
