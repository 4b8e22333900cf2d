"""The plain reference of yolov5's non-max suppression (ultralytics/yolov5
v7.0 utils/general.py non_max_suppression): candidates whose score
obj·cls passes ``conf_thres`` (every passing class with ``multi_label``, the
best class otherwise), at most ``max_nms`` of them by score, boxes of
different classes moved apart by class·7680 px, a greedy walk that keeps a
candidate unless an earlier kept one overlaps it by IoU > ``iou_thres``,
and at most ``max_det`` kept, by score.

The walk runs one candidate position at a time over the whole batch, so it
is plain and exact; ``greedy`` also counts the IoUs the walk needs (for each
candidate it reaches, the kept boxes it is compared with until the first
that suppresses it), which the roofline of a suppression kernel counts.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WH = 7680.0


def _f32(x: float) -> float:
    return float(np.float32(x))


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4] / 2
    return torch.cat([xy - wh, xy + wh], -1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., n, 4), b (..., m, 4) xyxy -> (..., n, m)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2:] - a[..., :2]).clamp(min=0).prod(-1)
    area_b = (b[..., 2:] - b[..., :2]).clamp(min=0).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-7)


def select(pred: torch.Tensor, conf_thres: float, multi_label: bool, max_nms: int):
    """Decoded predictions (bs, N, 5 + nc) -> the candidates, score-sorted:
    scores (bs, K) with 0 past each image's last, boxes (bs, K, 4) xyxy,
    classes (bs, K) and their rows of ``pred`` (bs, K). K is the largest
    count in the batch, at most max_nms."""
    bs, n, no = pred.shape
    nc = no - 5
    cls = pred[..., 5:] * pred[..., 4:5]
    conf = _f32(conf_thres)
    if multi_label and nc > 1:
        flat = cls.reshape(bs, n * nc)
        flat = torch.where(flat > conf, flat, 0.0)
        k = min(max_nms, int((flat > 0).sum(1).max()))
        scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        scores, idx = scores[:, :k], idx[:, :k]
        box_idx, classes = idx // nc, idx % nc
    else:
        best, best_cls = cls.max(-1)
        best = torch.where(best > conf, best, 0.0)
        k = min(max_nms, int((best > 0).sum(1).max()))
        scores, box_idx = torch.sort(best, dim=1, descending=True, stable=True)
        scores, box_idx = scores[:, :k], box_idx[:, :k]
        classes = torch.gather(best_cls, 1, box_idx)
    boxes = torch.gather(xywh2xyxy(pred[..., :4]), 1, box_idx[..., None].expand(-1, -1, 4))
    return scores, boxes, classes, box_idx


def greedy(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, max_det: int):
    """Keep mask (bs, K) of the greedy walk over score-sorted candidates
    (scores <= 0 are padding), and the IoUs it needs per image (bs,).

    Candidate i is kept unless a kept j < i overlaps it; it meets the kept
    boxes in order, until the first that suppresses it."""
    bs, k, _ = boxes.shape
    dev = boxes.device
    keep = torch.zeros((bs, k), dtype=torch.bool, device=dev)
    needed = torch.zeros(bs, dtype=torch.int64, device=dev)
    thres = _f32(iou_thres)
    n_kept = torch.zeros(bs, dtype=torch.int64, device=dev)
    live = scores > 0
    for i in range(k):
        go = live[:, i] & (n_kept < max_det)
        if not bool(go.any()):
            break
        sup = (box_iou(boxes[:, i:i + 1], boxes)[:, 0] > thres) & keep  # (bs, K)
        hit = sup.any(1)
        rank = torch.cumsum(keep.to(torch.int64), 1)
        first = torch.gather(rank, 1, sup.to(torch.uint8).argmax(1, keepdim=True))[:, 0]
        needed += torch.where(go, torch.where(hit, first, n_kept), 0)
        new = go & ~hit
        keep[:, i] = new
        n_kept += new.to(torch.int64)
    return keep, needed


def nms(pred: torch.Tensor, conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=30720,
        multi_label=False, with_counts=False):
    """Per image an (n, 7) float32 numpy array [x1, y1, x2, y2, score, class,
    row of pred], by descending score; with ``with_counts`` also the candidates and the
    IoUs of the walk per image."""
    scores, boxes, classes, rows_idx = select(pred, conf_thres, multi_label, max_nms)
    keep, needed = greedy((boxes + classes[..., None].float() * MAX_WH).contiguous(),
                          scores, iou_thres, max_det)
    rows = torch.cat([boxes, scores[..., None], classes[..., None].float(),
                      rows_idx[..., None].float()], -1).cpu().numpy()
    keep_np = keep.cpu().numpy()
    out = []
    for b in range(rows.shape[0]):
        r = rows[b][keep_np[b]]
        order = np.argsort(-r[:, 4], kind="stable")[:max_det]
        out.append(np.ascontiguousarray(r[order], np.float32))
    if with_counts:
        return out, (scores > 0).sum(1).cpu().numpy(), needed.cpu().numpy()
    return out
