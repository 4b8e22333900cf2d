"""The comparisons that decide ``correct``.

``detection_gap`` holds the detections a program returned for an image
against the plain reference's float32 forward of the same input, in score,
place and class, so that a near-tie that rounding tips (a score at the
threshold, an overlap at the suppression limit, two classes at an even
score) costs only how near it was. Places are compared in the units the
head predicts them in: a coordinate's offset over the reference box's
larger side plus its level's stride (the decode moves a box by up to a
stride for a small change of its logits, whatever its size).

  - each returned detection (box, score s, class c) is as far from the
    reference as the nearest of the reference's raw rows: the larger of
    |s - score of class c there| and the place term (the rows are taken
    before the threshold and the suppression, so a box that the reference
    suppressed or cut by a hair still finds itself);
  - each of the reference's detections (row n, class c, score s) is as far
    from the returned list as the least of: its distance to a returned
    detection (as above, and if that one has another class c', also
    |s - the reference's score of c' at row n|), how far it is from being
    suppressed by one (the larger of the score it lacks, the overlap it
    lacks to ``iou_thres`` with both boxes grown by half its stride, and the
    class term), its score's margin over ``conf_thres``, and, where the list
    is full at ``max_det``, its margin over the list's last score.

An image's gap is its largest such distance.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from perfbench.reference.nms import xywh2xyxy


@contextlib.contextmanager
def plain_float32():
    """float32 matmuls and convolutions without TF32, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _place(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(n, m): the largest coordinate offset of box a_i from box b_j over
    scale_j."""
    return (a[:, None, :] - b[None, :, :]).abs().amax(-1) / scale[None, :]


def _log(s: torch.Tensor) -> torch.Tensor:
    return torch.log(s.clamp(min=1e-30))


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes a and b (xyxy, last axis), broadcast over the others."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[..., 2:] - x[..., :2]).clamp(min=0).prod(-1)
    return inter / (area(a) + area(b) - inter + 1e-7)


def detection_distances(rows, pred, ref_rows, row_stride, conf_thres, iou_thres,
                        max_det) -> list:
    """rows: the returned detections, per image an (n, 6) array [x1, y1, x2,
    y2, score, class] in the input's pixels; pred: the reference's decoded
    (bs, N, 5 + nc) float32; ref_rows: its detections, as ``nms.nms``
    gives them (with their rows of pred); row_stride: (N,) each row's
    stride. Returns per image the distances of its returned detections and
    those of the reference's, each in its list's order (by score)."""
    out = []
    dev = pred.device
    conf = float(np.float32(conf_thres))
    for b in range(pred.shape[0]):
        p = torch.as_tensor(np.asarray(rows[b], np.float32)[:, :6], device=dev).reshape(-1, 6)
        r = torch.as_tensor(ref_rows[b][:, :7], device=dev).reshape(-1, 7)
        mine, theirs = np.zeros(0, np.float32), np.zeros(0, np.float32)
        scores = _log(pred[b, :, 5:] * pred[b, :, 4:5])  # (N, nc)
        boxes = xywh2xyxy(pred[b, :, :4])
        scale = (pred[b, :, 2:4].amax(-1) + row_stride)  # (N,)
        if len(p):
            at = scores[:, p[:, 5].long()].T  # (n_p, N)
            d = torch.maximum((at - _log(p[:, 4:5])).abs(), _place(p[:, :4], boxes, scale))
            mine = d.amin(1).cpu().numpy()
        if len(r):
            lr, lp = _log(r[:, 4]), _log(p[:, 4])
            e = lr - math.log(conf)
            if len(p):
                n = r[:, 6].long()
                flip = (lr[:, None] - scores[n][:, p[:, 5].long()]).abs()  # (n_r, n_p)
                ds = lr[:, None] - lp[None, :]
                place = _place(p[:, :4], r[:, :4], scale[n]).T
                match = torch.maximum(torch.maximum(ds.abs(), place), flip).amin(1)
                grow = (row_stride[n] / 2)[:, None, None] * torch.tensor(
                    [-1.0, -1.0, 1.0, 1.0], device=dev)
                iou = _iou(r[:, None, :4] + grow, p[None, :, :4] + grow)  # (n_r, n_p)
                supp = torch.maximum(torch.maximum(ds, iou_thres - iou), flip).clamp(min=0)
                e = torch.minimum(e, torch.minimum(match, supp.amin(1)))
                if len(p) >= max_det:
                    e = torch.minimum(e, (lr - lp.min()).clamp(min=0))
            theirs = e.cpu().numpy()
        out.append((mine, theirs))
    return out


def _largest(pair) -> float:
    """An image's gap: its largest distance on either side, 0 where neither
    side has a detection."""
    d = np.concatenate(pair)
    return float(d.max()) if len(d) else 0.0


def detection_gaps(*args) -> list:
    """Each image's gap: the largest of its ``detection_distances``."""
    return [_largest(pair) for pair in detection_distances(*args)]


def gap_stats(name: str, distances) -> dict:
    """From per-image ``detection_distances``: the largest, the 90th
    percentile, the median and the mean of the images' gaps, as ``name``,
    ``name.p90``, ``name.p50``, ``name.mean``; the mean of all the
    detections' distances, both sides (``name.det_mean``); the share of the
    returned detections farther than 0.5, per thousand
    (``name.returned_far``)."""
    g = np.sort([_largest(pair) for pair in distances])
    every = np.concatenate([np.asarray(d, np.float64) for pair in distances for d in pair]
                           + [np.zeros(0)])
    mine = np.concatenate([np.asarray(pair[0], np.float64) for pair in distances]
                          + [np.zeros(0)])
    return {name: float(g[-1]), f"{name}.p90": float(np.quantile(g, 0.9)),
            f"{name}.p50": float(np.quantile(g, 0.5)), f"{name}.mean": float(g.mean()),
            f"{name}.det_mean": float(every.mean()) if len(every) else 0.0,
            f"{name}.returned_far": 1000.0 * float((mine > 0.5).mean()) if len(mine) else 0.0}
