"""Detection metrics: AP, precision/recall curves, confusion matrix.

A numpy copy of ``yolov5_tpu/eval/metrics.py``, tested equal to it: the
reference's ``ap_per_class`` (utils/metrics.py:25-95), ``compute_ap``
(:98-126) and ``process_batch`` (:224-265) with the COCO 101-point
interpolation and the max-F1 operating point.
"""

from __future__ import annotations

import numpy as np

# np.trapz was renamed np.trapezoid in numpy 2.0
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def fitness(metrics):
    """Weighted [P, R, mAP@.5, mAP@.5:.95] -> scalar, weights [0,0,0.1,0.9]
    (reference utils/metrics.py:19-22)."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return float((np.asarray(metrics[:4]) * w).sum())


def smooth(y, f=0.05):
    """Box-filter smoothing with edge padding."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision):
    """COCO-style AP: precision envelope + 101-point interpolation.
    Returns (ap, mpre, mrec)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps=1e-16):
    """Per-class AP from accumulated predictions.

    tp: (n_pred, n_iou) bool TP matrix; conf, pred_cls: (n_pred,);
    target_cls: (n_gt,). Returns dict with tp/fp counts at the max-F1 point,
    p, r, f1, ap (nc, n_iou), and the present class ids.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = nt[ci]
        n_p = int(sel.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()  # max-F1 operating point
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return {
        "tp": tp_count, "fp": fp_count, "p": p, "r": r, "f1": f1, "ap": ap,
        "classes": unique_classes.astype(int), "nt": nt,
        "p_curve": p_curve, "r_curve": r_curve, "px": px,
    }


def _box_iou_np(a, b, eps=1e-7):
    """(N,4) x (M,4) xyxy -> (N,M) numpy IoU."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(br - tl, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def mask_iou(m1, m2, eps=1e-7):
    """(N, hw) x (M, hw) binary masks -> (N, M) IoU."""
    inter = m1.astype(np.float64) @ m2.T.astype(np.float64)
    union = m1.sum(1)[:, None] + m2.sum(1)[None, :] - inter
    return inter / (union + eps)


def process_batch(detections, labels, iouv, pred_masks=None, gt_masks=None,
                  iou=None):
    """Greedy IoU matching at each threshold, uniquified by detection and by
    label (reference utils/metrics.py:224-265).

    detections: (N, 6) [x1,y1,x2,y2,conf,cls]; labels: (M, 5) [cls,x1,y1,x2,y2].
    When masks are given ((N,hw) and (M,hw) binary), matches on mask IoU.
    A precomputed (M, N) `iou` matrix overrides both (for a mask IoU
    computed on the device instead of on the host).
    Returns (N, len(iouv)) bool TP matrix.
    """
    correct = np.zeros((detections.shape[0], len(iouv)), bool)
    if detections.shape[0] == 0 or labels.shape[0] == 0:
        return correct
    if iou is not None:
        pass
    elif pred_masks is not None and gt_masks is not None:
        iou = mask_iou(gt_masks, pred_masks)
    else:
        iou = _box_iou_np(labels[:, 1:5], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    iou = iou * correct_class
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


class ConfusionMatrix:
    """(nc+1)² confusion matrix including a background row/col
    (reference utils/metrics.py:129-221)."""

    def __init__(self, nc, conf=0.25, iou_thres=0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections, labels):
        if detections is None or detections.shape[0] == 0:
            for gc in labels[:, 0].astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        if labels.shape[0] == 0:
            for dc in det_classes:
                self.matrix[dc, self.nc] += 1
            return
        iou = _box_iou_np(labels[:, 1:5], detections[:, :4])
        li, di = np.nonzero(iou > self.iou_thres)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], axis=1)
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1  # correct/confused
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]
