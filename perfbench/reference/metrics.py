"""The plain reference of yolov5's detection metrics (ultralytics/yolov5
v7.0 utils/metrics.py: ap_per_class with the COCO 101-point interpolation
and the max-F1 operating point, compute_ap, process_batch) and of val.py's
native-space matching (scale_boxes, clipped), in numpy.
"""

from __future__ import annotations

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz
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


def process_batch(detections, labels, iouv):
    """Greedy IoU matching at each threshold, uniquified by detection and by
    label (reference utils/metrics.py:224-265).

    detections: (N, 6) [x1,y1,x2,y2,conf,cls]; labels: (M, 5) [cls,x1,y1,x2,y2].
    Returns (N, len(iouv)) bool TP matrix.
    """
    correct = np.zeros((detections.shape[0], len(iouv)), bool)
    if detections.shape[0] == 0 or labels.shape[0] == 0:
        return correct
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


def scale_to_native(boxes, lb_hw, native_hw):
    """Letterbox-space xyxy -> the source image's xyxy, clipped to it."""
    gain = min(lb_hw[0] / native_hw[0], lb_hw[1] / native_hw[1])
    pad_x = (lb_hw[1] - native_hw[1] * gain) / 2
    pad_y = (lb_hw[0] - native_hw[0] * gain) / 2
    out = boxes.copy()
    out[:, [0, 2]] = ((boxes[:, [0, 2]] - pad_x) / gain).clip(0, native_hw[1])
    out[:, [1, 3]] = ((boxes[:, [1, 3]] - pad_y) / gain).clip(0, native_hw[0])
    return out


def xywhn_to_xyxy(lab, w, h):
    """(n, 5) [cls, x, y, w, h] normalised -> (n, 5) [cls, x1, y1, x2, y2] px."""
    if not len(lab):
        return np.zeros((0, 5), np.float32)
    xyxy = np.empty((len(lab), 4), np.float32)
    xyxy[:, 0] = (lab[:, 1] - lab[:, 3] / 2) * w
    xyxy[:, 1] = (lab[:, 2] - lab[:, 4] / 2) * h
    xyxy[:, 2] = (lab[:, 1] + lab[:, 3] / 2) * w
    xyxy[:, 3] = (lab[:, 2] + lab[:, 4] / 2) * h
    return np.concatenate([lab[:, 0:1].astype(np.float32), xyxy], 1)


def mean_ap(stats):
    """[(correct, conf, pred_cls, target_cls)] per image -> (mAP50, mAP50-95)."""
    tp, conf, pred_cls, target_cls = (np.concatenate([s[i] for s in stats]) for i in range(4))
    if not (tp.shape[0] and target_cls.shape[0]):
        return 0.0, 0.0
    ap = ap_per_class(tp, conf, pred_cls, target_cls)["ap"]
    return float(ap[:, 0].mean()), float(ap.mean(1).mean())
