"""COCO-protocol detection scoring (pycocotools COCOeval equivalent, bbox
and segm).

A copy of ``yolov5_tpu/eval/coco.py``, tested equal to it: greedy
per-(image, category) matching at 10 IoU thresholds, area-range and maxDet
stratification, 101-point interpolated AP. It cross-checks the in-house
``ap_per_class`` (eval/metrics.py) on the JSON the evaluators write. In
segm mode IoUs and areas come from the RLE masks (``eval/rle.py``).

Detections: [{"image_id", "category_id", "bbox" [x, y, w, h], "score",
              "segmentation" (segm: RLE)}, ...]
Ground truth: [{"image_id", "category_id", "bbox" [x, y, w, h],
                "iscrowd" (optional), "segmentation", "area" (segm)}, ...]
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from yolov5_tpu_torch.eval.rle import polygons_to_rle, rle_area, rle_iou

# COCO class-id remap: the 80 contiguous training ids -> the 91-id COCO
# annotation space (reference coco80_to_coco91_class via ultralytics)
COCO80_TO_COCO91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dt, gt, iscrowd):
    """IoU between (n,4) and (m,4) xywh boxes; crowd GTs use intersection
    over det area (the COCO 'ignore region' semantics)."""
    n, m = len(dt), len(gt)
    out = np.zeros((n, m), np.float64)
    if not n or not m:
        return out
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None], da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEvalLite:
    """COCOeval equivalent. evaluate() -> accumulate() -> summarize().

    iou_type: 'bbox' or 'segm' (mask IoU and mask area from RLE).
    """

    def __init__(self, gt, dt, iou_thrs=IOU_THRS, rec_thrs=REC_THRS,
                 max_dets=MAX_DETS, area_rng=None, iou_type="bbox"):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"COCOEvalLite: iou_type {iou_type!r} (bbox or segm)")
        self.iou_type = iou_type
        self.iou_thrs = np.asarray(iou_thrs)
        self.rec_thrs = np.asarray(rec_thrs)
        self.max_dets = tuple(max_dets)
        self.area_rng = area_rng or dict(AREA_RNG)
        self.img_ids = sorted({g["image_id"] for g in gt} |
                              {d["image_id"] for d in dt})
        self.cat_ids = sorted({g["category_id"] for g in gt})
        self._gt = defaultdict(list)
        self._dt = defaultdict(list)
        for g in gt:
            self._gt[(g["image_id"], g["category_id"])].append(g)
        for d in dt:
            self._dt[(d["image_id"], d["category_id"])].append(d)
        self.eval_imgs = None
        self.precision = None
        self.recall = None
        # per-(image, category) IoU matrices, reused across the 4 area
        # ranges (pycocotools likewise computes IoU once per img/cat —
        # only the gt ignore-ordering changes with the range)
        self._iou_cache = {}

    # -- per-image matching -------------------------------------------------
    def _evaluate_img(self, img_id, cat_id, arng):
        gts = self._gt.get((img_id, cat_id), [])
        dts = self._dt.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        T = len(self.iou_thrs)
        max_det = self.max_dets[-1]

        segm = self.iou_type == "segm"
        g_crowd = np.array([bool(g.get("iscrowd")) for g in gts], bool)
        if segm:
            g_area = np.array([float(g.get("area", rle_area(g["segmentation"])))
                               for g in gts], np.float64)
        else:
            g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
            g_area = g_boxes[:, 2] * g_boxes[:, 3]
        g_ign = g_crowd | (g_area < arng[0]) | (g_area > arng[1])
        # ignored gts sort last so real matches are preferred
        g_order = np.argsort(g_ign, kind="mergesort")
        g_crowd_nat = g_crowd  # native order, for the cached IoU compute
        g_crowd, g_ign = g_crowd[g_order], g_ign[g_order]

        d_scores = np.array([d["score"] for d in dts], np.float64)
        d_order = np.argsort(-d_scores, kind="mergesort")[:max_det]
        d_scores = d_scores[d_order]
        # the IoU matrix depends only on (image, category): compute it once
        # in native gt order and re-index per area range
        cached = self._iou_cache.get((img_id, cat_id))
        if cached is None:
            if segm:
                d_rles = [dts[i]["segmentation"] for i in d_order]
                d_area = np.array([rle_area(r) for r in d_rles], np.float64)
                ious_nat = rle_iou(d_rles, [g["segmentation"] for g in gts], g_crowd_nat)
            else:
                d_boxes = np.array(
                    [d["bbox"] for d in dts], np.float64).reshape(-1, 4)[d_order]
                d_area = d_boxes[:, 2] * d_boxes[:, 3]
                ious_nat = _iou_xywh(d_boxes, g_boxes, g_crowd_nat)
            cached = self._iou_cache[(img_id, cat_id)] = (ious_nat, d_area)
        ious_nat, d_area = cached
        ious = ious_nat[:, g_order]
        D, G = ious.shape
        gtm = np.zeros((T, G), np.int64) - 1
        dtm = np.zeros((T, D), np.int64) - 1
        dt_ig = np.zeros((T, D), bool)
        for t, thr in enumerate(self.iou_thrs):
            for dind in range(D):
                best = min(thr, 1.0 - 1e-10)
                m = -1
                for gind in range(G):
                    if gtm[t, gind] >= 0 and not g_crowd[gind]:
                        continue  # taken (crowds can absorb many dets)
                    if m > -1 and not g_ign[m] and g_ign[gind]:
                        break  # past real gts into ignores with a match in hand
                    if ious[dind, gind] < best:
                        continue
                    best = ious[dind, gind]
                    m = gind
                if m == -1:
                    continue
                dtm[t, dind] = m
                gtm[t, m] = dind
                dt_ig[t, dind] = g_ign[m]
        # unmatched dets outside the area range are ignored, not FPs
        out_of_rng = (d_area < arng[0]) | (d_area > arng[1])
        dt_ig |= (dtm == -1) & out_of_rng[None]
        return {
            "scores": d_scores,
            "matched": dtm >= 0,
            "dt_ignore": dt_ig,
            "n_gt": int((~g_ign).sum()),
        }

    def evaluate(self):
        self.eval_imgs = {
            (a, k): [self._evaluate_img(i, cat, rng) for i in self.img_ids]
            for a, rng in self.area_rng.items()
            for k, cat in enumerate(self.cat_ids)
        }
        return self

    # -- curves ---------------------------------------------------------------
    def accumulate(self):
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(self.area_rng)
        M = len(self.max_dets)
        self.precision = -np.ones((T, R, K, A, M))
        self.recall = -np.ones((T, K, A, M))
        for a, aname in enumerate(self.area_rng):
            for k in range(K):
                imgs = [e for e in self.eval_imgs[(aname, k)] if e is not None]
                if not imgs:
                    continue
                n_gt = sum(e["n_gt"] for e in imgs)
                if n_gt == 0:
                    continue
                for m, max_det in enumerate(self.max_dets):
                    scores = np.concatenate([e["scores"][:max_det] for e in imgs])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate(
                        [e["matched"][:, :max_det] for e in imgs], 1)[:, order]
                    ign = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in imgs], 1)[:, order]
                    tps = np.cumsum(matched & ~ign, 1, dtype=np.float64)
                    fps = np.cumsum(~matched & ~ign, 1, dtype=np.float64)
                    for t in range(T):
                        tp, fp = tps[t], fps[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        self.recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # right-to-left envelope (interpolated precision)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        ok = inds < len(pr)
                        q[ok] = pr[inds[ok]]
                        self.precision[t, :, k, a, m] = q
        return self

    def _summ(self, ap=True, iou=None, area="all", max_det=100):
        a = list(self.area_rng).index(area)
        m = self.max_dets.index(max_det)
        if ap:
            s = self.precision[:, :, :, a, m]
            if iou is not None:
                s = s[np.isclose(self.iou_thrs, iou)]
        else:
            s = self.recall[:, :, a, m]
            if iou is not None:
                s = s[np.isclose(self.iou_thrs, iou)]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self):
        """The standard 12 COCO numbers, keyed."""
        md = self.max_dets[-1]
        return {
            "map": self._summ(True, None, "all", md),
            "map50": self._summ(True, 0.5, "all", md),
            "map75": self._summ(True, 0.75, "all", md),
            "map_small": self._summ(True, None, "small", md),
            "map_medium": self._summ(True, None, "medium", md),
            "map_large": self._summ(True, None, "large", md),
            "ar1": self._summ(False, None, "all", self.max_dets[0]),
            "ar10": self._summ(False, None, "all", self.max_dets[1]),
            "ar100": self._summ(False, None, "all", md),
            "ar_small": self._summ(False, None, "small", md),
            "ar_medium": self._summ(False, None, "medium", md),
            "ar_large": self._summ(False, None, "large", md),
        }


def gt_from_dataset(ds, coco91=False):
    """Build COCO-format ground truth from a YOLODataset: labels are
    normalized xywh against the NATIVE image shapes (the same space the
    evaluator's save_json detections are scaled back to)."""
    gts = []
    shapes = ds.shapes
    for i, (path, labels) in enumerate(zip(ds.im_files, ds.labels)):
        stem = Path(path).stem
        image_id = int(stem) if stem.isnumeric() else stem
        h, w = int(shapes[i][0]), int(shapes[i][1])
        for row in labels:
            cid = int(row[0])
            if coco91 and cid < len(COCO80_TO_COCO91):
                cid = COCO80_TO_COCO91[cid]
            bw, bh = row[3] * w, row[4] * h
            gts.append({
                "image_id": image_id,
                "category_id": cid,
                "bbox": [row[1] * w - bw / 2, row[2] * h - bh / 2, bw, bh],
            })
    return gts


def gt_from_dataset_segm(ds, coco91=False):
    """COCO segm ground truth from a segmentation dataset: each label's
    polygon (``ds.segments``, normalised xy) filled at the native image size
    and RLE-encoded, with its box and mask area (reference
    segment/val.py:366-382). Labels without a polygon are left out."""
    gts = []
    shapes = ds.shapes
    for i, (path, labels) in enumerate(zip(ds.im_files, ds.labels)):
        stem = Path(path).stem
        image_id = int(stem) if stem.isnumeric() else stem
        h, w = int(shapes[i][0]), int(shapes[i][1])
        segs = ds.segments[i] if ds.segments is not None else [None] * len(labels)
        for row, seg in zip(labels, segs):
            cid = int(row[0])
            if coco91 and cid < len(COCO80_TO_COCO91):
                cid = COCO80_TO_COCO91[cid]
            if seg is None or len(seg) < 3:
                continue
            rle = polygons_to_rle([np.asarray(seg) * [w, h]], h, w)
            bw, bh = row[3] * w, row[4] * h
            gts.append({
                "image_id": image_id,
                "category_id": cid,
                "bbox": [row[1] * w - bw / 2, row[2] * h - bh / 2, bw, bh],
                "segmentation": rle,
                "area": rle_area(rle),
            })
    return gts


def score_detections_json(json_path_or_rows, gt, iou_type="bbox"):
    """Score a detections JSON (the evaluator's save_json output) against GT;
    returns the 12 summary numbers (reference val.py:368-383 contract)."""
    rows = json_path_or_rows
    if not isinstance(rows, list):
        rows = json.loads(Path(rows).read_text())
    ev = COCOEvalLite(gt, rows, iou_type=iou_type)
    return ev.evaluate().accumulate().summarize()
