"""Batched non-maximum suppression with padded, fixed-size outputs.

The port of ``yolov5_tpu/ops/nms.py``: confidence gating, multi-label
expansion, the class-offset trick, greedy suppression (kernel K1 on CUDA,
``ops/nms_kernel.py``), merge-NMS and compaction to ``max_det``.

Selection is exact and ties go to the lower index, as XLA's ``top_k`` does:
``torch.topk`` makes no promise about the order of ties on CUDA, so every
selection here is a stable descending sort cut to its first k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yolov5_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_traceable
from yolov5_tpu_torch.utils.profile import span

# Class-offset width: boxes of different classes are translated apart by
# class_id * MAX_WH so one class-agnostic pass does per-class NMS.
MAX_WH = 7680.0


class Detections(NamedTuple):
    """Padded NMS output. Entries with ``valid == False`` are padding."""

    boxes: torch.Tensor  # (bs, max_det, 4) xyxy, letterbox space
    scores: torch.Tensor  # (bs, max_det)
    classes: torch.Tensor  # (bs, max_det) int32
    masks: torch.Tensor  # (bs, max_det, nm) mask coefficients (nm may be 0)
    valid: torch.Tensor  # (bs, max_det) bool

    @property
    def counts(self):
        return self.valid.sum(-1)


def _f32(x: float) -> float:
    """A threshold as the float32 the reference compares against."""
    return float(np.float32(x))


def _select_k(flat: torch.Tensor, k: int):
    """Descending top-k of (bs, M) with ties to the lower index."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (bs, N, d), idx (bs, k) -> (bs, k, d)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _class_filter(class_filter, device):
    """Optional (nc,) bool keep-mask of classes, as a tensor on ``device``."""
    if class_filter is None:
        return None
    if isinstance(class_filter, torch.Tensor):
        return class_filter.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(class_filter, bool), device=device)


def _suppress_and_pack(top_scores, top_boxes, cls_idx, top_masks, *,
                       iou_thres, agnostic, max_det, merge, out_dtype, traceable=False):
    """Shared NMS tail: class-offset -> greedy suppression -> optional merge
    -> compact to max_det padded `Detections`. Candidates arrive score-sorted
    (descending) with gated-out entries at score 0. ``traceable`` suppresses
    with ``greedy_nms_traceable`` instead of K1."""
    bs, k = top_scores.shape
    nm = top_masks.shape[-1]
    thres = _f32(iou_thres)

    if agnostic:
        nms_boxes = top_boxes
    else:
        nms_boxes = top_boxes + (cls_idx.to(top_boxes.dtype) * MAX_WH)[..., None]
    nms_boxes = nms_boxes.float().contiguous()
    greedy = greedy_nms_traceable if traceable else greedy_nms
    keep = greedy(nms_boxes, top_scores.float().contiguous(), thres, max_det)

    if merge:
        # merge-NMS: each kept box becomes the score-weighted average of all
        # candidates with IoU > iou_thres against it (same class via offsets)
        m_iou = box_iou(nms_boxes, nms_boxes)
        w = torch.where(m_iou > thres, top_scores[:, None, :].float(), 0.0)  # (bs, K, K)
        merged = torch.einsum("bij,bjd->bid", w, top_boxes.float())
        denom = w.sum(2)[..., None]
        top_boxes = torch.where(keep[..., None], merged / denom.clamp(min=1e-8),
                                top_boxes.float()).to(top_boxes.dtype)

    # compact kept detections to the front, pad to max_det
    kept_scores = torch.where(keep, top_scores, 0.0)
    md = min(max_det, k)
    out_scores, order = _select_k(kept_scores, md)
    out_boxes = _gather_rows(top_boxes, order)
    out_classes = torch.gather(cls_idx, 1, order)
    out_masks = (_gather_rows(top_masks, order) if nm
                 else top_scores.new_zeros((bs, md, 0), dtype=out_dtype))
    if md < max_det:  # pad to the requested static output size
        pad = max_det - md
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        out_masks = torch.nn.functional.pad(out_masks, (0, 0, 0, pad))
    return Detections(out_boxes, out_scores, out_classes, out_masks, out_scores > 0)


def non_max_suppression(prediction, conf_thres=0.25, iou_thres=0.45,
                        multi_label=False, agnostic=False, max_det=300,
                        max_nms=30720, nc=None, class_filter=None,
                        merge=False, traceable=False) -> Detections:
    """Batched NMS on decoded predictions (bs, N, 5 + nc + nm): xywh box,
    objectness, class scores, optional mask coefficients. Arguments as in
    ``yolov5_tpu.ops.nms.non_max_suppression``; ``traceable`` makes it a
    function that ``torch.export`` traces (no K1: a graph of torch ops)."""
    prediction = torch.as_tensor(prediction)
    with span("nms", device=prediction.device):
        bs, n, no = prediction.shape
        if nc is None:
            nc = no - 5
        nm = no - nc - 5
        conf = _f32(conf_thres)

        obj = prediction[..., 4:5]
        cls_scores = prediction[..., 5:5 + nc] * obj  # (bs, N, nc)
        masks = prediction[..., 5 + nc:]
        boxes = xywh2xyxy(prediction[..., :4])
        class_filter = _class_filter(class_filter, prediction.device)
        if class_filter is not None:
            cls_scores = torch.where(class_filter, cls_scores, 0.0)

        k = min(max_nms, n * nc if multi_label else n)
        if multi_label and nc > 1:
            flat = cls_scores.reshape(bs, n * nc)
            flat = torch.where(flat > conf, flat, 0.0)
            top_scores, top_idx = _select_k(flat, k)
            box_idx = top_idx // nc
            cls_idx = (top_idx % nc).to(torch.int32)
        else:
            best = cls_scores.max(-1).values
            best = torch.where(best > conf, best, 0.0)
            top_scores, box_idx = _select_k(best, k)
            cls_idx = torch.gather(cls_scores.argmax(-1).to(torch.int32), 1, box_idx)
        top_boxes = _gather_rows(boxes, box_idx)
        top_masks = _gather_rows(masks, box_idx) if nm else masks[:, :0]

        return _suppress_and_pack(top_scores, top_boxes, cls_idx, top_masks,
                                  iou_thres=iou_thres, agnostic=agnostic,
                                  max_det=max_det, merge=merge,
                                  out_dtype=prediction.dtype, traceable=traceable)


def non_max_suppression_from_maps(maps, anchors, strides, conf_thres=0.25,
                                  iou_thres=0.45, multi_label=False,
                                  agnostic=False, max_det=300, max_nms=30720,
                                  nc=None, class_filter=None,
                                  merge=False) -> Detections:
    """Decode + NMS straight from the RAW head maps, each (bs, ny, nx, na, no).

    The same detections as ``non_max_suppression(decode(maps), ...)``:
    candidates are selected per level on σ(obj)·σ(max cls logit) (σ is
    monotone), re-selected globally, and only the survivors are decoded.
    ``anchors`` are per-level (na, 2) sizes in pixels, ``strides`` per-level
    strides; everything else as ``non_max_suppression``."""
    with span("nms", device=maps[0].device):
        bs, _, _, _, no = maps[0].shape
        if nc is None:
            nc = no - 5
        nm = no - nc - 5
        device = maps[0].device
        conf = _f32(conf_thres)
        class_filter = _class_filter(class_filter, device)

        n_total = sum(m.shape[1] * m.shape[2] * m.shape[3] for m in maps)
        k = min(max_nms, n_total * nc if multi_label else n_total)

        # the selection, everything before the suppression; its counts come
        # from shapes alone (``selected``: the candidates handed to K1)
        with span("nms.select", device=device, levels=len(maps), rows=n_total) as sel:
            parts = []  # per-level (scores, boxes_xyxy, cls_idx, masks)
            for y, a, s in zip(maps, anchors, strides):
                _, ny, nx, na, _ = y.shape
                n_l = ny * nx * na
                flat_y = y.reshape(bs, n_l, no)  # cell-major (gy, gx, anchor)
                obj_sig = torch.sigmoid(flat_y[..., 4].float())

                if multi_label and nc > 1:
                    probs = obj_sig[..., None] * torch.sigmoid(flat_y[..., 5:5 + nc].float())
                    if class_filter is not None:
                        probs = torch.where(class_filter, probs, 0.0)
                    flat = probs.reshape(bs, n_l * nc)
                    flat = torch.where(flat > conf, flat, 0.0)
                    scores_l, top_idx = _select_k(flat, min(k, n_l * nc))
                    cand_idx = top_idx // nc
                    cls_idx = (top_idx % nc).to(torch.int32)
                else:
                    # max and argmax in the maps' dtype: exact, and no f32 copy of
                    # the (bs, N, nc) class logits
                    cls_logits = flat_y[..., 5:5 + nc]
                    if class_filter is not None:
                        cls_logits = torch.where(class_filter, cls_logits, -torch.inf)
                    best_logit, best_cls = cls_logits.max(-1)
                    best = obj_sig * torch.sigmoid(best_logit.float())
                    best = torch.where(best > conf, best, 0.0)
                    scores_l, cand_idx = _select_k(best, min(k, n_l))
                    cls_idx = torch.gather(best_cls.to(torch.int32), 1, cand_idx)

                # gather the surviving raw rows, then decode only those
                rows = _gather_rows(flat_y, cand_idx).float()  # (bs, k_l, no)
                anc = cand_idx % na
                cell = cand_idx // na
                grid = torch.stack([(cell % nx).float(), (cell // nx).float()], -1)
                a_px = torch.as_tensor(a, dtype=torch.float32, device=device)[anc]
                xy = (torch.sigmoid(rows[..., 0:2]) * 2.0 - 0.5 + grid) * s
                wh = (torch.sigmoid(rows[..., 2:4]) * 2.0) ** 2 * a_px
                boxes_l = xywh2xyxy(torch.cat([xy, wh], -1))
                masks_l = rows[..., 5 + nc:] if nm else rows[..., :0]
                parts.append((scores_l, boxes_l, cls_idx, masks_l))

            top_scores, top_boxes, cls_idx, top_masks = (
                torch.cat([p[i] for p in parts], 1) for i in range(4))
            if len(parts) > 1:
                # one global sort: the suppression walks candidates in score order.
                # Past the cap it is exact, as every global top-k candidate is inside
                # its level's top-k_l. (yolov5_tpu sorts only past the cap, so under
                # it its walk goes level by level.)
                top_scores, order = _select_k(top_scores, min(k, top_scores.shape[1]))
                top_boxes = _gather_rows(top_boxes, order)
                cls_idx = torch.gather(cls_idx, 1, order)
                top_masks = _gather_rows(top_masks, order) if nm else top_masks[:, :k]
            if sel is not None:
                sel.counts["selected"] = top_scores.shape[1]

        return _suppress_and_pack(top_scores, top_boxes, cls_idx, top_masks,
                                  iou_thres=iou_thres, agnostic=agnostic,
                                  max_det=max_det, merge=merge,
                                  out_dtype=torch.float32)


def detections_to_numpy(dets: Detections):
    """Padded `Detections` -> per-image list of (n_i, 6 + nm) float arrays
    [x1, y1, x2, y2, conf, cls, *coeffs]."""
    with span("nms.fetch") as fetch:
        boxes, scores, classes, masks = (t.detach().float().cpu().numpy() for t in dets[:4])
        valid = dets.valid.cpu().numpy()
        if fetch is not None:
            fetch.counts["kept"] = int(valid.sum())
        out = []
        for b in range(boxes.shape[0]):
            v = valid[b]
            out.append(np.concatenate(
                [boxes[b][v], scores[b][v][:, None], classes[b][v][:, None], masks[b][v]],
                axis=1))
        return out
