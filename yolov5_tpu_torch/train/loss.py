"""The detection and segmentation losses, batched over the padded
assignment lattice, and the classification loss.

The port of ``ComputeLoss``, ``ComputeSegmentLoss`` and their helpers from
``yolov5_tpu/train/loss.py`` (the reference's utils/loss.py:101-183 and
utils/segment/loss.py):
- box: mean(1 - CIoU) over assigned candidates;
- obj: BCE of every cell's objectness logit against tobj, which holds the
  detached CIoU at assigned cells (gr = 1), per-level balance BALANCE;
- cls: one-vs-all BCE with label smoothing, only when nc > 1;
- seg (``ComputeSegmentLoss``): per assigned candidate, BCE of
  coeff·proto against its GT instance mask, cropped to the GT box in mask
  pixels and divided by the box's area, averaged over the candidates and
  scaled by the box gain; at most ``seg_k`` candidates per level (the
  active ones first, a stable sort of the 0/1 mask as ``lax.top_k``), the
  rest counted in ``seg_overflow``;
- the total is scaled by the batch size (the reference's ``loss * bs``);
- ``classification_loss``: cross entropy with label smoothing, in float32.
Every reduction is a masked mean over the fixed lattice of
``train.assigner``, so the loss has static shapes and no host sync.

The loss runs in float32 on the head maps, whatever their dtype (bf16 under
autocast). Where several candidates claim one cell, the obj target keeps the
largest IoU (a scatter-max, as the JAX package does); the reference's serial
write keeps the last one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolov5_tpu_torch.ops.boxes import bbox_iou, smooth_bce
from yolov5_tpu_torch.ops.masks import crop_mask
from yolov5_tpu_torch.train.assigner import build_targets_level

# per-level objectness balance (reference loss.py:119-121)
BALANCE = {3: (4.0, 1.0, 0.4), 4: (4.0, 1.0, 0.25, 0.06), 5: (4.0, 1.0, 0.25, 0.06, 0.02)}


def bce_with_logits(x, z, pos_weight=1.0):
    """Binary cross-entropy with logits and pos_weight, elementwise (torch
    ``BCEWithLogitsLoss`` semantics)."""
    return -(pos_weight * z * F.logsigmoid(x) + (1.0 - z) * F.logsigmoid(-x))


def focal_scale(x, z, gamma=1.5, alpha=0.25):
    """Focal modulation factors for BCE terms (reference loss.py:36-57)."""
    p = torch.sigmoid(x)
    p_t = z * p + (1 - z) * (1 - p)
    alpha_t = z * alpha + (1 - z) * (1 - alpha)
    return alpha_t * (1.0 - p_t) ** gamma


def qfocal_scale(x, z, gamma=1.5, alpha=0.25):
    """Quality-focal modulation (reference QFocalLoss, loss.py:76-98):
    |z - sigmoid(x)|^gamma, so soft targets act as quality scores."""
    p = torch.sigmoid(x)
    alpha_t = z * alpha + (1 - z) * (1 - alpha)
    return alpha_t * (z - p).abs() ** gamma


def bce_blur_with_logits(x, z, alpha=0.05, pos_weight=1.0):
    """BCE that fades the penalty of confident false positives (the
    reference's BCEBlurWithLogitsLoss, loss.py:11-33)."""
    loss = bce_with_logits(x, z, pos_weight)
    dx = torch.sigmoid(x) - z
    return loss * (1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4)))


def masked_mean(x, mask, eps=1e-9):
    return (x * mask).sum() / (mask.sum() + eps)


class ComputeLoss:
    """Detection loss. ``anchors_per_stride`` (nl, na, 2) anchors in stride
    units; ``hyp`` the gains (box/obj/cls, *_pw, label_smoothing, fl_gamma,
    fl_type, anchor_t), already scaled by ``trainer.scale_hyp``; ``gain``
    multiplies the total (4 for quad batches)."""

    def __init__(self, anchors_per_stride, nc, hyp, nl=None, gain=1.0):
        self.anchors = tuple(tuple(map(tuple, a)) for a in anchors_per_stride)
        self.nc = nc
        self.hyp = dict(hyp)
        self.nl = nl or len(self.anchors)
        self.balance = BALANCE.get(self.nl, (4.0, 1.0, 0.4))
        self.cp, self.cn = smooth_bce(self.hyp.get("label_smoothing", 0.0))
        self.gain = gain

    def __call__(self, raw_maps, targets, valid):
        """raw_maps: list of (bs, ny, nx, na, no) logits; targets (bs, M, 5)
        [cls, x, y, w, h] normalized; valid (bs, M) bool. Returns (total,
        {"box", "obj", "cls"}), all float32 scalars on the maps' device."""
        hyp = self.hyp
        bs = raw_maps[0].shape[0]
        dev = raw_maps[0].device
        targets = targets.float()
        lbox = torch.zeros((), device=dev)
        lobj = torch.zeros((), device=dev)
        lcls = torch.zeros((), device=dev)
        fl_gamma = hyp.get("fl_gamma", 0.0)
        fscale = qfocal_scale if hyp.get("fl_type") == "qfocal" else focal_scale

        for i, pred in enumerate(raw_maps):
            _, ny, nx, na, no = pred.shape
            anchors = torch.tensor(self.anchors[i], dtype=torch.float32, device=dev)
            asn = build_targets_level(targets, valid, anchors, ny, nx,
                                      hyp.get("anchor_t", 4.0))
            m_flat = asn["mask"].reshape(bs, -1).float()  # (bs, C)
            a_flat = asn["a"].reshape(bs, -1)
            # candidate -> flat (cell, anchor) index of the (bs, ny*nx*na, no) map
            lin = ((asn["gj"] * nx + asn["gi"]) * na + asn["a"]).reshape(bs, -1)
            cells = pred.float().reshape(bs, ny * nx * na, no)
            p = cells.gather(1, lin[..., None].expand(-1, -1, no))  # (bs, C, no)

            # box regression
            pxy = torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 * anchors[a_flat]
            pbox = torch.cat([pxy, pwh], -1)
            tbox = asn["tbox"].reshape(bs, -1, 4)
            # padded candidates have w = h = 0, which makes CIoU NaN; give them
            # a unit box (their mask weight is 0)
            safe = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
            tbox = torch.where(m_flat[..., None] > 0, tbox, safe)
            iou = bbox_iou(pbox, tbox, xywh=True, CIoU=True).squeeze(-1)  # (bs, C)
            lbox = lbox + masked_mean(1.0 - iou, m_flat)

            # objectness target: the detached IoU at assigned cells, max-combined
            iou_d = iou.detach().clamp(min=0.0) * m_flat
            tobj = torch.zeros((bs, ny * nx * na), device=dev)
            tobj = tobj.scatter_reduce(1, lin, iou_d, reduce="amax", include_self=True)
            pobj = cells[..., 4]
            obj_bce = bce_with_logits(pobj, tobj, hyp.get("obj_pw", 1.0))
            if fl_gamma > 0:
                obj_bce = obj_bce * fscale(pobj, tobj, fl_gamma)
            lobj = lobj + obj_bce.mean() * self.balance[i]

            # classification (one-vs-all BCE), only when multi-class
            if self.nc > 1:
                # a comparison, not F.one_hot: no range check, so no host sync
                onehot = (asn["tcls"].reshape(bs, -1, 1)
                          == torch.arange(self.nc, device=dev)).float()
                tcls = onehot * (self.cp - self.cn) + self.cn
                pcls = p[..., 5:5 + self.nc]
                cls_bce = bce_with_logits(pcls, tcls, hyp.get("cls_pw", 1.0))
                if fl_gamma > 0:
                    cls_bce = cls_bce * fscale(pcls, tcls, fl_gamma)
                lcls = lcls + masked_mean(cls_bce.mean(-1), m_flat)

        lbox = lbox * hyp.get("box", 0.05)
        lobj = lobj * hyp.get("obj", 1.0)
        lcls = lcls * hyp.get("cls", 0.5)
        total = (lbox + lobj + lcls) * bs * self.gain
        return total, {"box": lbox, "obj": lobj, "cls": lcls}


class ComputeSegmentLoss(ComputeLoss):
    """The detection loss plus the prototype-mask term (reference
    utils/segment/loss.py:15-195). ``nm`` mask coefficients per anchor;
    ``overlap``: the GT masks are (bs, hm, wm) index maps (label row i as
    i + 1), else (bs, M, hm, wm) 0/1; ``seg_k``: the per-level capacity of
    mask-loss candidates."""

    def __init__(self, anchors_per_stride, nc, hyp, nm=32, overlap=True, seg_k=256, **kw):
        super().__init__(anchors_per_stride, nc, hyp, **kw)
        self.nm = nm
        self.overlap = overlap
        self.seg_k = seg_k

    def __call__(self, raw, targets, valid, gt_masks=None):
        """raw: (maps, proto (bs, hm, wm, nm)) of a SegmentationModel.
        Returns (total, {"box", "obj", "cls", "seg", "seg_overflow"}), or the
        detection loss alone without ``gt_masks``."""
        raw_maps, proto = raw
        total, comps = super().__call__(raw_maps, targets, valid)
        if gt_masks is None:
            return total, comps
        hyp = self.hyp
        proto = proto.float()
        bs, hm, wm, nm = proto.shape
        dev = proto.device
        targets = targets.float()
        lseg = torch.zeros((), device=dev)
        denom = torch.zeros((), device=dev)
        overflow = torch.zeros((), device=dev)  # candidates beyond seg_k
        # GT boxes in mask pixels, xyxy (bs, M, 4)
        xywh = targets[..., 1:5]
        box_px = torch.cat([(xywh[..., 0:1] - xywh[..., 2:3] / 2) * wm,
                            (xywh[..., 1:2] - xywh[..., 3:4] / 2) * hm,
                            (xywh[..., 0:1] + xywh[..., 2:3] / 2) * wm,
                            (xywh[..., 1:2] + xywh[..., 3:4] / 2) * hm], -1)

        for i, pred in enumerate(raw_maps):
            _, ny, nx, na, no = pred.shape
            anchors = torch.tensor(self.anchors[i], dtype=torch.float32, device=dev)
            asn = build_targets_level(targets, valid, anchors, ny, nx,
                                      hyp.get("anchor_t", 4.0))
            mask = asn["mask"].reshape(bs, -1).float()
            lin = ((asn["gj"] * nx + asn["gi"]) * na + asn["a"]).reshape(bs, -1)
            m = targets.shape[1]
            tgt_row = torch.arange(m, device=dev)[None, :, None, None].expand(
                asn["mask"].shape).reshape(bs, -1)  # label row of each candidate

            # the active candidates first, cut to a fixed capacity K
            k = min(self.seg_k, mask.shape[1])
            overflow = overflow + (mask.sum(1) - k).clamp(min=0).sum()
            mask, sel = torch.sort(mask, dim=1, descending=True, stable=True)
            mask, sel = mask[:, :k], sel[:, :k]
            lin, tgt_row = lin.gather(1, sel), tgt_row.gather(1, sel)
            p = pred.reshape(bs, ny * nx * na, no).gather(
                1, lin[..., None].expand(-1, -1, no)).float()
            coeff = p[..., 5 + self.nc:]  # (bs, K, nm)

            if self.overlap:
                gmask = (gt_masks[:, None] == (tgt_row + 1)[:, :, None, None]).float()
            else:
                gmask = gt_masks.float().gather(
                    1, tgt_row[:, :, None, None].expand(-1, -1, hm, wm))
            pm = torch.einsum("bcn,bhwn->bchw", coeff, proto)
            seg_bce = bce_with_logits(pm, gmask)  # (bs, K, hm, wm)

            cand_box = box_px.gather(1, tgt_row[..., None].expand(-1, -1, 4))  # (bs, K, 4)
            area = ((cand_box[..., 2] - cand_box[..., 0])
                    * (cand_box[..., 3] - cand_box[..., 1])).clamp(min=1.0)
            cropped = crop_mask(seg_bce.reshape(-1, hm, wm), cand_box.reshape(-1, 4))
            per_cand = cropped.reshape(bs, k, hm, wm).sum((-1, -2)) / area
            lseg = lseg + (per_cand * mask).sum()
            denom = denom + mask.sum()

        lseg = lseg / denom.clamp(min=1.0) * hyp.get("box", 0.05)
        total = total + lseg * bs
        return total, dict(comps, seg=lseg, seg_overflow=overflow)


def classification_loss(logits, labels, label_smoothing=0.0):
    """Mean cross entropy in float32 against labels smoothed to
    (1 - α)·onehot + α/nc (optax ``smooth_labels``, as the JAX package's
    classify step applies it; α = 0 is plain cross entropy)."""
    logp = torch.log_softmax(logits.float(), -1)
    nc = logits.shape[-1]
    y = F.one_hot(labels.long(), nc).float()
    if label_smoothing:
        y = y * (1.0 - label_smoothing) + label_smoothing / nc
    return -(y * logp).sum(-1).mean()
