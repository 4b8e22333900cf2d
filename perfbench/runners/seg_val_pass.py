"""Traffic kind ``seg_val_pass``: instance-segmentation validation, whole
passes with box and mask mAP, as ``segment val`` runs it.

Set-up writes ``images`` seeded 24-bit BMPs of the traffic's ``shapes`` (long
side ``imgsz``, equal numbers of each, in a seeded order) under the run's
TMPDIR, draws and calibrates the weights (``core/segment_weights.py``) on the
first batch's letterboxed images, and writes each image's polygon labels:
as many as a seeded draw from ``labels_per_image``, each one of the image's
best detections by the plain reference's float32 forward (single-label NMS
at the traffic's thresholds), its polygon the outer border (OpenCV's
``findContours``, every border pixel, the largest by area) of the
reference's own float32 mask for that detection, cut to the image, in the
image's own pixels, at most ``vertices`` of its pixels evenly spaced along
it (an assumption: a hand-drawn polygon of a COCO-style label holds tens of
vertices, where a mask's pixel border holds hundreds to thousands); a detection
whose mask is not mostly in one part, leaves no border of 16 px² and 2 px
a side, or whose border's box another label of the image has, is passed
over. So the program's detections and masks meet their labels, and both
mAPs read above 0. The window runs whole passes of ``train.run_segment.evaluate_segment``
with ``infer_segment.Segmenter.forward`` (bfloat16 with ``half``, BN
folded) over ``create_loader(..., masks=True)``: the square loader
(letterbox to imgsz², GT masks rasterized at imgsz / mask_ratio in the
overlap form), the forward, multi-label NMS carrying the mask coefficients
(K1 at its default cap of 30 720), the mask IoUs at image resolution, box
and mask matching and AP. ``val_img_s`` is the images of the passes over
the window.

The comparison covers each layer of the last pass, with what the pass
produced captured where ``evaluate_segment`` takes it: the loader's batches
(the loader wrapped as ``val_pass.TimedLoader``), the prototypes
(``Segmenter.forward``, wrapped on the instance), the detections
(``detections_to_numpy``) and the mask IoUs with their GT masks
(``_mask_ious``), those two wrapped in ``run_segment``'s namespace:

  - ``loader_diff``: the batches' letterboxed images against the
    reference's letterbox of the same files, the largest difference of a
    pixel (exact: 0);
  - ``gtmask_diff``: the GT masks ``_mask_ious`` was given against the
    reference's rasterization of the label files' polygons, the pixels that
    differ over the pass (exact: 0);
  - ``det_gap.p50``: the detections against the reference's float32 forward
    and NMS of the same inputs (``compare.detection_distances``), the
    median of the images' gaps, as the val cell reads it;
  - ``coef_gap.p50`` and ``coef_gap.far``: each returned detection's 32
    mask coefficients against the reference's decoded coefficients of the
    raw row nearest to it (score and place, as ``detection_distances``
    finds it), the norm of the difference over the spread of those rows'
    coefficients about their mean (a bias shared by every row makes up
    most of each row's norm, so a norm of its own hides a row taken for
    another); the median over the pass's detections, and the share farther
    than ``FAR`` per thousand: the Segment convs' precision on every
    level, and the coefficients' path through the decode, the sort, K1
    and the compaction;
  - ``proto_gap``: the prototypes against the reference's float32 ones of
    the same inputs, the norm of the difference over the reference's norm,
    over the pass;
  - ``mask_gap.mean``: the mask IoUs the pass computed against the
    reference's IoUs of the same detections (boxes, coefficients) over the
    pass's own prototypes and the reference's GT masks, the mean absolute
    difference over the pairs that either side puts at 0.5 or more (those
    that can match): the mask assembly, GT resize and IoU, apart from the
    forward's precision;
  - ``map_recomputed_gap.box`` and ``.mask``: the pass's box and mask
    mAP50-95 against the reference's matching and AP over the pass's own
    detections, labels and mask IoUs (exact: 0).

Parameters (the traffic file): batch, images, shapes, imgsz, half,
labels_per_image, vertices, conf_thres, iou_thres, max_det, max_nms,
cand_per_img, workers, mask_ratio, overlap (the overlap form only).
"""

from __future__ import annotations

import contextlib
import gc
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench.core import compare, data, flops, segment_flops, segment_weights, stats, trace
from perfbench.reference import metrics as ref_metrics
from perfbench.reference import segment, yolo
from perfbench.reference.nms import xywh2xyxy
from perfbench.runners import val_pass

IOUV = val_pass.IOUV
MIN_AREA = 16.0  # px², of a label's border
ONE_PART = 0.8  # the least share of a label's mask inside its largest border
MATCHABLE = 0.5  # the lowest IoU threshold of the matching
FAR = 0.5  # a detection's coefficients this far from the reference's are wrong


@contextlib.contextmanager
def capture(seg):
    """What ``evaluate_segment`` takes from ``seg.forward`` (the prototypes)
    and ``detections_to_numpy``, and gives to and gets from ``_mask_ious``,
    kept per batch as it happens."""
    from yolov5_tpu_torch.train import run_segment

    kept = {"protos": [], "dets": [], "masks": []}
    inner_dets, inner_masks = run_segment.detections_to_numpy, run_segment._mask_ious
    inner_forward = seg.forward

    def forward(images):
        preds, proto = inner_forward(images)
        kept["protos"].append(proto)
        return preds, proto

    def dets(d):
        rows = inner_dets(d)
        kept["dets"].append(rows)
        return rows

    def masks(proto, d, gt_masks, n_pred, n_gt, s, overlap):
        ious = inner_masks(proto, d, gt_masks, n_pred, n_gt, s, overlap)
        kept["masks"].append({"ious": ious, "gt": gt_masks, "n_pred": list(n_pred),
                              "n_gt": list(n_gt)})
        return ious

    seg.forward = forward  # the instance's, in front of the method
    run_segment.detections_to_numpy, run_segment._mask_ious = dets, masks
    try:
        yield kept
    finally:
        del seg.forward
        run_segment.detections_to_numpy, run_segment._mask_ious = inner_dets, inner_masks


class Runner(val_pass.Runner):
    def __init__(self, ctx):
        super().__init__(ctx)
        if not self.t["overlap"]:
            raise ValueError("seg_val_pass: the reference rasterizes the overlap form only")
        self.nm = segment.segment_row(self.cfg)[2]
        s = self.t["imgsz"]
        self.hm = s // self.t["mask_ratio"]

    # -- set-up -------------------------------------------------------------
    def prepare(self):
        t = self.t
        rng = np.random.default_rng(self.ctx.seed)
        n, shapes = t["images"], [tuple(s) for s in t["shapes"]]
        per = n // len(shapes)
        kinds = rng.permutation(np.repeat(np.arange(len(shapes)), per))
        gen = data.generator(2 * self.ctx.seed + 1, self.device)  # apart from the weights'
        ims = {k: data.frames(gen, per, *shapes[k]).cpu().numpy() for k in range(len(shapes))}
        seen = dict.fromkeys(range(len(shapes)), 0)
        self.images = []
        for k in kinds:
            self.images.append(ims[k][seen[k]])
            seen[k] += 1
        self.shapes = np.asarray([im.shape[:2] for im in self.images], np.int64)
        self.root = Path(tempfile.mkdtemp(prefix="perfbench-segval-"))
        (self.root / "images").mkdir()
        (self.root / "labels").mkdir()
        for i, im in enumerate(self.images):
            data.write_bmp(self.root / "images" / f"{i:05d}.bmp", im)
        s = t["imgsz"]
        self.order = np.arange(len(self.images))  # the square loader's: file order
        self.batch_hw = [(s, s)] * math.ceil(len(self.images) / t["batch"])
        calib = torch.from_numpy(self.letterboxed(self.order[:t["batch"]], (s, s)))
        self.sd, measured, delta, fill, shift = segment_weights.calibrated(
            self.cfg, self.ctx.seed, [calib.to(self.device)], t["conf_thres"], t["cand_per_img"],
            self.device, {k: t[k] for k in ("iou_thres", "max_nms")})
        self.ctx.note(candidates_per_image=measured, objectness_shift=delta, mask_fill=fill,
                      coefficient_shift=shift)
        lo, hi = t["labels_per_image"]
        self.write_labels(rng.integers(lo, hi + 1, len(self.images)), t["max_det"])
        self.ctx.note(labels_per_image=float(np.mean([len(c) for c in self.label_cls])))

    @torch.no_grad()
    def write_labels(self, counts, candidates):
        """Image i's label file: ``counts[i]`` polygons, each the outer border
        of the reference's float32 mask of one of its best ``candidates``
        detections (single-label NMS), in score order."""
        t = self.t
        s = t["imgsz"]
        model = segment.Model(self.cfg, self.sd)
        self.label_cls = [None] * len(self.images)
        self.polygons = [None] * len(self.images)
        with compare.plain_float32():
            for bi, hw in enumerate(self.batch_hw):
                idx = self.order[bi * t["batch"]:(bi + 1) * t["batch"]]
                x = torch.from_numpy(self.letterboxed(idx, hw)).to(self.device)
                maps, protos = model(x.permute(0, 3, 1, 2).float().div(255.0).contiguous())
                pred, coeffs = segment.decode(maps, self.cfg)
                rows = segment.nms(pred, coeffs, t["conf_thres"], t["iou_thres"], candidates,
                                   t["max_nms"], multi_label=False)
                for b, i in enumerate(idx):
                    lines = self.image_labels(protos[b], rows[b], i, int(counts[i]))
                    path = self.root / "labels" / f"{i:05d}.txt"
                    path.write_text("".join(lines))
                    self.label_cls[i], self.polygons[i] = segment.read_polygons(path)

    def image_labels(self, protos, rows, i, count, chunk=32):
        """Up to ``count`` label lines of image i from its detections ``rows``
        in score order: a detection's mask, cut to the image, gives its
        largest outer border, kept where that border's fill holds most of
        the mask (a mask in one part) and its polygon of at most ``vertices`` points has
        MIN_AREA px², 2 px a side and a box no kept label has."""
        import cv2

        s = self.t["imgsz"]
        h0, w0 = (int(v) for v in self.shapes[i])
        top, left = data.pads(h0, w0, s, s)
        lines, boxes = [], set()
        for j0 in range(0, len(rows), chunk):
            r = torch.from_numpy(rows[j0:j0 + chunk]).to(self.device)
            m = segment.process_mask(protos, r[:, -self.nm:], r[:, :4], (s, s)) > 0.5
            m = m[:, top:top + h0, left:left + w0].to(torch.uint8).cpu().numpy()
            for j in range(len(r)):
                if len(lines) == count:
                    return lines
                found, _ = cv2.findContours(m[j], cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
                if not found:
                    continue
                c = max(found, key=cv2.contourArea)
                xy = along(c.reshape(-1, 2), self.t["vertices"])
                box = (*xy.min(0), *xy.max(0))
                if (len(xy) < 3 or cv2.contourArea(c) < MIN_AREA or box in boxes
                        or box[2] - box[0] < 2 or box[3] - box[1] < 2):
                    continue
                fill = cv2.drawContours(np.zeros_like(m[j]), [c], -1, 1, cv2.FILLED)
                if (fill & m[j]).sum() < ONE_PART * m[j].sum() or cv2.contourArea(xy) < MIN_AREA:
                    continue
                boxes.add(box)
                xy = xy.astype(np.float64) / np.array([w0, h0])
                lines.append(f"{int(rows[j0 + j, 5])} "
                             + " ".join(f"{v:.6f}" for v in xy.reshape(-1)) + "\n")
        return lines

    def letterbox_polygons(self, i):
        """Image i's label polygons in the letterboxed input's pixels, with
        the loader's float32 arithmetic (normalised · size + pad)."""
        s = self.t["imgsz"]
        h0, w0 = (int(v) for v in self.shapes[i])
        dw, dh = (s - w0) / 2, (s - h0) / 2  # letterbox's pad, unrounded
        out = []
        for p in self.polygons[i]:
            q = p.copy()
            q[:, 0] = q[:, 0] * float(w0) + dw
            q[:, 1] = q[:, 1] * float(h0) + dh
            out.append(q)
        return out

    def gt_map(self, i) -> np.ndarray:
        return segment.polygons_to_overlap_mask(self.letterbox_polygons(i), self.t["imgsz"],
                                                self.hm, self.hm)

    def program(self):
        from yolov5_tpu_torch.data.dataset import create_loader
        from yolov5_tpu_torch.infer_segment import Segmenter

        t = self.t
        seg = Segmenter(self.sd, cfg=self.ctx.cell.config["yaml"], device=self.device,
                        half=t["half"])
        _, loader = create_loader(str(self.root / "images"), img_size=t["imgsz"],
                                  batch_size=t["batch"], workers=t["workers"], masks=True,
                                  mask_ratio=t["mask_ratio"], overlap=t["overlap"])
        return seg, val_pass.TimedLoader(loader)

    def one_pass(self, prog):
        """The timed call: one whole validation pass, as ``segment val``."""
        from yolov5_tpu_torch.train.run_segment import evaluate_segment

        seg, loader = prog
        t = self.t
        return evaluate_segment(seg.forward, loader, self.device, seg.nc,
                                conf_thres=t["conf_thres"], iou_thres=t["iou_thres"],
                                max_det=t["max_det"], overlap=t["overlap"])

    # -- measurement ----------------------------------------------------------
    def window(self, prog, seconds):
        """Run the window; returns (Window, the last pass: its box and mask
        mAP50-95, its batches, prototypes, detections and mask IoUs)."""
        w = stats.Window(time.perf_counter, seconds)
        with capture(prog[0]) as kept:
            while True:
                for v in kept.values():
                    v.clear()
                res = self.one_pass(prog)
                if w.done(res["images"]):
                    return w, {"box_map": res["box"]["map"], "mask_map": res["mask"]["map"],
                               "batches": list(prog[1].batches),
                               **{k: list(v) for k, v in kept.items()}}

    def traced(self, prog):
        """A traced pass, and the least time of each of its batches' mask
        stage (from the images whose masks it assembled)."""
        with capture(prog[0]) as kept:
            got = trace.profile(lambda: self.one_pass(prog))
        s, pb = self.t["imgsz"], 2 if self.t["half"] else 4
        bounds = [segment_flops.mask_stage_bound_s(
            [(n, g) for n, g in zip(m["n_pred"], m["n_gt"]) if n and g], s, self.hm, self.hm,
            self.nm, pb) for m in kept["masks"]]
        return got, bounds

    def pass_flops(self) -> float:
        s = self.t["imgsz"]
        return len(self.images) * segment_flops.model_flops(self.cfg, s, s)

    # -- the comparison --------------------------------------------------------
    def reference(self, precision="f32"):
        """Per batch: the reference's letterboxed input, decoded predictions
        and coefficients, detections (with their coefficients), prototypes,
        GT maps, and (candidates, keep slots, IoUs of the walk) for K1's
        bound."""
        t = self.t
        model = segment.Model(self.cfg, self.sd, precision)
        out = []
        with compare.plain_float32():
            for bi, hw in enumerate(self.batch_hw):
                idx = self.order[bi * t["batch"]:(bi + 1) * t["batch"]]
                ims = self.letterboxed(idx, hw)
                x = torch.from_numpy(ims).to(self.device).permute(0, 3, 1, 2).float().div(255.0)
                maps, protos = model(x.contiguous())
                pred, coeffs = segment.decode(maps, self.cfg)
                rows, cands, ious = segment.nms(pred, coeffs, t["conf_thres"], t["iou_thres"],
                                                t["max_det"], t["max_nms"], multi_label=True,
                                                with_counts=True)
                slots = len(idx) * min(t["max_nms"], pred.shape[1] * (pred.shape[2] - 5))
                gt = torch.from_numpy(np.stack([self.gt_map(i) for i in idx])).to(self.device)
                out.append({"idx": idx, "images": ims, "pred": pred, "coeffs": coeffs,
                            "rows": rows, "protos": protos, "gt": gt,
                            "k1": (int(cands.sum()), slots, int(ious.sum()))})
        return out

    def labels_at(self, i) -> np.ndarray:
        """Image i's labels as the loader normalises them to the input:
        (n, 5) [cls, x, y, w, h] of each polygon's box."""
        s = self.t["imgsz"]
        rows = []
        for c, p in zip(self.label_cls[i], self.letterbox_polygons(i)):
            (x1, y1), (x2, y2) = p.min(0), p.max(0)
            rows.append([c, (x1 + x2) / 2 / s, (y1 + y2) / 2 / s, (x2 - x1) / s, (y2 - y1) / s])
        return np.asarray(rows, np.float32).reshape(-1, 5)

    def control_outputs(self, precision="fp8"):
        """The reference at ``precision`` in the program's place: its own
        letterbox, labels, detections, GT masks and mask IoUs, and its mAPs
        by its own matching."""
        s = self.t["imgsz"]
        ref = self.reference(precision)
        batches, protos, dets, masks = [], [], [], []
        for r in ref:
            n_pred = [len(x) for x in r["rows"]]
            n_gt = [len(self.label_cls[i]) for i in r["idx"]]
            ious = np.zeros((len(r["idx"]), max(n_gt), max(n_pred)), np.float32)
            for b, (n, g) in enumerate(zip(n_pred, n_gt)):
                if n and g:
                    ious[b, :g, :n] = segment.image_mask_ious(
                        r["protos"][b], r["rows"][b], r["gt"][b], g, (s, s), self.nm).cpu().numpy()
            labs = [self.labels_at(i) for i in r["idx"]]
            targets = np.zeros((len(labs), max(n_gt), 5), np.float32)
            valid = np.zeros((len(labs), max(n_gt)), bool)
            for b, lab in enumerate(labs):
                targets[b, :len(lab)], valid[b, :len(lab)] = lab, True
            batches.append({"images": r["images"], "indices": r["idx"], "real": len(r["idx"]),
                            "targets": targets, "valid": valid})
            protos.append(r["protos"].permute(0, 2, 3, 1))  # the program's layout
            dets.append(r["rows"])
            masks.append({"ious": ious, "gt": r["gt"], "n_pred": n_pred, "n_gt": n_gt})
        box_map, mask_map = self.mean_aps(batches, dets, masks)
        return {"box_map": box_map, "mask_map": mask_map, "batches": batches, "protos": protos,
                "dets": dets, "masks": masks}

    def mean_aps(self, batches, dets, masks):
        """Box and mask mAP50-95 of a pass's detections against its labels
        (in the input's pixels), masks matched on the pass's IoUs; the mean
        over classes and thresholds, as segment/val.py's Metric.map."""
        s = self.t["imgsz"]
        st_box, st_mask = [], []
        for batch, rows, m in zip(batches, dets, masks):
            for b in range(int(batch["real"])):
                pred = rows[b][:, :6]
                lab = ref_metrics.xywhn_to_xyxy(batch["targets"][b][batch["valid"][b]], s, s)
                st_box.append((ref_metrics.process_batch(pred, lab, IOUV), pred[:, 4], pred[:, 5],
                               lab[:, 0]))
                n, g = len(pred), len(lab)
                correct = (segment.match(m["ious"][b, :g, :n], lab[:, 0], pred[:, 5], IOUV)
                           if n and g else np.zeros((n, len(IOUV)), bool))
                st_mask.append((correct, pred[:, 4], pred[:, 5], lab[:, 0]))
        return _map(st_box), _map(st_mask)

    def readings(self, out, ref) -> dict:
        t = self.t
        s = t["imgsz"]
        by_first = {int(r["idx"][0]): r for r in ref}
        strides = yolo.row_strides(segment.detect_view(self.cfg), s, s, self.device)
        loader_diff, gt_diff, gaps, mask_gaps, sq_err, sq_ref = 0, 0, [], [], 0.0, 0.0
        coef_errs = []
        with compare.plain_float32():
            for batch, protos, rows, m in zip(out["batches"], out["protos"], out["dets"],
                                              out["masks"]):
                real = int(batch["real"])
                r = by_first.get(int(batch["indices"][0]))
                if (r is None or batch["images"].shape[1:3] != r["images"].shape[1:3]
                        or [int(i) for i in batch["indices"][:real]] != [int(i) for i in r["idx"]]):
                    return {"loader_diff": 255.0}  # another batching than the reference's
                d = np.abs(batch["images"][:real].astype(np.int16) - r["images"].astype(np.int16))
                loader_diff = max(loader_diff, int(d.max()))
                gt_diff += int((torch.as_tensor(m["gt"]).to(self.device)[:real] != r["gt"]).sum())
                gaps += compare.detection_distances(rows[:real], r["pred"], r["rows"], strides,
                                                    t["conf_thres"], t["iou_thres"],
                                                    t["max_det"])
                coef_errs += [coefficient_errors(rows[b], r["pred"][b], r["coeffs"][b], strides,
                                                 self.nm) for b in range(real)]
                p = protos[:real].to(self.device).permute(0, 3, 1, 2).float()
                sq_err += float(((p - r["protos"]) ** 2).sum())
                sq_ref += float((r["protos"] ** 2).sum())
                for b, i in enumerate(r["idx"]):
                    n, g = m["n_pred"][b], m["n_gt"][b]
                    if g != len(self.label_cls[i]):
                        mask_gaps.append(np.ones(1))  # labels lost or gained
                    elif n and g:
                        mine = m["ious"][b, :g, :n]
                        theirs = segment.image_mask_ious(p[b], rows[b], r["gt"][b], g, (s, s),
                                                         self.nm).cpu().numpy()
                        near = np.maximum(mine, theirs) >= MATCHABLE
                        mask_gaps.append(np.abs(mine - theirs)[near])
        box_map, mask_map = self.mean_aps(out["batches"], out["dets"], out["masks"])
        mg = np.concatenate(mask_gaps + [np.zeros(0)])
        ce = np.concatenate(coef_errs + [np.zeros((0, 1 + self.nm))])
        theirs = ce[:, 1:]  # a bias shared by every row dominates them: their spread is the scale
        spread = math.sqrt(((theirs - theirs.mean(0)) ** 2).sum(1).mean()) if len(ce) else 1.0
        res = {"loader_diff": float(loader_diff), "gtmask_diff": float(gt_diff),
               "proto_gap": math.sqrt(sq_err / max(sq_ref, 1e-30)),
               "mask_gap.mean": float(mg.mean()) if len(mg) else 0.0,
               "mask_gap.max": float(mg.max()) if len(mg) else 0.0,
               "mask_gap.pairs": float(len(mg)),
               **_coef_stats(ce[:, 0] / max(spread, 1e-30)),
               "map.box": out["box_map"], "map.mask": out["mask_map"],
               "map_recomputed_gap.box": abs(out["box_map"] - box_map),
               "map_recomputed_gap.mask": abs(out["mask_map"] - mask_map)}
        res.update(compare.gap_stats("det_gap", gaps))
        return res


def coefficient_errors(rows, pred, coeffs, row_stride, nm: int, chunk: int = 64) -> np.ndarray:
    """An image's returned detections ``rows`` ((n, 6 + ...) [x1, y1, x2, y2,
    score, class, ..., nm coefficients]) against the reference's decoded
    ``pred`` (N, 5 + nc) and ``coeffs`` (N, nm): for each detection, the raw
    row nearest to it (the larger of the log-score gap of its class and the
    place term, ``compare.detection_distances``' distance), and the norm of
    its coefficients' difference from that row's: (n, 1 + nm) [norm of the
    difference, the row's coefficients]."""
    if not len(rows):
        return np.zeros((0, 1 + nm))
    dev = pred.device
    p = torch.as_tensor(np.asarray(rows, np.float32), device=dev)
    scores = compare._log(pred[:, 5:] * pred[:, 4:5])  # (N, nc)
    boxes = xywh2xyxy(pred[:, :4])
    scale = pred[:, 2:4].amax(-1) + row_stride
    out = []
    for q in p.split(chunk):
        d = torch.maximum((scores[:, q[:, 5].long()].T - compare._log(q[:, 4:5])).abs(),
                          compare._place(q[:, :4], boxes, scale))
        theirs = coeffs[d.argmin(1)].float()
        out.append(torch.cat([(q[:, -nm:] - theirs).norm(dim=1, keepdim=True), theirs], 1))
    return torch.cat(out).cpu().numpy().astype(np.float64)


def along(border: np.ndarray, k: int) -> np.ndarray:
    """At most ``k`` points of a closed border (its (n, 2) pixels in order),
    evenly spaced by arc length from its first point."""
    if len(border) <= k:
        return border
    closed = np.concatenate([border, border[:1]]).astype(np.float64)
    arc = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(closed, axis=0), axis=1))])
    at = np.searchsorted(arc, np.arange(k) * arc[-1] / k)
    return border[np.unique(np.minimum(at, len(border) - 1))]


def _coef_stats(v: np.ndarray) -> dict:
    """``coef_gap``'s median, 90th percentile and share over ``FAR`` (per
    thousand) of the detections' distances ``v``."""
    if not len(v):
        return {"coef_gap.p50": 0.0, "coef_gap.p90": 0.0, "coef_gap.far": 0.0}
    return {"coef_gap.p50": float(np.median(v)), "coef_gap.p90": float(np.quantile(v, 0.9)),
            "coef_gap.far": 1000.0 * float((v > FAR).mean())}


def _map(stats_) -> float:
    """mAP50-95 of [(correct, conf, pred_cls, target_cls)]: the mean of
    ``ap_per_class``'s (classes, thresholds) APs."""
    tp, conf, pred_cls, target_cls = (np.concatenate([x[i] for x in stats_]) for i in range(4))
    if not (tp.shape[0] and target_cls.shape[0]):
        return 0.0
    return float(ref_metrics.ap_per_class(tp, conf, pred_cls, target_cls)["ap"].mean())


def run(ctx) -> dict:
    d = Runner(ctx)
    try:
        d.prepare()
        if d.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(d.device)
        prog = d.program()
        d.warm(prog)
        setup_s = time.perf_counter() - ctx.t_start
        w, out = d.window(prog, ctx.seconds)
        peak = torch.cuda.max_memory_allocated(d.device) if d.device.type == "cuda" else 0
        traced, bounds = d.traced(prog) if ctx.trace else (None, None)
        if ctx.trace:
            from perfbench.core.program_spans import recorded

            ctx.note(segval_masks_counts=[sp.counts["masks"] for sp in recorded()
                                          if sp.name == "segval.masks"])
        del prog
        gc.collect()
        if d.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = d.reference()
        readings = d.readings(out, ref)
        ctx.note(readings=readings)
        ctx.note(window_passes=w.events, window_s=w.elapsed, thirds=w.thirds(),
                 map_box=out["box_map"], map_mask=out["mask_map"])
        return {
            "attempted": w.units, "failed": 0,
            "metrics": {"val_img_s": w.rate, "setup_s": setup_s},
            "memory_peak_bytes": peak,
            "readings": readings,
            "trace": traced,
            "layer": {
                "flops_per_s": w.events * d.pass_flops() / w.elapsed,
                "mask_bounds_s": bounds,
                "nms_bounds_s": [flops.nms_bound_s(*r["k1"]) for r in ref],
            },
        }
    finally:
        d.close()
