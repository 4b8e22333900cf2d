"""Traffic kind ``val_pass``: standalone validation, whole passes with mAP.

Set-up writes ``images`` seeded 24-bit BMPs of the traffic's ``shapes``
(long side ``imgsz``, equal numbers of each, in a seeded order) under the
run's TMPDIR. Each image's labels are its best detections by the plain
reference's float32 forward (single-label NMS at the traffic's thresholds),
as many as a seeded draw from ``labels_per_image`` (a range), so that the
program's detections match them and the pass's mAP reads well above 0. The
window runs whole passes of the port's ``eval.evaluator.evaluate`` over its
rect ``Loader`` (aspect-sorted batches of ``batch``) with
``infer.Detector.forward``: forward, multi-label NMS (K1 at ``max_nms``),
host matching and mAP. ``val_img_s`` is the images of the passes over the
window.

The comparison covers each layer of the last pass, as the pass produced it:

  - ``loader_diff``: the loader's letterboxed batches against the
    reference's own letterbox of the same files (yolov5's rect batching with
    the port's size buckets), the largest difference of a pixel (exact: 0);
  - ``det_gap.p50``: the detections each batch's NMS returned (read where
    ``evaluate`` takes them to the host) against the plain reference's
    float32 forward and NMS of the same inputs (``compare.detection_gaps``);
  - ``map_recomputed_gap``: the pass's mAP50-95 against the reference's
    matching and AP over those same detections and the label files (exact).

Parameters (the traffic file): batch, images, shapes, imgsz, half,
labels_per_image, conf_thres, iou_thres, max_det, max_nms, cand_per_img.
"""

from __future__ import annotations

import contextlib
import gc
import math
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench.core import compare, data, flops, stats, trace, weights
from perfbench.reference import metrics as ref_metrics
from perfbench.reference import nms as ref_nms
from perfbench.reference import yolo

IOUV = np.linspace(0.5, 0.95, 10)


def rect_shapes(shapes, batch_size, img_size, stride=32, pad=0.5):
    """yolov5's rect batching (utils/dataloaders.py: sort by h/w, the smallest
    stride-aligned (h, w) that fits each batch), each side then snapped up
    to the port loader's sizes (stride·4, stride·6, ..., img_size):
    (order, [(h, w)] per batch of that order)."""
    buckets = sorted(set(range(stride * 4, img_size, stride * 2)) | {img_size})
    ar = shapes[:, 0] / np.maximum(shapes[:, 1], 1)
    order = np.argsort(ar)
    out = []
    for bi in range(math.ceil(len(shapes) / batch_size)):
        a = ar[order[bi * batch_size:(bi + 1) * batch_size]]
        shape = [1.0, 1.0]
        if a.max() < 1:
            shape = [float(a.max()), 1.0]
        elif a.min() > 1:
            shape = [1.0, 1.0 / float(a.min())]
        hw = [min(int(np.ceil(v * img_size / stride + pad) * stride), img_size) for v in shape]
        out.append(tuple(min(b for b in buckets if b >= v) for v in hw))
    return order, out


class TimedLoader:
    """The port's loader as ``evaluate`` sees it, with the seconds each
    ``next()`` took and the last pass's batches (every other attribute,
    ``ds`` among them, forwarded)."""

    def __init__(self, loader):
        self._loader = loader
        self.spans = []
        self.batches = []

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        self.batches = []
        it = iter(self._loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.spans.append(time.perf_counter() - t0)
            self.batches.append(batch)
            yield batch


@contextlib.contextmanager
def capture_detections():
    """The per-batch detections ``evaluate`` takes to the host, kept as it
    receives them (``eval.evaluator.detections_to_numpy``, wrapped)."""
    from yolov5_tpu_torch.eval import evaluator

    kept = []
    inner = evaluator.detections_to_numpy

    def wrapped(dets):
        rows = inner(dets)
        kept.append(rows)
        return rows

    evaluator.detections_to_numpy = wrapped
    try:
        yield kept
    finally:
        evaluator.detections_to_numpy = inner


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.cell.traffic
        self.cfg = yolo.load_yaml(ctx.cell.config["yaml"])
        self.device = ctx.device
        self.root = None

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
        self.root = Path(tempfile.mkdtemp(prefix="perfbench-val-"))
        (self.root / "images").mkdir()
        (self.root / "labels").mkdir()
        for i, im in enumerate(self.images):
            data.write_bmp(self.root / "images" / f"{i:05d}.bmp", im)
        lo, hi = t["labels_per_image"]
        counts = rng.integers(lo, hi + 1, len(self.images))
        self.order, self.batch_hw = rect_shapes(self.shapes, t["batch"], t["imgsz"])
        # BN statistics and the objectness shift from a few images of each shape
        calib, shapes_hw = [], sorted(set(self.batch_hw))
        for hw in shapes_hw:
            bi = self.batch_hw.index(hw)
            idx = self.order[bi * t["batch"]:(bi + 1) * t["batch"]]
            idx = idx[:max(1, t["batch"] // len(shapes_hw))]
            calib.append(torch.from_numpy(self.letterboxed(idx, hw)).to(self.device))
        self.sd, measured, delta = weights.calibrated(
            self.cfg, self.ctx.seed, calib, t["conf_thres"], t["cand_per_img"], True, self.device)
        self.ctx.note(candidates_per_image=measured, objectness_shift=delta)
        self.write_labels(counts)
        self.ctx.note(labels_per_image=float(np.mean([len(lab) for lab in self.labels])))

    @torch.no_grad()
    def write_labels(self, counts):
        """Image i's label file: its ``counts[i]`` best detections by the
        reference's float32 forward (single-label NMS at the traffic's
        thresholds), in its own pixels, boxes under 2 px left out."""
        t = self.t
        model = yolo.Model(self.cfg, self.sd)
        self.labels = [None] * len(self.images)
        with compare.plain_float32():
            for bi, hw in enumerate(self.batch_hw):
                idx = self.order[bi * t["batch"]:(bi + 1) * t["batch"]]
                x = torch.from_numpy(self.letterboxed(idx, hw)).to(self.device)
                pred = yolo.decode(model(x.permute(0, 3, 1, 2).float().div(255.0).contiguous()),
                                   self.cfg)
                rows = ref_nms.nms(pred, t["conf_thres"], t["iou_thres"], int(counts.max()),
                                   t["max_nms"])
                for i, r in zip(idx, rows):
                    h0, w0 = (int(v) for v in self.shapes[i])
                    r = r[:counts[i]]
                    box = ref_metrics.scale_to_native(r[:, :4], hw, (h0, w0))
                    keep = (box[:, 2:] - box[:, :2] >= 2).all(1)
                    box = box[keep]
                    xywh = np.concatenate([(box[:, :2] + box[:, 2:]) / 2, box[:, 2:] - box[:, :2]], 1)
                    xywh /= np.array([w0, h0, w0, h0], np.float32)
                    path = self.root / "labels" / f"{i:05d}.txt"
                    data.write_labels(path, np.concatenate([r[keep, 5:6], xywh], 1))
                    self.labels[i] = data.read_labels(path)

    def letterboxed(self, idx, hw):
        """The images ``idx`` padded to ``hw`` (no resize: long side imgsz)."""
        out = np.full((len(idx), hw[0], hw[1], 3), data.PAD, np.uint8)
        for j, i in enumerate(idx):
            h0, w0 = self.shapes[i]
            top, left = data.pads(h0, w0, *hw)
            out[j, top:top + h0, left:left + w0] = self.images[i]
        return out

    def program(self):
        from yolov5_tpu_torch.data.dataset import create_loader
        from yolov5_tpu_torch.infer import Detector

        t = self.t
        det = Detector(self.sd, cfg=self.ctx.cell.config["yaml"], imgsz=t["imgsz"],
                       half=t["half"], device=self.device)
        _, loader = create_loader(str(self.root / "images"), img_size=t["imgsz"],
                                  batch_size=t["batch"], rect=True, stride=32, workers=1)
        return det, TimedLoader(loader)

    def one_pass(self, prog):
        """The timed call: one whole validation pass."""
        from yolov5_tpu_torch.eval.evaluator import evaluate

        det, loader = prog
        t = self.t
        return evaluate(det.forward, loader, self.device, conf_thres=t["conf_thres"],
                        iou_thres=t["iou_thres"], max_det=t["max_det"], max_nms=t["max_nms"],
                        multi_label=True)

    def warm(self, prog):
        self.one_pass(prog)  # every rect shape and kernel of the window

    # -- measurement ----------------------------------------------------------
    def window(self, prog, seconds):
        """Run the window; returns (Window, the last pass: its mAP50-95, its
        loader's batches and the detections evaluate took to the host)."""
        prog[1].spans.clear()
        w = stats.Window(time.perf_counter, seconds)
        with capture_detections() as kept:
            while True:
                kept.clear()
                res = self.one_pass(prog)
                if w.done(res["images"]):
                    return w, {"map": res["map"], "batches": list(prog[1].batches),
                               "dets": list(kept)}

    def traced(self, prog):
        prog[1].spans.clear()
        return trace.profile(lambda: self.one_pass(prog))

    def pass_flops(self) -> float:
        t = self.t
        return sum(min(t["batch"], t["images"] - bi * t["batch"])
                   * flops.model_flops(self.cfg, *hw) for bi, hw in enumerate(self.batch_hw))

    # -- the comparison --------------------------------------------------------
    def reference(self, precision="f32"):
        """Per batch: the reference's letterboxed input, decoded predictions,
        detections, and (candidates, keep slots, IoUs of the walk) for K1's
        bound."""
        t = self.t
        model = yolo.Model(self.cfg, self.sd, precision)
        out = []
        with compare.plain_float32():
            for bi, hw in enumerate(self.batch_hw):
                idx = self.order[bi * t["batch"]:(bi + 1) * t["batch"]]
                ims = self.letterboxed(idx, hw)
                x = torch.from_numpy(ims).to(self.device).permute(0, 3, 1, 2).float().div(255.0)
                pred = yolo.decode(model(x.contiguous()), self.cfg)
                rows, cands, ious = ref_nms.nms(pred, t["conf_thres"], t["iou_thres"], t["max_det"],
                                                t["max_nms"], multi_label=True, with_counts=True)
                slots = len(idx) * min(t["max_nms"], pred.shape[1] * (pred.shape[2] - 5))
                out.append({"idx": idx, "images": ims, "pred": pred, "rows": rows,
                            "k1": (int(cands.sum()), slots, int(ious.sum()))})
        return out

    def control_outputs(self, precision="fp8"):
        """The reference at ``precision`` in the program's place: its own
        letterbox, detections, and mAP by its own matching."""
        ref = self.reference(precision)
        batches = [{"images": r["images"], "indices": r["idx"], "real": len(r["idx"])}
                   for r in ref]
        dets = [r["rows"] for r in ref]
        return {"map": self.mean_ap(batches, dets), "batches": batches, "dets": dets}

    def mean_ap(self, batches, dets) -> float:
        """mAP50-95 of a pass's detections against the label files, matched
        in each image's own pixels, in the pass's order."""
        st = []
        for batch, rows in zip(batches, dets):
            hw = batch["images"].shape[1:3]
            for b in range(int(batch["real"])):
                i = int(batch["indices"][b])
                h0, w0 = self.shapes[i]
                pred = rows[b][:, :6].copy()
                pred[:, :4] = ref_metrics.scale_to_native(pred[:, :4], hw, (h0, w0))
                lab = ref_metrics.xywhn_to_xyxy(self.labels[i], w0, h0)
                st.append((ref_metrics.process_batch(pred, lab, IOUV), pred[:, 4], pred[:, 5],
                           lab[:, 0]))
        return ref_metrics.mean_ap(st)[1]

    def readings(self, out, ref) -> dict:
        t = self.t
        by_first = {int(r["idx"][0]): r for r in ref}
        loader_diff, gaps = 0, []
        with compare.plain_float32():
            for batch, rows in zip(out["batches"], out["dets"]):
                real = int(batch["real"])
                r = by_first.get(int(batch["indices"][0]))
                if (r is None or batch["images"].shape[1:3] != r["images"].shape[1:3]
                        or [int(i) for i in batch["indices"][:real]] != [int(i) for i in r["idx"]]):
                    return {"loader_diff": 255.0}  # another batching than the reference's
                d = np.abs(batch["images"][:real].astype(np.int16) - r["images"].astype(np.int16))
                loader_diff = max(loader_diff, int(d.max()))
                strides = yolo.row_strides(self.cfg, *r["images"].shape[1:3], self.device)
                gaps += compare.detection_distances(rows[:real], r["pred"], r["rows"], strides,
                                                    t["conf_thres"], t["iou_thres"],
                                                    t["max_det"])
        res = {"loader_diff": float(loader_diff), "map": out["map"],
               "map_recomputed_gap": abs(out["map"] - self.mean_ap(out["batches"], out["dets"]))}
        res.update(compare.gap_stats("det_gap", gaps))
        return res

    def close(self):
        if self.root is not None:
            shutil.rmtree(self.root, ignore_errors=True)


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
        load_spans = list(prog[1].spans)
        traced = d.traced(prog) if ctx.trace else None
        del prog
        gc.collect()
        if d.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = d.reference()
        readings = d.readings(out, ref)
        ctx.note(readings=readings)
        ctx.note(window_passes=w.events, window_s=w.elapsed, thirds=w.thirds(), map=out["map"])
        return {
            "attempted": w.units, "failed": 0,
            "metrics": {"val_img_s": w.rate, "setup_s": setup_s},
            "memory_peak_bytes": peak,
            "readings": readings,
            "trace": traced,
            "layer": {
                "flops_per_s": w.events * d.pass_flops() / w.elapsed,
                "nms_bounds_s": [flops.nms_bound_s(*r["k1"]) for r in ref],
                "spans": {"load": load_spans},
            },
        }
    finally:
        d.close()
