"""Traffic kind ``detect_batch``: offline detection over batches of frames.

Set-up letterboxes ``batch · pool_batches`` seeded frames of ``frame_hw``
to ``imgsz`` squares and keeps them as batches in page-locked host memory,
as a reader thread hands them to ``infer.Detector``. The window calls the
detector on one batch at a time, cycling the pool, and brings each batch's
detections to host memory (``ops.nms.detections_to_numpy``) before the
batch counts. ``detect_img_s`` is the images over the window.

The comparison: the first and the last detections of every pool batch
against the plain reference's float32 forward of the same batch
(``compare.detection_distances``): the mean of all the detections'
distances, the share of returned detections far from any of the
reference's rows, and the mean of the images' widest distances.

Parameters (the traffic file): batch, pool_batches, frame_hw, imgsz, half,
conf_thres, iou_thres, max_det, max_nms, det_per_img (the detections an image
that the objectness shift is set for), trace_batches.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.core import compare, data, flops, stats, trace, weights
from perfbench.reference import nms as ref_nms
from perfbench.reference import yolo


class Runner:
    """The cell's steps, which ``run`` and the calibration of the limits
    (``perfbench/control.py``) put together."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.cell.traffic
        self.cfg = yolo.load_yaml(ctx.cell.config["yaml"])
        self.device = ctx.device

    # -- set-up -------------------------------------------------------------
    def prepare(self):
        self.inputs()
        self.weights()

    def inputs(self):
        """The pool of letterboxed batches, drawn on the device from the seed
        and kept in page-locked host memory."""
        t = self.t
        gen = data.generator(2 * self.ctx.seed + 1, self.device)  # apart from the weights'
        bs, n = t["batch"], t["pool_batches"]
        lb = data.letterbox(data.frames(gen, bs * n, *t["frame_hw"]), t["imgsz"], t["imgsz"])
        self.calib = lb[::n][:bs].clone()  # a batch's worth from every batch
        self.batches = [lb[i * bs:(i + 1) * bs].cpu() for i in range(n)]
        if self.device.type == "cuda":
            self.batches = [b.pin_memory() for b in self.batches]

    def weights(self):
        t = self.t
        x = self.calib.to(self.device)
        nms = {k: t[k] for k in ("iou_thres", "max_det", "max_nms")}
        self.sd, measured, delta = weights.calibrated(
            self.cfg, self.ctx.seed, [x], t["conf_thres"], t["det_per_img"], False, self.device,
            nms=nms, count_batches=[b.to(self.device) for b in self.batches])
        self.ctx.note(detections_per_image_calibrated=measured, objectness_shift=delta)

    def program(self):
        from yolov5_tpu_torch.infer import Detector

        t = self.t
        return Detector(self.sd, cfg=self.ctx.cell.config["yaml"], imgsz=t["imgsz"],
                        half=t["half"], device=self.device)

    def infer(self, det, batch):
        """The timed call: detections of one batch, on the host."""
        from yolov5_tpu_torch.ops.nms import detections_to_numpy

        t = self.t
        return detections_to_numpy(det(batch, conf_thres=t["conf_thres"],
                                       iou_thres=t["iou_thres"], max_det=t["max_det"],
                                       max_nms=t["max_nms"]))

    def warm(self, det):
        for b in self.batches:  # every shape and kernel of the window, built and warm
            self.infer(det, b)

    # -- measurement ----------------------------------------------------------
    def window(self, det, seconds):
        """Run the window; returns (Window, {pool index: [first, last] rows})."""
        bs = self.t["batch"]
        seen = {}
        w = stats.Window(time.perf_counter, seconds)
        i = 0
        while True:
            j = i % len(self.batches)
            rows = self.infer(det, self.batches[j])
            seen.setdefault(j, [rows, rows])[1] = rows
            i += 1
            if w.done(bs):
                return w, seen

    def traced(self, det):
        n = self.t["trace_batches"]

        def work():
            for i in range(n):
                self.infer(det, self.batches[i % len(self.batches)])

        return trace.profile(work)

    # -- the comparison --------------------------------------------------------
    def reference(self, precision="f32"):
        """Per pool batch: the reference's decoded predictions and detections."""
        t = self.t
        model = yolo.Model(self.cfg, self.sd, precision)
        out = []
        with compare.plain_float32():
            for b in self.batches:
                x = b.to(self.device).permute(0, 3, 1, 2).float().div(255.0).contiguous()
                pred = yolo.decode(model(x), self.cfg)
                rows = ref_nms.nms(pred, t["conf_thres"], t["iou_thres"], t["max_det"],
                                   t["max_nms"])
                out.append((pred, rows))
        return out

    def control_outputs(self, precision="fp8"):
        """What the reference at ``precision`` returns in the program's place,
        as the window keeps it."""
        return {j: [rows] for j, (_, rows) in enumerate(self.reference(precision))}

    def readings(self, seen, ref) -> dict:
        t = self.t
        gaps = []
        strides = yolo.row_strides(self.cfg, t["imgsz"], t["imgsz"], self.device)
        with compare.plain_float32():
            for j, (pred, rows) in enumerate(ref):
                for got in seen.get(j, []):
                    gaps += compare.detection_distances(got, pred, rows, strides,
                                                        t["conf_thres"], t["iou_thres"],
                                                        t["max_det"])
        return compare.gap_stats("det_gap", gaps)

    def close(self):
        pass


def run(ctx) -> dict:
    d = Runner(ctx)
    d.prepare()
    if d.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(d.device)
    det = d.program()
    d.warm(det)
    setup_s = time.perf_counter() - ctx.t_start
    w, seen = d.window(det, ctx.seconds)
    peak = torch.cuda.max_memory_allocated(d.device) if d.device.type == "cuda" else 0
    traced = d.traced(det) if ctx.trace else None
    del det
    gc.collect()
    if d.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = d.readings(seen, d.reference())
    ctx.note(readings=readings)
    bs, s = ctx.cell.traffic["batch"], ctx.cell.traffic["imgsz"]
    ctx.note(window_batches=w.events, window_s=w.elapsed, thirds=w.thirds(),
             detections_per_image=float(np.mean([len(r) for v in seen.values() for r in v[1]])),
             images_with_detections=float(np.mean([len(r) > 0 for v in seen.values() for r in v[1]])))
    return {
        "attempted": w.units, "failed": 0,
        "metrics": {"detect_img_s": w.rate, "setup_s": setup_s},
        "memory_peak_bytes": peak,
        "readings": readings,
        "trace": traced,
        "layer": {
            "flops_per_s": w.rate * flops.model_flops(d.cfg, s, s),
            "stem_bound_s": flops.stem_bound_s(bs, s, s, yolo.parse(d.cfg)[2][0].c2,
                                               2 if ctx.cell.traffic["half"] else 4),
        },
    }
