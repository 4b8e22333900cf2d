"""Traffic kind ``detect_batch_p6``: ``detect_batch`` (offline detection
over batches of frames, its set-up, window, trace and comparison) with the
weights of a P6 configuration, ``core/p6_weights.py``, and frames of any
size: each is first resized as yolov5's letterbox resizes it, so that its
longer side is ``imgsz`` (1080p to 1280x720 at 1280 px), then padded.

Parameters: as ``detect_batch``.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from perfbench.core import data, p6_weights
from perfbench.runners import detect_batch


def resize(ims: torch.Tensor, s: int) -> torch.Tensor:
    """(n, h0, w0, 3) uint8 scaled by min(s/h0, s/w0) to (round(h0·r),
    round(w0·r)), as ultralytics/yolov5 v7.0's letterbox does with
    cv2.INTER_LINEAR: bilinear with half-pixel centres, rounded to uint8."""
    h0, w0 = ims.shape[1:3]
    r = min(s / h0, s / w0)
    h, w = round(h0 * r), round(w0 * r)
    if (h, w) == (h0, w0):
        return ims
    x = F.interpolate(ims.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear",
                      align_corners=False)
    return x.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


class Runner(detect_batch.Runner):
    def inputs(self):
        """``detect_batch``'s pool, drawn at ``frame_hw`` and resized one
        batch at a time before the letterbox pads it."""
        t = self.t
        gen = data.generator(2 * self.ctx.seed + 1, self.device)  # apart from the weights'
        bs, n, s = t["batch"], t["pool_batches"], t["imgsz"]
        frames = data.frames(gen, bs * n, *t["frame_hw"])
        lb = data.letterbox(torch.cat([resize(f, s) for f in frames.split(bs)]), s, s)
        del frames
        self.calib = lb[::n][:bs].clone()  # a batch's worth from every batch
        self.batches = [lb[i * bs:(i + 1) * bs].cpu() for i in range(n)]
        if self.device.type == "cuda":
            self.batches = [b.pin_memory() for b in self.batches]

    def weights(self):
        t = self.t
        x = self.calib.to(self.device)
        nms = {k: t[k] for k in ("iou_thres", "max_det", "max_nms")}
        self.sd, measured, delta = p6_weights.calibrated(
            self.cfg, self.ctx.seed, [x], t["conf_thres"], t["det_per_img"], False, self.device,
            nms=nms, count_batches=[b.to(self.device) for b in self.batches])
        self.ctx.note(detections_per_image_calibrated=measured, objectness_shift=delta)


# ``detect_batch.run`` over this Runner: the same code over its own globals
run = types.FunctionType(detect_batch.run.__code__, {**vars(detect_batch), "Runner": Runner})
