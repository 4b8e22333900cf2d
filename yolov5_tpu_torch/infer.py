"""High-level inference: weights -> BN-folded model on an explicit device ->
raw head maps -> decode + NMS -> padded ``Detections``.

The port of ``yolov5_tpu/infer.py``'s ``Detector`` (serving from the raw
maps, the decoded forward that validation uses, test-time augmentation)
and ``Ensemble``. On a CUDA device the forward's stem runs kernel K2 and the
suppression kernel K1; the other convolutions run through ``F.conv2d``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolov5_tpu_torch.models.layers import decode
from yolov5_tpu_torch.models.weights import (fuse_conv_bn, from_jax_variables,
                                             load_torch_state_dict, load_weights)
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_from_maps
from yolov5_tpu_torch.utils.checkpoint import load_checkpoint, variables_from_checkpoint

# test-time augmentation: (scale, flip left-right) per pass (reference
# models/yolo.py:269-312), and the value the scaled images are padded with
TTA_PASSES = ((1.0, False), (0.83, True), (0.67, False))
TTA_PAD = 0.447


def tta_scale(x: torch.Tensor, ratio: float, gs: int) -> torch.Tensor:
    """(bs, 3, h, w) in [0, 1] -> resized to (int(h·ratio), int(w·ratio)),
    then padded at the bottom and right with TTA_PAD up to multiples of gs.

    Bilinear with antialiasing, in float32: ``jax.image.resize(...,
    "bilinear")``, which the JAX package calls, antialiases when it scales
    down (the reference's ``F.interpolate`` does not)."""
    h, w = x.shape[2:]
    nh = -int(-h * ratio // gs) * gs  # ceil to a stride multiple
    nw = -int(-w * ratio // gs) * gs
    y = F.interpolate(x.float(), size=(int(h * ratio), int(w * ratio)), mode="bilinear",
                      align_corners=False, antialias=True).to(x.dtype)
    return F.pad(y, (0, nw - y.shape[3], 0, nh - y.shape[2]), value=TTA_PAD)


def _class_filter(classes, nc):
    """A class id list -> an (nc,) bool keep-mask, or None."""
    if classes is None:
        return None
    keep = np.zeros(nc, bool)
    keep[list(classes)] = True
    return keep


class Detector:
    """Weights in, detections out.

    ``weights`` is one of:
      - None: seeded random weights;
      - a reference ``.pt`` path;
      - a ``.ckpt`` path written by the JAX package: its EMA weights when it
        has them, and cfg, class names and anchors from its meta;
      - a state_dict in the reference torch layout (fused or not; see
        ``models.weights.from_jax_variables``).
    Several weights make an ``Ensemble``: see ``ensemble``. BN is folded at
    load. ``half`` runs the model in bfloat16. It runs on the card unless
    ``device`` says otherwise (``device="cpu"``), and raises where no card is
    present."""

    def __init__(self, weights=None, cfg="yolov5s", imgsz=640, half=False,
                 device="cuda", seed=0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Detector(device={device!r}): no CUDA device is available")
        self.dtype = torch.bfloat16 if half else torch.float32
        names = anchors = None
        if weights is None:
            sd = DetectionModel(cfg, seed=seed).state_dict()
        elif isinstance(weights, dict):
            sd = weights
        elif isinstance(weights, (list, tuple)):
            raise ValueError("Detector: several weights make an Ensemble; build it "
                             "with yolov5_tpu_torch.infer.ensemble(weights, ...)")
        elif str(weights).endswith(".ckpt"):
            payload, meta = load_checkpoint(weights)
            cfg = meta.get("cfg", cfg)
            anchors = meta.get("anchors")  # autoanchor may have evolved them
            sd = from_jax_variables(variables_from_checkpoint(payload, prefer_ema=True))
            names = {int(k): v for k, v in meta.get("names", {}).items()} or None
        elif str(weights).endswith(".pt"):
            sd = load_torch_state_dict(Path(weights))
        else:
            raise ValueError(f"Detector: weights must be None, a .pt or .ckpt path, or "
                             f"a state_dict, got {weights!r}")
        model = DetectionModel(cfg, fused=True, seed=seed, anchors=anchors)
        missed = load_weights(model, fuse_conv_bn(sd))
        if missed:
            print(f"weight import: {len(missed)} unmatched entries")
        self.model = model.to(self.device, self.dtype).to(
            memory_format=torch.channels_last).eval()
        self.names = names or model.names
        self.nc = model.nc
        self.imgsz = imgsz
        self.stride = model.stride
        self.anchors = tuple(torch.tensor(a, dtype=torch.float32, device=self.device)
                             for a in model.anchors)

    def _to_input(self, images_uint8) -> torch.Tensor:
        """(bs, H, W, 3) uint8 -> (bs, 3, H, W) channels_last in the working
        dtype: cast, then divide by 255 in that dtype."""
        images = torch.as_tensor(images_uint8)
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"Detector: need (bs, H, W, 3) uint8 images, got "
                             f"{tuple(images.shape)} {images.dtype}")
        images = images.to(self.device, non_blocking=True).contiguous()
        x = images.permute(0, 3, 1, 2)  # NHWC storage = channels_last
        return x.to(self.dtype) / 255.0

    def _decode(self, maps) -> torch.Tensor:
        return decode(maps, self.anchors, self.stride, torch.float32, nc=self.nc)

    @torch.inference_mode()
    def forward_maps(self, images_uint8):
        """The raw head maps [(bs, ny, nx, na, no)] in the working dtype."""
        return self.model(self._to_input(images_uint8))

    @torch.inference_mode()
    def forward(self, images_uint8) -> torch.Tensor:
        """Decoded predictions (bs, N, 5 + nc) in float32: xywh in pixels,
        objectness and class probabilities."""
        return self._decode(self.model(self._to_input(images_uint8)))

    @torch.inference_mode()
    def forward_tta(self, images_uint8) -> torch.Tensor:
        """Decoded predictions of the test-time augmentation passes
        (TTA_PASSES), each de-scaled (and un-flipped) back to the input
        frame, concatenated along N."""
        x0 = self._to_input(images_uint8)
        h, w = x0.shape[2:]
        gs = max(self.stride)
        outs = []
        for ratio, flip in TTA_PASSES:
            x = x0.flip(3) if flip else x0
            if ratio != 1.0:
                x = tta_scale(x, ratio, gs)
            p = self._decode(self.model(x.contiguous(memory_format=torch.channels_last)))
            # de-scale with the actual per-axis resize ratio
            rx = int(w * ratio) / w if ratio != 1.0 else 1.0
            ry = int(h * ratio) / h if ratio != 1.0 else 1.0
            xs = p[..., 0:1] / rx
            if flip:
                xs = w - xs
            outs.append(torch.cat([xs, p[..., 1:2] / ry, p[..., 2:3] / rx,
                                   p[..., 3:4] / ry, p[..., 4:]], -1))
        return torch.cat(outs, 1)

    @torch.inference_mode()
    def __call__(self, images_uint8, conf_thres=0.25, iou_thres=0.45,
                 max_det=1000, classes=None, agnostic=False, max_nms=2048,
                 augment=False):
        """images: (bs, s, s, 3) uint8 RGB (letterboxed), numpy or tensor.
        Returns padded ``Detections`` on the model's device: from the raw
        maps, or with ``augment`` from the decoded TTA predictions."""
        class_filter = _class_filter(classes, self.nc)
        if augment:
            return non_max_suppression(
                self.forward_tta(images_uint8), conf_thres=conf_thres,
                iou_thres=iou_thres, max_det=max_det, agnostic=agnostic,
                class_filter=class_filter, max_nms=max_nms)
        maps = self.model(self._to_input(images_uint8))
        return non_max_suppression_from_maps(
            maps, self.anchors, self.stride, conf_thres=conf_thres,
            iou_thres=iou_thres, max_det=max_det, agnostic=agnostic,
            class_filter=class_filter, max_nms=max_nms, nc=self.nc)

    def warmup(self, batch_size=1):
        """One forward + NMS on a black batch (builds the CUDA kernels)."""
        self(np.zeros((batch_size, self.imgsz, self.imgsz, 3), np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Ensemble:
    """Several detectors as one (reference models/experimental.py:44-57):
    the members' decoded predictions are concatenated before one NMS. Names,
    classes, size, device and strides are the first member's."""

    def __init__(self, detectors):
        self.detectors = list(detectors)
        first = self.detectors[0]
        self.names, self.nc, self.imgsz = first.names, first.nc, first.imgsz
        self.device, self.stride = first.device, first.stride

    @torch.inference_mode()
    def forward(self, images_uint8) -> torch.Tensor:
        images = torch.as_tensor(images_uint8).to(self.device)
        return torch.cat([d.forward(images) for d in self.detectors], 1)

    @torch.inference_mode()
    def __call__(self, images_uint8, conf_thres=0.25, iou_thres=0.45,
                 max_det=1000, classes=None, agnostic=False, max_nms=2048,
                 augment=False):
        """As ``Detector.__call__``, on the concatenated predictions."""
        if augment:
            raise ValueError("TTA is not supported on the ensemble backend")
        return non_max_suppression(
            self.forward(images_uint8), conf_thres=conf_thres, iou_thres=iou_thres,
            max_det=max_det, agnostic=agnostic,
            class_filter=_class_filter(classes, self.nc), max_nms=max_nms)


def ensemble(weights_list, **kw):
    """An Ensemble of one Detector per weights entry (the reference's
    attempt_load with a list, models/experimental.py:60-101); ``kw`` go to
    every Detector."""
    return Ensemble([Detector(w, **kw) for w in weights_list])
