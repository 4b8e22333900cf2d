"""High-level inference: weights -> BN-folded model on an explicit device ->
raw head maps -> decode + NMS from the maps -> padded ``Detections``.

The port of the serving path of ``yolov5_tpu/infer.py::Detector``. On a CUDA
device the forward's stem runs kernel K2 and the suppression kernel K1; the
other convolutions run through ``F.conv2d``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolov5_tpu_torch.models.weights import fuse_conv_bn, load_torch_state_dict, load_weights
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.ops.nms import non_max_suppression_from_maps


class Detector:
    """Weights in, detections out.

    ``weights``: None (seeded random weights), a reference ``.pt`` path, or a
    state_dict in the reference torch layout (fused or not; see
    ``models.weights.from_jax_variables``). BN is folded at load. ``half``
    runs the model in bfloat16."""

    def __init__(self, weights=None, cfg="yolov5s", imgsz=640, half=False,
                 device="cpu", seed=0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Detector(device={device!r}): no CUDA device is available")
        self.dtype = torch.bfloat16 if half else torch.float32
        if weights is None:
            sd = DetectionModel(cfg, seed=seed).state_dict()
        elif isinstance(weights, dict):
            sd = weights
        elif str(weights).endswith(".pt"):
            sd = load_torch_state_dict(Path(weights))
        else:
            raise ValueError(f"Detector: weights must be None, a .pt path or a "
                             f"state_dict, got {weights!r}")
        model = DetectionModel(cfg, fused=True, seed=seed)
        missed = load_weights(model, fuse_conv_bn(sd))
        if missed:
            print(f"weight import: {len(missed)} unmatched entries")
        self.model = model.to(self.device, self.dtype).to(
            memory_format=torch.channels_last).eval()
        self.names = model.names
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

    @torch.inference_mode()
    def forward_maps(self, images_uint8):
        """The raw head maps [(bs, ny, nx, na, no)] in the working dtype."""
        return self.model(self._to_input(images_uint8))

    @torch.inference_mode()
    def __call__(self, images_uint8, conf_thres=0.25, iou_thres=0.45,
                 max_det=1000, classes=None, agnostic=False, max_nms=2048):
        """images: (bs, s, s, 3) uint8 RGB (letterboxed), numpy or tensor.
        Returns padded ``Detections`` on the model's device."""
        class_filter = None
        if classes is not None:
            class_filter = np.zeros(self.nc, bool)
            class_filter[list(classes)] = True
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
