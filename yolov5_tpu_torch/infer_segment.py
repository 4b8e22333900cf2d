"""Segmentation inference: forward -> NMS with mask coefficients ->
process_mask -> colour overlays, boxes and polygon txt (reference
segment/predict.py:71-248); the port of ``yolov5_tpu/infer_segment.py``.

BN is folded at load, so the 6x6/s2 stem runs kernel K2 on a CUDA device
(the JAX function runs unfused: the same function within f32 rounding), and
NMS reaches kernel K1 with the mask coefficients carried beside the boxes.
Images are processed one at a time, as in the JAX function.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolov5_tpu_torch.data.imageio import imwrite
from yolov5_tpu_torch.data.letterbox import scale_boxes_np
from yolov5_tpu_torch.data.sources import LoadImages
from yolov5_tpu_torch.infer import annotate, color_for, load_model, resolve_device
from yolov5_tpu_torch.models.layers import decode
from yolov5_tpu_torch.models.yolo import SegmentationModel
from yolov5_tpu_torch.ops.masks import masks2segments, process_mask, scale_image
from yolov5_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression
from yolov5_tpu_torch.utils.general import increment_path


class Segmenter:
    """A BN-folded SegmentationModel on ``device``, in float32 (or bfloat16
    with ``half``): uint8 (bs, s, s, 3) RGB in, decoded predictions (bs, N,
    5 + nc + nm) in float32 and prototypes (bs, hm, wm, nm) out. ``weights``
    as ``infer.load_model`` takes them: None (seeded random), a ``.ckpt`` of
    the JAX package, a reference ``.pt``, or a state_dict."""

    def __init__(self, weights=None, cfg="yolov5n-seg", device="cuda", seed=0, half=False):
        self.device = resolve_device(device, "Segmenter")
        self.dtype = torch.bfloat16 if half else torch.float32
        model, names = load_model(weights, cfg, seed, SegmentationModel, "Segmenter")
        self.model = model.to(self.device, self.dtype).to(
            memory_format=torch.channels_last).eval()
        self.names = names or model.names
        self.nc = model.nc
        self.stride = model.stride
        self.anchors = tuple(torch.tensor(a, dtype=torch.float32, device=self.device)
                             for a in model.anchors)

    @torch.inference_mode()
    def forward(self, images_uint8):
        """(preds (bs, N, 5 + nc + nm) float32, proto (bs, hm, wm, nm))."""
        images = torch.as_tensor(images_uint8).to(self.device).contiguous()
        x = images.permute(0, 3, 1, 2).to(self.dtype) / 255.0  # NHWC storage = channels_last
        maps, proto = self.model(x)
        return decode(maps, self.anchors, self.stride, torch.float32, nc=self.nc), proto


def run(weights=None, source="", cfg="yolov5n-seg", imgsz=640, conf_thres=0.25,
        iou_thres=0.45, max_det=300, save_img=True, save_txt=False,
        project="runs/predict-seg", name="exp", exist_ok=False, verbose=True,
        device="cuda"):
    """Segment every image of ``source``; returns (results, save_dir),
    results the list of (path, rows (n, 6 + nm) [x1, y1, x2, y2, conf, cls,
    *coeffs] in letterbox pixels, masks (n, imgsz, imgsz) bool or None)."""
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
    (save_dir / "labels").mkdir(exist_ok=True)
    seg = Segmenter(weights or None, cfg=cfg, device=device)
    names = seg.names

    results = []
    for path, im, im0, _ in LoadImages(source, img_size=imgsz):
        preds, proto = seg.forward(im[None])
        dets = non_max_suppression(preds, conf_thres=conf_thres, iou_thres=iou_thres,
                                   max_det=max_det, nc=seg.nc)
        r = detections_to_numpy(dets)[0]
        masks = None
        if len(r):
            valid = dets.valid[0]
            masks = (process_mask(proto[0], dets.masks[0][valid], dets.boxes[0][valid],
                                  (imgsz, imgsz), upsample=True) > 0.5).cpu().numpy()
        results.append((path, r, masks))
        if verbose:
            print(f"{path}: {len(r)} instances")
        if save_img:
            im_out = im0.copy()
            if masks is not None and len(masks):
                # un-letterbox the mask stack to the source size, overlay colours
                m = scale_image(np.transpose(masks.astype(np.float32), (1, 2, 0)),
                                im0.shape[:2])
                m = m.reshape(im0.shape[0], im0.shape[1], -1)
                overlay = im_out.astype(np.float32)
                for i in range(m.shape[-1]):
                    color = np.array(color_for(r[i, 5]), np.float32)
                    mi = m[..., i] > 0.5
                    overlay[mi] = overlay[mi] * 0.5 + color * 0.5
                im_out = overlay.astype(np.uint8)
            boxes_native = (scale_boxes_np(im.shape[:2], r[:, :4].copy(), im0.shape[:2])
                            if len(r) else np.zeros((0, 4)))
            annotate(im_out, boxes_native, r[:, 4], r[:, 5], names)
            imwrite(save_dir / Path(path).name, im_out)
        if save_txt and masks is not None:
            segs = masks2segments(masks)
            lines = []
            h0, w0 = im0.shape[:2]
            gain = min(im.shape[0] / h0, im.shape[1] / w0)
            pad_x = (im.shape[1] - w0 * gain) / 2
            pad_y = (im.shape[0] - h0 * gain) / 2
            for cls, s in zip(r[:, 5].astype(int), segs):
                if not len(s):
                    continue
                xs = ((s[:, 0] - pad_x) / gain).clip(0, w0)
                ys = ((s[:, 1] - pad_y) / gain).clip(0, h0)
                flat = " ".join(f"{x / w0:.6g} {y / h0:.6g}" for x, y in zip(xs, ys))
                lines.append(f"{cls} {flat}")
            (save_dir / "labels" / f"{Path(path).stem}.txt").write_text("\n".join(lines) + "\n")
    if verbose:
        print(f"results saved to {save_dir}")
    return results, save_dir
