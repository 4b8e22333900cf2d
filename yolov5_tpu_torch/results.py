"""AutoShape-style end-user inference results.

The port of ``yolov5_tpu/results.py`` (the reference's AutoShape +
Detections, models/common.py:843-1101): feed paths / numpy arrays / PIL
images in any size, get a ``Results`` object with print/save/crop/render/
pandas-like accessors.

    det = yolov5_tpu_torch.hub.load("best.ckpt")
    r = predict(det, ["im1.bmp", np_array, pil_img])
    r.print(); r.save("runs/results"); df = r.pandas()

Paths are read by ``data.imageio.imread`` (24-bit BMP without OpenCV);
``save`` and ``crop`` write ``.jpg`` through ``data.imageio.imwrite``
(OpenCV or PIL); pandas is imported by ``pandas()`` only.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from yolov5_tpu_torch.data.imageio import imread, imwrite
from yolov5_tpu_torch.data.letterbox import letterbox, scale_boxes_np
from yolov5_tpu_torch.infer import annotate
from yolov5_tpu_torch.ops.nms import detections_to_numpy


def _to_bgr(im):
    """A path, a PIL image or a numpy RGB (or 2D gray) image -> (BGR uint8
    array, name)."""
    if isinstance(im, (str, Path)):
        return imread(im), str(im)
    if hasattr(im, "convert"):  # PIL
        return np.asarray(im.convert("RGB"))[..., ::-1].copy(), getattr(im, "filename", "pil")
    im = np.asarray(im)
    if im.ndim == 2:
        im = np.stack([im] * 3, -1)
    return im[..., ::-1].copy(), "array"  # treat input as RGB


class Results:
    """Per-image detections in native pixel space."""

    def __init__(self, images_bgr, rows, names, times_ms=0.0):
        self.images = images_bgr  # list of BGR np arrays
        self.rows = rows  # list of (n, 6) [x1,y1,x2,y2,conf,cls]
        self.names = names
        self.times_ms = times_ms
        self.n = len(images_bgr)

    def __len__(self):
        return self.n

    def records(self):
        """List (per image) of dicts — the pandas().xyxy equivalent."""
        out = []
        for r in self.rows:
            out.append([
                {"xmin": float(a), "ymin": float(b), "xmax": float(c),
                 "ymax": float(d), "confidence": float(cf), "class": int(cl),
                 "name": str(self.names.get(int(cl), int(cl)))}
                for a, b, c, d, cf, cl in r[:, :6]
            ])
        return out

    def pandas(self):
        import pandas as pd

        return [pd.DataFrame(rec) for rec in self.records()]

    def print(self):
        for i, r in enumerate(self.rows):
            counts = {}
            for c in r[:, 5].astype(int):
                counts[c] = counts.get(c, 0) + 1
            desc = ", ".join(f"{n} {self.names.get(c, c)}" for c, n in counts.items())
            print(f"image {i}: {self.images[i].shape[1]}x{self.images[i].shape[0]} "
                  f"{len(r)} detections  {desc}")
        print(f"speed: {self.times_ms:.1f} ms/image")

    def render(self):
        """Annotated BGR copies."""
        out = []
        for im, r in zip(self.images, self.rows):
            im = im.copy()
            annotate(im, r[:, :4], r[:, 4], r[:, 5], self.names)
            out.append(im)
        return out

    def save(self, save_dir="runs/results"):
        d = Path(save_dir)
        d.mkdir(parents=True, exist_ok=True)
        for i, im in enumerate(self.render()):
            imwrite(d / f"image{i}.jpg", im)
        return d

    def crop(self, save_dir=None):
        """Cut out each detection; optionally save per-class crops."""
        crops = []
        for i, (im, r) in enumerate(zip(self.images, self.rows)):
            for j, (x1, y1, x2, y2, conf, cls) in enumerate(r[:, :6]):
                c = im[int(y1):int(y2), int(x1):int(x2)].copy()
                crops.append({"im": c, "cls": int(cls), "conf": float(conf),
                              "name": self.names.get(int(cls), int(cls))})
                if save_dir:
                    d = Path(save_dir) / str(self.names.get(int(cls), int(cls)))
                    d.mkdir(parents=True, exist_ok=True)
                    imwrite(d / f"im{i}_det{j}.jpg", c)
        return crops


def predict(detector, sources, conf_thres=0.25, iou_thres=0.45, max_det=300,
            augment=False):
    """Robust multi-input inference -> Results. ``sources`` is one item or a
    list of paths / numpy RGB arrays / PIL images."""
    if not isinstance(sources, (list, tuple)):
        sources = [sources]
    images_bgr = [_to_bgr(s)[0] for s in sources]

    s = detector.imgsz
    lb = [letterbox(im, s)[0] for im in images_bgr]
    batch = np.stack([im[..., ::-1] for im in lb]).copy()  # RGB
    t0 = time.perf_counter()
    dets = detector(batch, conf_thres=conf_thres, iou_thres=iou_thres,
                    max_det=max_det, augment=augment)
    rows = detections_to_numpy(dets)
    dt = (time.perf_counter() - t0) * 1000 / len(sources)
    out_rows = []
    for im0, r in zip(images_bgr, rows):
        r = np.asarray(r)
        if len(r):
            r[:, :4] = scale_boxes_np((s, s), r[:, :4], im0.shape[:2])
        out_rows.append(r)
    return Results(images_bgr, out_rows, detector.names, dt)
