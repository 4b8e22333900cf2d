"""Classification data on the host: ImageFolder sets, their transforms and
the decoded cache.

The port of the host side of ``yolov5_tpu/train/run_classify.py`` (the
reference's torchvision ImageFolder + classify_transforms): samples are
``root/{class}/*`` in sorted order; ``load`` center-crops the shorter side
and resizes to ``img_size``, or, augmented, takes a random crop of 0.6-1.0
of each side and a horizontal flip drawn from the caller's numpy
``Generator`` in the JAX package's order. Images are read by
``data.imageio`` (24-bit BMP with numpy; other formats through OpenCV) and
resized by ``data.cv.resize`` (bit-exact with ``cv2.INTER_LINEAR``), so a BMP
set needs no OpenCV. Everything is RGB uint8 (h, w, 3) until ``normalize``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolov5_tpu_torch.data.cv import resize
from yolov5_tpu_torch.data.imageio import image_size, imread

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMG_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


class ImageFolder:
    """``root/{class}/*`` images; classes are the sorted subdirectory names,
    samples each class's sorted files with an image suffix."""

    def __init__(self, root, img_size=224, augment=False):
        self.root = Path(root)
        self.img_size = img_size
        self.augment = augment
        self.classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.samples = [
            (str(f), ci)
            for ci, c in enumerate(self.classes)
            for f in sorted((self.root / c).iterdir())
            if f.suffix.lower() in IMG_SUFFIXES
        ]
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.samples)

    def load(self, i, rng=None):
        """(RGB uint8 (s, s, 3), label) of sample i: augmented (a random
        crop and flip from ``rng``) when the set augments and ``rng`` is
        given, else the center crop of the shorter side."""
        path, label = self.samples[i]
        im = imread(path)
        s = self.img_size
        h, w = im.shape[:2]
        if self.augment and rng is not None:
            y0, x0, ch, cw, flip = _crop_draw(h, w, rng)
            im = im[y0:y0 + ch, x0:x0 + cw]
            if flip:
                im = im[:, ::-1]
        else:
            m = min(h, w)
            top, left = (h - m) // 2, (w - m) // 2
            im = im[top:top + m, left:left + m]
        im = resize(np.ascontiguousarray(im), (s, s), "linear")
        return np.ascontiguousarray(im[..., ::-1]), label

    def batches(self, batch_size, shuffle=False, seed=0, epoch=0, shard=(0, 1)):
        """Batches {"images": (B, s, s, 3) uint8 RGB, "labels": (B,) int32};
        the last partial batch is dropped, as the JAX package drops it.

        ``shard=(rank, world)``: this rank's rows (rank, rank + world, ...)
        of each global batch of ``batch_size * world``. The crops of the
        other rows are drawn from their images' sizes but not made, so each
        row gets the crop that one process at the global batch gives it."""
        r, n = shard
        gbs = batch_size * n
        idx = np.arange(len(self))
        if shuffle:
            idx = np.random.default_rng(seed + epoch).permutation(idx)
        rng = np.random.default_rng(seed * 7919 + epoch)
        for b0 in range(0, len(idx) - gbs + 1, gbs):
            rows = []
            for j, i in enumerate(idx[b0:b0 + gbs]):
                if j % n == r:
                    rows.append(self.load(int(i), rng))
                elif self.augment:
                    w, h, _ = image_size(self.samples[int(i)][0])
                    _crop_draw(h, w, rng)
            ims, labels = zip(*rows)
            yield {"images": np.stack(ims), "labels": np.array(labels, np.int32)}


def _crop_draw(h, w, rng):
    """An augmented sample's crop (y0, x0, height, width) of 0.6-1.0 of each
    side and its flip, drawn from ``rng`` in the JAX package's order."""
    scale = rng.uniform(0.6, 1.0)
    ch, cw = int(h * scale), int(w * scale)
    y0 = int(rng.integers(0, h - ch + 1))
    x0 = int(rng.integers(0, w - cw + 1))
    return y0, x0, ch, cw, rng.random() < 0.5


def normalize(images, dtype=torch.float32):
    """(B, 3, H, W) uint8 -> ImageNet-normalized ``dtype``, on the images'
    device and in their memory format."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=dtype, device=images.device).view(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, dtype=dtype, device=images.device).view(1, 3, 1, 1)
    return (images.to(dtype) / 255.0 - mean) / std


def build_cls_cache(ds):
    """Every image decoded and center-cropped once: (N, s, s, 3) uint8 RGB
    and (N,) int32 labels, for the device-resident training set."""
    n, s = len(ds), ds.img_size
    images = np.zeros((n, s, s, 3), np.uint8)
    labels = np.zeros((n,), np.int32)
    for i in range(n):
        images[i], labels[i] = ds.load(i)
    return images, labels
