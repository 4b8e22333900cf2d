"""Host-side training augmentation with numpy.

The port of ``yolov5_tpu/data/augment.py`` (the reference's
utils/augmentations.py:69-245): HSV jitter, ``random_perspective``,
``box_candidates``, mixup, copy-paste, flips and the optional
albumentations hook. The OpenCV calls of the JAX module are the numpy
versions of ``data.cv`` (resize, warps, rotation matrix, HSV, polygon fill).
Labels are (n, 5) [cls, x1, y1, x2, y2] pixel arrays; segments are lists of
(k, 2) pixel polygons. Every draw comes from the ``np.random.Generator``
passed in, in the JAX module's order, so equal seeds give equal draws in
both packages.
"""

from __future__ import annotations

import math

import numpy as np

from yolov5_tpu_torch.data import cv


def augment_hsv(im, hgain=0.015, sgain=0.7, vgain=0.4, rng=None):
    """In-place LUT-based HSV jitter of a uint8 BGR image (reference
    augmentations.py:69-82); the LUTs are built in float64."""
    if not (hgain or sgain or vgain):
        return im
    rng = rng or np.random.default_rng()
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = cv.bgr_to_hsv(im)
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(im.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(im.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(im.dtype)
    hsv = np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]], lut_val[hsv[..., 2]]], -1)
    im[...] = cv.hsv_to_bgr(hsv)
    return im


class Albumentations:
    """Optional albumentations pipeline (reference augmentations.py:24-66):
    a no-op when the package is not installed. When it is, the reference's
    recipe (Blur/MedianBlur/ToGray/CLAHE at p=0.01 each). im is BGR uint8;
    labels (n, 5) [cls, x, y, w, h] normalized."""

    def __init__(self, size=640):
        self.transform = None
        try:
            import albumentations as A
        except ImportError:
            return
        t = [A.Blur(p=0.01), A.MedianBlur(p=0.01), A.ToGray(p=0.01), A.CLAHE(p=0.01),
             A.RandomBrightnessContrast(p=0.0), A.RandomGamma(p=0.0),
             A.ImageCompression(quality_lower=75, p=0.0)]
        self.transform = A.Compose(t, bbox_params=A.BboxParams(format="yolo",
                                                               label_fields=["class_labels"]))

    def __call__(self, im, labels, p=1.0, rng=None):
        if self.transform is None:
            return im, labels
        rng = rng or np.random.default_rng()
        if rng.random() > p:
            return im, labels
        # albumentations draws from the global python/numpy generators: seed
        # them from the item's generator so that --seed reproduces a run
        import random

        s = int(rng.integers(0, 2 ** 31 - 1))
        random.seed(s)
        np.random.seed(s)
        new = self.transform(image=im, bboxes=labels[:, 1:], class_labels=labels[:, 0])
        if len(new["class_labels"]) == len(labels):  # skip runs that lose labels
            im = new["image"]
            labels = np.array([[c, *b] for c, b in zip(new["class_labels"], new["bboxes"])],
                              np.float32).reshape(-1, 5)
        return im, labels


def box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Keep boxes that survive augmentation meaningfully (reference
    augmentations.py:236-245). box1/box2: (4, n) before/after."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def random_perspective(im, targets=(), segments=(), degrees=10, translate=0.1, scale=0.1,
                       shear=10, perspective=0.0, border=(0, 0), rng=None):
    """Composed center/perspective/rotate-scale/shear/translate warp
    (reference augmentations.py:118-197). targets: (n, 5) [cls, xyxy] px.
    Returns (im, targets, segments)."""
    rng = rng or np.random.default_rng()
    height = im.shape[0] + border[0] * 2
    width = im.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -im.shape[1] / 2
    C[1, 2] = -im.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv.rotation_matrix_2d(center=(0, 0), angle=a, scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            im = cv.warp_perspective(im, M, (width, height), border_value=(114, 114, 114))
        else:
            im = cv.warp_affine(im, M[:2], (width, height), border_value=(114, 114, 114))

    n = len(targets)
    new_segments = []
    if n:
        if len(segments):
            # warp each polygon; the box is the warped polygon's extent
            new = np.zeros((n, 4))
            for i, seg in enumerate(segments):
                xy = np.ones((len(seg), 3))
                xy[:, :2] = seg
                xy = xy @ M.T
                xy = (xy[:, :2] / xy[:, 2:3]) if perspective else xy[:, :2]
                xy[:, 0] = xy[:, 0].clip(0, width)
                xy[:, 1] = xy[:, 1].clip(0, height)
                new[i] = [xy[:, 0].min(), xy[:, 1].min(), xy[:, 0].max(), xy[:, 1].max()]
                new_segments.append(xy)
            keep = box_candidates(targets[:, 1:5].T * s, new.T, area_thr=0.01)
        else:
            xy = np.ones((n * 4, 3))
            xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
            xy = xy @ M.T
            xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
            # pre-warp boxes scaled by the zoom, so that the area ratio compares
            # like with like (reference augmentations.py:193)
            keep = box_candidates(targets[:, 1:5].T * s, new.T, area_thr=0.1)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
        new_segments = [s_ for s_, k in zip(new_segments, keep) if k] if new_segments else []
    return im, targets, new_segments


def mixup(im, labels, im2, labels2, rng=None):
    """Beta(32, 32) image blend (reference augmentations.py:224-233)."""
    rng = rng or np.random.default_rng()
    r = rng.beta(32.0, 32.0)
    im = (im.astype(np.float32) * r + im2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return im, np.concatenate((labels, labels2), 0)


def _bbox_ioa(box1, box2, eps=1e-7):
    """Intersection over box2's area, (N, 4) x (M, 4) float32 xyxy -> (N, M),
    in the JAX package's float32 order (``yolov5_tpu.ops.boxes.bbox_ioa``)."""
    b1, b2 = box1[:, None, :], box2[None, :, :]
    inter = (np.clip(np.minimum(b1[..., 2], b2[..., 2]) - np.maximum(b1[..., 0], b2[..., 0]),
                     0, None)
             * np.clip(np.minimum(b1[..., 3], b2[..., 3]) - np.maximum(b1[..., 1], b2[..., 1]),
                       0, None))
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]) + np.float32(eps)
    return inter / area2[None, :]


def copy_paste(im, labels, segments, p=0.5, rng=None):
    """Flip-paste segment instances whose pasted box occludes < 30% of every
    existing label (reference augmentations.py:200-221)."""
    rng = rng or np.random.default_rng()
    n = len(segments)
    if not (p and n):
        return im, labels, segments
    h, w, _ = im.shape
    mask = np.zeros((h, w), bool)
    for j in rng.choice(n, round(p * n), replace=False):
        l, seg = labels[j], segments[j]
        box = w - l[3], l[2], w - l[1], l[4]
        ioa = _bbox_ioa(np.array([box], np.float32), labels[:, 1:5].astype(np.float32))
        if (ioa < 0.30).all():
            labels = np.concatenate((labels, [[l[0], *box]]), 0)
            segments.append(np.concatenate((w - seg[:, 0:1], seg[:, 1:2]), 1))
            cv.fill_poly(mask, segments[-1].astype(np.int32), True)
    im[mask] = im[:, ::-1][mask]  # pixels of the left-right flipped source
    return im, labels, segments


def flip_lr(im, labels, segments=None):
    im = np.fliplr(im).copy()
    if len(labels):
        w = im.shape[1]
        x1 = labels[:, 1].copy()
        labels[:, 1] = w - labels[:, 3]
        labels[:, 3] = w - x1
    if segments:
        for s in segments:
            s[:, 0] = im.shape[1] - s[:, 0]
    return im, labels


def flip_ud(im, labels, segments=None):
    im = np.flipud(im).copy()
    if len(labels):
        h = im.shape[0]
        y1 = labels[:, 2].copy()
        labels[:, 2] = h - labels[:, 4]
        labels[:, 4] = h - y1
    if segments:
        for s in segments:
            s[:, 1] = im.shape[0] - s[:, 1]
    return im, labels
