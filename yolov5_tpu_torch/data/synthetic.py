"""Synthetic 'shapes' detection dataset generator: a copy of
``yolov5_tpu/data/synthetic.py`` (numpy; OpenCV draws and writes the JPEGs,
imported inside the functions), whose files and returned config it equals
byte for byte on the same seed.

End-to-end train/val runs without a download use generated data: colored
rectangles / ellipses / triangles on textured noise backgrounds, written in
standard YOLO layout (images/*.jpg + labels/*.txt, segment polygons
optional). Class ids: 0=rectangle, 1=ellipse, 2=triangle.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CLASSES = ["rectangle", "ellipse", "triangle"]


def _rand_color(rng, lo=80):
    return tuple(int(c) for c in rng.integers(lo, 256, 3))


def generate_shapes_dataset(root, n_images=64, img_size=320, max_objects=6,
                            seed=0, segments=False, splits=(("train", 1.0),)):
    """Write a shapes dataset under root/{images,labels}/{split}. Returns a
    dataset-config dict compatible with train/val entry points."""
    import cv2

    root = Path(root)
    rng = np.random.default_rng(seed)
    out = {"path": str(root), "names": {i: n for i, n in enumerate(CLASSES)},
           "nc": len(CLASSES)}
    for split, frac in splits:
        n = max(1, int(n_images * frac))
        img_dir = root / "images" / split
        lbl_dir = root / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lbl_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            im = rng.integers(0, 60, (img_size, img_size, 3), dtype=np.uint8)
            im = (cv2.GaussianBlur(im, (0, 0), 3).astype(np.int32)
                  + int(rng.integers(0, 40))).clip(0, 255).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, max_objects + 1))):
                cls = int(rng.integers(0, 3))
                w = int(rng.integers(img_size // 10, img_size // 3))
                h = int(rng.integers(img_size // 10, img_size // 3))
                cx = int(rng.integers(w // 2 + 2, img_size - w // 2 - 2))
                cy = int(rng.integers(h // 2 + 2, img_size - h // 2 - 2))
                color = _rand_color(rng)
                x1, y1 = cx - w // 2, cy - h // 2
                x2, y2 = cx + w // 2, cy + h // 2
                if cls == 0:
                    cv2.rectangle(im, (x1, y1), (x2, y2), color, -1)
                    poly = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
                elif cls == 1:
                    cv2.ellipse(im, (cx, cy), (w // 2, h // 2), 0, 0, 360, color, -1)
                    t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
                    poly = list(zip(cx + w / 2 * np.cos(t), cy + h / 2 * np.sin(t)))
                else:
                    pts = np.array([(cx, y1), (x1, y2), (x2, y2)], np.int32)
                    cv2.fillPoly(im, [pts], color)
                    poly = [tuple(p) for p in pts]
                if segments:
                    flat = " ".join(
                        f"{px / img_size:.6f} {py / img_size:.6f}" for px, py in poly
                    )
                    rows.append(f"{cls} {flat}")
                else:
                    rows.append(
                        f"{cls} {cx / img_size:.6f} {cy / img_size:.6f} "
                        f"{w / img_size:.6f} {h / img_size:.6f}"
                    )
            cv2.imwrite(str(img_dir / f"{split}_{i:05d}.jpg"), im,
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            (lbl_dir / f"{split}_{i:05d}.txt").write_text("\n".join(rows) + "\n")
        out[split] = str(img_dir)
    return out


def generate_classify_dataset(root, n_per_class=20, img_size=160, seed=0,
                              splits=("train", "val")):
    """ImageFolder-style classification dataset of the same shapes."""
    import cv2

    root = Path(root)
    rng = np.random.default_rng(seed)
    for split in splits:
        for cls, name in enumerate(CLASSES):
            d = root / split / name
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n_per_class):
                im = rng.integers(0, 60, (img_size, img_size, 3), dtype=np.uint8)
                w = int(rng.integers(img_size // 4, img_size // 2))
                h = int(rng.integers(img_size // 4, img_size // 2))
                cx = int(rng.integers(w // 2 + 2, img_size - w // 2 - 2))
                cy = int(rng.integers(h // 2 + 2, img_size - h // 2 - 2))
                color = _rand_color(rng)
                if cls == 0:
                    cv2.rectangle(im, (cx - w // 2, cy - h // 2), (cx + w // 2, cy + h // 2), color, -1)
                elif cls == 1:
                    cv2.ellipse(im, (cx, cy), (w // 2, h // 2), 0, 0, 360, color, -1)
                else:
                    pts = np.array(
                        [(cx, cy - h // 2), (cx - w // 2, cy + h // 2), (cx + w // 2, cy + h // 2)],
                        np.int32,
                    )
                    cv2.fillPoly(im, [pts], color)
                cv2.imwrite(str(d / f"{i:04d}.jpg"), im)
    return str(root)
