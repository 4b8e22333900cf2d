"""YOLO-format dataset and fixed-shape batch loader.

The port of ``yolov5_tpu/data/dataset.py`` without its host augmentation:
image discovery, label parsing and verification, the hash-keyed label
cache, ``YOLODataset``, and a ``Loader`` that yields rect batches
(aspect-sorted, per-batch shapes), square letterboxed batches, or, for
training with device augmentation, raw batches (each image resized long
side = img_size into the top-left of its buffer) in a seeded per-epoch
shuffle. Each batch is a dict of numpy arrays: ``images`` (bs, h, w, 3)
uint8 RGB, ``targets`` (bs, max_labels, 5) [cls, x, y, w, h] normalized to
the batch frame (raw batches: to the image content, with ``hw`` its size),
``valid`` (bs, max_labels), ``real`` (images that are not padding),
``indices`` and ``paths``.

Images are read by ``data.imageio``: 24-bit BMP with numpy, anything else
with OpenCV. Training augments on the device (``data.device_aug``); the host
augmentation stack (``yolov5_tpu/data/augment.py``, ``load_mosaic``, the
worker processes, quad batches) is not ported and raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from yolov5_tpu_torch.data.imageio import image_size, imread
from yolov5_tpu_torch.data.letterbox import letterbox

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}

# The JAX package writes its label cache to the same path with the version
# "yolov5_tpu-labels-v1"; each package rebuilds over the other's file.
CACHE_VERSION = "yolov5_tpu_torch-labels-v1"


def img2label_paths(img_paths):
    """.../images/xx.jpg -> .../labels/xx.txt (reference dataloaders.py:23-24)."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for p in img_paths]


def find_images(path):
    """Accept a dir, a glob, a txt listing, or a list thereof."""
    files = []
    for p in path if isinstance(path, (list, tuple)) else [path]:
        p = Path(p)
        if p.is_dir():
            files += sorted(str(f) for f in p.rglob("*.*"))
        elif p.suffix == ".txt" and p.is_file():
            root = p.parent
            for line in p.read_text().splitlines():
                line = line.strip()
                if line:
                    files.append(str((root / line).resolve()) if line.startswith("./") else line)
        elif p.is_file():
            files.append(str(p))
        else:
            import glob

            files += sorted(glob.glob(str(p), recursive=True))
    return [f for f in files if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS]


def load_label_file(path):
    """Parse one label txt -> (n, 5) float32 [cls, x, y, w, h] (+ polygon
    segments if rows have >5 numbers, reference verify_image_label style)."""
    segments = []
    if not os.path.isfile(path):
        return np.zeros((0, 5), np.float32), segments
    rows = []
    with open(path) as f:
        for line in f.read().strip().splitlines():
            v = line.split()
            if len(v) > 5:  # polygon: cls x1 y1 x2 y2 ...
                cls = float(v[0])
                seg = np.array(v[1:], np.float32).reshape(-1, 2)
                x1, y1 = seg.min(0)
                x2, y2 = seg.max(0)
                rows.append([cls, (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                segments.append(seg)
            elif len(v) == 5:
                rows.append([float(x) for x in v])
                segments.append(None)  # placeholder keeps row j <-> segment j
    if any(s is not None for s in segments):
        # mixed box/polygon files: rectangle polygons for box-only rows keep
        # segments row-aligned with labels (reference all-or-none rule)
        for j, s in enumerate(segments):
            if s is None:
                c, x, y, w, h = rows[j]
                segments[j] = np.array(
                    [[x - w / 2, y - h / 2], [x + w / 2, y - h / 2],
                     [x + w / 2, y + h / 2], [x - w / 2, y + h / 2]],
                    np.float32)
    else:
        segments = []
    labels = np.array(rows, np.float32) if rows else np.zeros((0, 5), np.float32)
    labels[:, 1:] = labels[:, 1:].clip(0, 1)
    return labels, segments


def get_hash(paths):
    """Size+name hash keying the label cache (reference get_hash semantics)."""
    import hashlib

    total = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.md5(str(total).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def verify_image_label(im_file, lb_file):
    """Integrity-check one (image, label) pair (reference
    utils/dataloaders.py:895-946): readable image of sane size, corrupt-JPEG
    auto-restore, validated/deduplicated label rows.

    Returns (labels | None-if-corrupt, shape (h, w), segments, msg). A
    missing image decoder is not corruption: its ImportError propagates."""
    msg = ""
    try:
        w, h, fmt = image_size(im_file)
        shape = (h, w)
        assert shape[0] > 9 and shape[1] > 9, f"image size {shape} < 10 pixels"
        assert fmt in IMG_FORMATS, f"invalid image format {fmt}"
        if fmt in ("jpg", "jpeg"):
            with open(im_file, "rb") as f:
                f.seek(-2, 2)
                if f.read() != b"\xff\xd9":  # truncated JPEG: restore
                    from PIL import Image, ImageOps

                    ImageOps.exif_transpose(Image.open(im_file)).save(
                        im_file, "JPEG", subsampling=0, quality=100)
                    msg = f"{im_file}: corrupt JPEG restored and saved"
        labels, segments = load_label_file(lb_file)
        if len(labels):
            assert (labels >= 0).all(), "negative label values"
            assert (labels[:, 1:] <= 1).all(), "non-normalized coordinates"
            _, keep = np.unique(labels, axis=0, return_index=True)
            if len(keep) < len(labels):  # duplicate rows removed
                keep = np.sort(keep)
                labels = labels[keep]
                segments = ([segments[i] for i in keep] if segments else [])
                msg = f"{im_file}: {len(labels) - len(keep)} duplicate labels removed"
        return labels, shape, segments, msg
    except ImportError:
        raise
    except Exception as e:
        return None, None, [], f"{im_file}: ignoring corrupt image/label: {e}"


def load_or_build_label_cache(im_files, label_files, workers=8):
    """Hash-validated label cache (reference .cache npy,
    utils/dataloaders.py:528-560): verification runs once per dataset change,
    not once per run. Returns (keep_idx, labels, shapes, segments, msgs)."""
    cache_path = Path(label_files[0]).parent.with_suffix(".cache.npy") \
        if label_files else None
    h = get_hash(list(label_files) + list(im_files))
    if cache_path and cache_path.exists():
        try:
            cached = np.load(cache_path, allow_pickle=True).item()
            if cached.get("version") == CACHE_VERSION and cached.get("hash") == h:
                return (cached["keep"], cached["labels"], cached["shapes"],
                        cached["segments"], cached.get("msgs", []))
        except (OSError, ValueError, AttributeError, EOFError) as e:
            print(f"label cache {cache_path} unreadable ({e}); rebuilding")
    with ThreadPoolExecutor(max(workers, 1)) as pool:
        results = list(pool.map(lambda a: verify_image_label(*a),
                                zip(im_files, label_files)))
    keep, labels, shapes, segments, msgs = [], [], [], [], []
    for i, (lb, shape, segs, msg) in enumerate(results):
        if msg:
            msgs.append(msg)
        if lb is None:
            continue
        keep.append(i)
        labels.append(lb)
        shapes.append(shape)
        segments.append(segs)
    out = {"version": CACHE_VERSION, "hash": h, "keep": keep, "labels": labels,
           "shapes": shapes, "segments": segments, "msgs": msgs}
    if cache_path:
        try:
            np.save(str(cache_path), out, allow_pickle=True)
        except OSError:
            pass  # read-only dataset dirs are fine
    return keep, labels, shapes, segments, msgs


class YOLODataset:
    """Index-addressable dataset: letterboxed uint8 BGR images and their
    labels (normalized xywh). ``cache``: None, "ram" (decoded images kept in
    memory) or "disk" (a ``.npy`` of the decoded pixels beside each image,
    read back with numpy). ``augment`` marks a training set, which resizes
    with linear interpolation; its augmentation runs on the device
    (``device_aug=True``): the host path is not ported."""

    def __init__(self, path, img_size=640, single_cls=False, cache=None, augment=False,
                 device_aug=False):
        if augment and not device_aug:
            raise NotImplementedError(
                "augmented loaders need device_aug=True: host-side augmentation "
                "(yolov5_tpu/data/augment.py: load_mosaic, the augment stack, worker "
                "processes) is not ported")
        self.img_size = img_size
        self.augment = augment
        self.cache = cache
        self._ram: dict = {}
        self.single_cls = single_cls
        self.im_files = find_images(path)
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {path}")
        self.label_files = img2label_paths(self.im_files)
        keep, labels, shapes, _, msgs = load_or_build_label_cache(
            self.im_files, self.label_files)
        for m in msgs[:10]:
            print(m)
        if len(keep) < len(self.im_files):
            print(f"dataset: dropped {len(self.im_files) - len(keep)} corrupt images")
        self.im_files = [self.im_files[i] for i in keep]
        self.label_files = [self.label_files[i] for i in keep]
        self.labels = labels
        if not self.im_files:
            raise FileNotFoundError(f"no usable images in {path}")
        if single_cls:
            for l in self.labels:
                l[:, 0] = 0
        self.n = len(self.im_files)
        self.shapes = np.asarray(shapes, np.int32)  # (n, 2) original (h, w)

    def __len__(self):
        return self.n

    def load_image(self, i):
        """Read + resize long side to img_size (reference dataloaders.py:768-788).
        Returns (im, (h0, w0), (h, w))."""
        if self.cache == "ram" and i in self._ram:
            im, hw0, hw = self._ram[i]
            return im.copy(), hw0, hw
        im = None
        if self.cache == "disk":  # decoded-pixels cache (reference :643-651)
            npy = Path(self.im_files[i]).with_suffix(".npy")
            if npy.exists():
                try:
                    im = np.load(npy)
                except (OSError, ValueError):
                    im = None
            if im is None:
                im = imread(self.im_files[i])
                try:
                    np.save(str(npy), im)
                except OSError:
                    pass  # read-only dataset dir
        if im is None:
            im = imread(self.im_files[i])
        h0, w0 = im.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            import cv2

            interp = cv2.INTER_LINEAR if (self.augment or r > 1) else cv2.INTER_AREA
            im = cv2.resize(im, (math.ceil(w0 * r), math.ceil(h0 * r)), interpolation=interp)
        if self.cache == "ram":
            self._ram[i] = (im.copy(), (h0, w0), im.shape[:2])
        return im, (h0, w0), im.shape[:2]

    def get_item(self, index):
        """One sample letterboxed to (s, s): (im uint8 BGR, labels (n, 5)
        normalized xywh in the letterboxed frame)."""
        s = self.img_size
        im, _, (h, w) = self.load_image(index)
        im, ratio, pad = letterbox(im, s, auto=False, scaleup=False)
        labels = self.labels[index].copy()
        if len(labels):  # normalized xywh -> letterbox px xyxy -> normalized xywh
            x, y, bw, bh = (labels[:, j].copy() for j in range(1, 5))
            sw, sh = ratio[0] * w, ratio[1] * h
            x1 = (sw * (x - bw / 2) + pad[0]).clip(0, s)
            y1 = (sh * (y - bh / 2) + pad[1]).clip(0, s)
            x2 = (sw * (x + bw / 2) + pad[0]).clip(0, s)
            y2 = (sh * (y + bh / 2) + pad[1]).clip(0, s)
            labels[:, 1] = (x1 + x2) / 2 / s
            labels[:, 2] = (y1 + y2) / 2 / s
            labels[:, 3] = (x2 - x1) / s
            labels[:, 4] = (y2 - y1) / s
            labels = labels[(labels[:, 3] > 1e-4) & (labels[:, 4] > 1e-4)]
        return np.ascontiguousarray(im), labels


def rect_batch_shapes(shapes, batch_size, img_size, stride=32, pad=0.5,
                      buckets=None):
    """Rect-val batching: sort by aspect ratio, give each batch the smallest
    stride-aligned (h, w) that fits its images (reference
    dataloaders.py:589-612). Returns (order, per-batch (h, w) list).

    ``buckets`` snaps each shape up to the nearest allowed size. The JAX
    package does so to bound its compiles; the port keeps it so that both
    give the same letterbox shapes, and hence the same mAP."""
    n = len(shapes)
    ar = shapes[:, 0] / np.maximum(shapes[:, 1], 1)  # h / w
    order = np.argsort(ar)
    nb = math.ceil(n / batch_size)
    out_shapes = []
    for bi in range(nb):
        sel = order[bi * batch_size : (bi + 1) * batch_size]
        ari = ar[sel]
        mini, maxi = float(ari.min()), float(ari.max())
        shape = [1.0, 1.0]
        if maxi < 1:
            shape = [maxi, 1.0]
        elif mini > 1:
            shape = [1.0, 1.0 / mini]
        h = int(np.ceil(shape[0] * img_size / stride + pad) * stride)
        w = int(np.ceil(shape[1] * img_size / stride + pad) * stride)
        h, w = min(h, img_size), min(w, img_size)
        if buckets:
            h = min(b for b in buckets if b >= h)
            w = min(b for b in buckets if b >= w)
        out_shapes.append((h, w))
    return order, out_shapes


def raw_batch(ds: YOLODataset, chunk, max_labels):
    """The images ``chunk`` of ``ds`` as the device mosaic takes them: each
    resized long side = s into the top-left of an s x s buffer of 114 (RGB),
    ``hw`` the content sizes, labels normalized to the content and padded to
    ``max_labels``."""
    s = ds.img_size
    bs = len(chunk)
    images = np.full((bs, s, s, 3), 114, np.uint8)
    hw = np.zeros((bs, 2), np.int32)
    targets = np.zeros((bs, max_labels, 5), np.float32)
    valid = np.zeros((bs, max_labels), bool)
    for b, i in enumerate(chunk):
        im, _, (h, w) = ds.load_image(int(i))
        images[b, :h, :w] = im[..., ::-1]  # BGR -> RGB
        hw[b] = (h, w)
        lab = ds.labels[int(i)]
        n = min(len(lab), max_labels)
        if n:
            targets[b, :n] = lab[:n]
            valid[b, :n] = True
    return {"images": images, "hw": hw, "targets": targets, "valid": valid}


class Loader:
    """Fixed-shape batches over a ``YOLODataset``: rect (aspect-sorted,
    per-batch shape) or square (img_size²) for validation, in index order,
    the final partial batch padded with copies of its last image (``real``
    counts the others); for a training set (``augment``), ``raw_batch``es
    for the device mosaic in a permutation seeded by (seed + epoch), the JAX
    package's order for the same seed, the final partial batch dropped."""

    def __init__(self, dataset: YOLODataset, batch_size=16, max_labels=128,
                 workers=8, rect=False, stride=32, pad=0.5, seed=0):
        self.ds = dataset
        self.bs = batch_size
        if max_labels in (None, "auto"):
            # the label capacity of the dataset's busiest image, in 8s
            most = max((len(lb) for lb in dataset.labels), default=1)
            max_labels = max(8, int(math.ceil(most / 8) * 8))
        self.max_labels = max_labels
        self.workers = max(1, min(workers, os.cpu_count() or 1))
        self.rect = rect and not dataset.augment
        self.stride = stride
        self.pad = pad
        self.seed = seed
        self.epoch = 0
        self._rect_plan = None

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.ds.augment else math.ceil(n / self.bs)

    def _indices(self, epoch):
        idx = np.arange(len(self.ds))
        if self.ds.augment:
            idx = np.random.default_rng(self.seed + epoch).permutation(idx)
        return idx

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _pad_chunk(self, chunk):
        chunk = [int(i) for i in chunk]
        real = len(chunk)
        while len(chunk) < self.bs:
            chunk.append(chunk[-1])
        return chunk, real

    def _collate(self, samples):
        bs = len(samples)
        s = self.ds.img_size
        images = np.zeros((bs, s, s, 3), np.uint8)
        targets = np.zeros((bs, self.max_labels, 5), np.float32)
        valid = np.zeros((bs, self.max_labels), bool)
        for b, (im, labels) in enumerate(samples):
            images[b] = im[..., ::-1]  # BGR -> RGB
            n = min(len(labels), self.max_labels)
            if n:
                targets[b, :n] = labels[:n]
                valid[b, :n] = True
        return {"images": images, "targets": targets, "valid": valid}

    def _rect_batch(self, chunk, hw):
        """Load + letterbox a batch to the rect shape (h, w); labels
        re-normalized to that frame."""
        h, w = hw
        bs = len(chunk)
        images = np.zeros((bs, h, w, 3), np.uint8)
        targets = np.zeros((bs, self.max_labels, 5), np.float32)
        valid = np.zeros((bs, self.max_labels), bool)
        for b, i in enumerate(chunk):
            im, _, (rh, rw) = self.ds.load_image(int(i))
            im, ratio, (dw, dh) = letterbox(im, (h, w), auto=False, scaleup=False)
            images[b] = im[..., ::-1]
            lab = self.ds.labels[int(i)]
            n = min(len(lab), self.max_labels)
            if n:
                t = lab[:n].copy()
                sw, sh = ratio[0] * rw, ratio[1] * rh  # drawn image size in px
                t[:, 1] = (t[:, 1] * sw + dw) / w
                t[:, 2] = (t[:, 2] * sh + dh) / h
                t[:, 3] = t[:, 3] * sw / w
                t[:, 4] = t[:, 4] * sh / h
                targets[b, :n] = t
                valid[b, :n] = True
        return {"images": images, "targets": targets, "valid": valid}

    def _rect_iter(self):
        if self._rect_plan is None:
            s = self.ds.img_size
            # the JAX package's bucket set (dataset.py:888-889)
            buckets = sorted(set(list(range(self.stride * 4, s, self.stride * 2)) + [s]))
            self._rect_plan = rect_batch_shapes(self.ds.shapes, self.bs, s, self.stride,
                                                self.pad, buckets=tuple(buckets))
        order, shapes = self._rect_plan
        for bi, hw in enumerate(shapes):
            chunk, real = self._pad_chunk(order[bi * self.bs : (bi + 1) * self.bs])
            batch = self._rect_batch(chunk, hw)
            if real < self.bs:  # padded duplicates must not count as images
                batch["valid"][real:] = False
                batch["targets"][real:] = 0
            batch["real"] = real
            batch["paths"] = [self.ds.im_files[i] for i in chunk]
            batch["indices"] = np.asarray(chunk, np.int64)
            yield batch

    def __iter__(self):
        if self.rect:
            yield from self._rect_iter()
            return
        idx = self._indices(self.epoch)
        with ThreadPoolExecutor(self.workers) as pool:
            for bi in range(len(self)):
                chunk, real = self._pad_chunk(idx[bi * self.bs:(bi + 1) * self.bs])
                if self.ds.augment:
                    batch = raw_batch(self.ds, chunk, self.max_labels)
                else:
                    samples = list(pool.map(self.ds.get_item, chunk[:real]))
                    samples += [samples[-1]] * (self.bs - real)
                    batch = self._collate(samples)
                batch["real"] = real
                batch["paths"] = [self.ds.im_files[i] for i in chunk]
                batch["indices"] = np.asarray(chunk, np.int64)
                yield batch


def create_loader(path, img_size=640, batch_size=16, augment=False, max_labels=128,
                  workers=8, seed=0, single_cls=False, cache=None, device_aug=False,
                  rect=False, stride=32, pad=0.5):
    """Dataset + loader in one call (reference create_dataloader,
    utils/dataloaders.py:106-164). Validation (augment False) sees every
    image once and pads the final batch; training (augment True, which
    needs device_aug) shuffles raw batches and drops the final partial
    batch."""
    ds = YOLODataset(path, img_size=img_size, single_cls=single_cls, cache=cache or None,
                     augment=augment, device_aug=device_aug)
    return ds, Loader(ds, batch_size=batch_size, max_labels=max_labels, workers=workers,
                      rect=rect, stride=stride, pad=pad, seed=seed)
