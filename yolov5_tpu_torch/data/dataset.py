"""YOLO-format dataset and fixed-shape batch loader.

The port of ``yolov5_tpu/data/dataset.py``: image discovery, label parsing
and verification, the hash-keyed label cache, ``YOLODataset`` with the
reference's host augmentation (``load_mosaic`` with copy-paste, mixup,
random_perspective, albumentations, HSV, flips: ``data.augment``), and a
``Loader`` that yields rect batches (aspect-sorted, per-batch shapes),
square letterboxed batches, host-augmented training batches (std or quad,
in-process or from a pool of worker processes), or, for training with
device augmentation, raw batches (each image resized long side = img_size
into the top-left of its buffer), in a seeded per-epoch shuffle. Each batch
is a dict of numpy arrays: ``images`` (bs, h, w, 3) uint8 RGB, ``targets``
(bs, max_labels, 5) [cls, x, y, w, h] normalized to the batch frame (raw
batches: to the image content, with ``hw`` its size), ``valid`` (bs,
max_labels), ``real`` (images that are not padding), ``indices`` and
``paths``.

With ``masks`` a batch also holds the GT instance masks at img_size /
mask_ratio, filled from the samples' polygons (``rasterize_masks``): one
(bs, hm, wm) int32 index map with ``overlap``, else (bs, max_labels, hm,
wm) uint8.

Images are read by ``data.imageio`` (24-bit BMP with numpy, anything else
with OpenCV) and resized by ``data.cv``: no path needs OpenCV for BMP
input. The JAX package's per-rank shard and native JPEG batches are not
ported.
"""

from __future__ import annotations

import itertools
import math
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from yolov5_tpu_torch.data.augment import (Albumentations, augment_hsv, copy_paste, flip_lr,
                                           flip_ud, mixup, random_perspective)
from yolov5_tpu_torch.data.cv import contour_area, fill_poly, resize
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


DEFAULT_HYP = {
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
    "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0,
    "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
    "mosaic": 1.0, "mixup": 0.0, "copy_paste": 0.0,
}


class YOLODataset:
    """Index-addressable dataset: (image uint8 BGR, labels normalized xywh,
    segments in pixels) samples, with the reference's augmentation stack
    for a training set (``augment``). ``hyp`` is merged over
    ``DEFAULT_HYP``. ``cache``: None, "ram" (decoded images kept in memory)
    or "disk" (a ``.npy`` of the decoded pixels beside each image, read back
    with numpy). ``device_aug``: the device augments (``data.device_aug``),
    so a host mosaic only composes and crops."""

    def __getstate__(self):
        # worker processes build their own RAM cache; shipping the parent's
        # would copy every decoded image through the pickle pipe
        state = dict(self.__dict__)
        state["_ram"] = {}
        return state

    def __init__(self, path, img_size=640, single_cls=False, cache=None, augment=False,
                 device_aug=False, hyp=None):
        self.img_size = img_size
        self.augment = augment
        self.device_aug = device_aug
        self.cache = cache
        self._ram: dict = {}
        self.hyp = {**DEFAULT_HYP, **(hyp or {})}
        self.single_cls = single_cls
        self.im_files = find_images(path)
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {path}")
        self.label_files = img2label_paths(self.im_files)
        keep, labels, shapes, segments, msgs = load_or_build_label_cache(
            self.im_files, self.label_files)
        for m in msgs[:10]:
            print(m)
        if len(keep) < len(self.im_files):
            print(f"dataset: dropped {len(self.im_files) - len(keep)} corrupt images")
        self.im_files = [self.im_files[i] for i in keep]
        self.label_files = [self.label_files[i] for i in keep]
        self.labels = labels
        self.segments = segments
        if not self.im_files:
            raise FileNotFoundError(f"no usable images in {path}")
        if single_cls:
            for l in self.labels:
                l[:, 0] = 0
        self.n = len(self.im_files)
        self.indices = np.arange(self.n)
        self.mosaic_border = (-img_size // 2, -img_size // 2)
        self.shapes = np.asarray(shapes, np.int32)  # (n, 2) original (h, w)
        self.albumentations = Albumentations(img_size) if augment and not device_aug else None

    def __len__(self):
        return self.n

    # -- image io ---------------------------------------------------------
    def load_image(self, i):
        """Read + resize long side to img_size (reference dataloaders.py:768-788):
        linear for a training set or to grow, area to shrink for validation.
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
            interp = "linear" if (self.augment or r > 1) else "area"
            im = resize(im, (math.ceil(w0 * r), math.ceil(h0 * r)), interp)
        if self.cache == "ram":
            self._ram[i] = (im.copy(), (h0, w0), im.shape[:2])
        return im, (h0, w0), im.shape[:2]

    # -- label geometry ---------------------------------------------------
    @staticmethod
    def _denorm(labels, w, h, padw=0, padh=0):
        """normalized xywh -> pixel xyxy."""
        out = labels.copy()
        if len(out):
            x, y, bw, bh = labels[:, 1], labels[:, 2], labels[:, 3], labels[:, 4]
            out[:, 1] = w * (x - bw / 2) + padw
            out[:, 2] = h * (y - bh / 2) + padh
            out[:, 3] = w * (x + bw / 2) + padw
            out[:, 4] = h * (y + bh / 2) + padh
        return out

    @staticmethod
    def _norm(labels, w, h):
        """pixel xyxy -> normalized xywh (clipped)."""
        out = labels.copy()
        if len(out):
            x1 = labels[:, 1].clip(0, w)
            y1 = labels[:, 2].clip(0, h)
            x2 = labels[:, 3].clip(0, w)
            y2 = labels[:, 4].clip(0, h)
            out[:, 1] = (x1 + x2) / 2 / w
            out[:, 2] = (y1 + y2) / 2 / h
            out[:, 3] = (x2 - x1) / w
            out[:, 4] = (y2 - y1) / h
        return out

    # -- samples ----------------------------------------------------------
    def load_mosaic(self, index, rng):
        """4-image mosaic on a 2s x 2s canvas, copy-paste on it, and
        random_perspective's crop back to s x s (reference
        dataloaders.py:798-855)."""
        s = self.img_size
        yc = int(rng.uniform(-self.mosaic_border[0], 2 * s + self.mosaic_border[0]))
        xc = int(rng.uniform(-self.mosaic_border[1], 2 * s + self.mosaic_border[1]))
        idxs = [index] + list(rng.choice(self.indices, 3))
        im4 = np.full((s * 2, s * 2, 3), 114, np.uint8)
        labels4 = []
        segments4 = []
        for i, idx in enumerate(idxs):
            im, _, (h, w) = self.load_image(idx)
            if i == 0:  # top left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:  # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:  # bottom right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            im4[y1a:y2a, x1a:x2a] = im[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            labels4.append(self._denorm(self.labels[idx], w, h, padw, padh))
            for seg in self.segments[idx]:
                seg = seg.copy()
                seg[:, 0] = seg[:, 0] * w + padw
                seg[:, 1] = seg[:, 1] * h + padh
                segments4.append(seg)
        labels4 = np.concatenate(labels4, 0)
        labels4[:, 1:] = labels4[:, 1:].clip(0, 2 * s)
        for seg in segments4:
            np.clip(seg, 0, 2 * s, out=seg)

        hyp = self.hyp
        if hyp.get("copy_paste", 0) and segments4:
            # paste flipped instances onto the canvas before the warp
            # (reference dataloaders.py:836)
            im4, labels4, segments4 = copy_paste(im4, labels4, segments4, p=hyp["copy_paste"],
                                                 rng=rng)
        geo = {k: hyp[k] for k in ("degrees", "translate", "scale", "shear", "perspective")}
        if self.device_aug:  # the device warps; the host only crops
            geo = dict.fromkeys(geo, 0.0)
        return random_perspective(im4, labels4, segments4, border=self.mosaic_border, rng=rng,
                                  **geo)

    def get_item(self, index, rng=None):
        """One sample: (im uint8 BGR (s, s, 3), labels (n, 5) normalized xywh,
        segments in pixels). A training set draws the mosaic (and mixup) or
        the letterbox with random_perspective, then albumentations, HSV and
        flips, all from ``rng``; a validation set letterboxes."""
        rng = rng or np.random.default_rng()
        hyp = self.hyp
        s = self.img_size
        if self.augment and rng.random() < hyp["mosaic"]:
            im, labels, segments = self.load_mosaic(index, rng)
            if rng.random() < hyp["mixup"]:
                im2, labels2, seg2 = self.load_mosaic(int(rng.choice(self.indices)), rng)
                im, labels = mixup(im, labels, im2, labels2, rng=rng)
                segments = segments + seg2
        else:
            im, _, (h, w) = self.load_image(index)
            im, ratio, pad = letterbox(im, s, auto=False, scaleup=self.augment)
            labels = self._denorm(self.labels[index], ratio[0] * w, ratio[1] * h, pad[0], pad[1])
            segments = []
            for seg in self.segments[index]:
                seg = seg.copy()
                seg[:, 0] = seg[:, 0] * ratio[0] * w + pad[0]
                seg[:, 1] = seg[:, 1] * ratio[1] * h + pad[1]
                segments.append(seg)
            if self.augment and not self.device_aug:
                im, labels, segments = random_perspective(
                    im, labels, segments, degrees=hyp["degrees"], translate=hyp["translate"],
                    scale=hyp["scale"], shear=hyp["shear"], perspective=hyp["perspective"],
                    rng=rng)

        if self.augment and not self.device_aug:
            if self.albumentations is not None and self.albumentations.transform:
                # pixel-level extras before HSV and flips (reference
                # dataloaders.py:692-696), on normalized xywh labels
                h_im, w_im = im.shape[:2]
                lab_n = self._norm(labels, w_im, h_im)
                im, lab_n = self.albumentations(im, lab_n, rng=rng)
                labels = self._denorm(lab_n, w_im, h_im)
            augment_hsv(im, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"], rng=rng)
            if rng.random() < hyp["flipud"]:
                im, labels = flip_ud(im, labels, segments)
            if rng.random() < hyp["fliplr"]:
                im, labels = flip_lr(im, labels, segments)

        labels = self._norm(labels, im.shape[1], im.shape[0])
        if len(labels):  # drop degenerate rows
            keep = (labels[:, 3] > 1e-4) & (labels[:, 4] > 1e-4)
            labels = labels[keep]
            segments = [s_ for s_, k in zip(segments, keep) if k] if segments else []
        return np.ascontiguousarray(im), labels, segments


def rasterize_masks(segments, labels, hm, wm, img_px, overlap=True):
    """Polygon segments (pixels at img_px scale) -> instance masks at (hm,
    wm), as the JAX package fills them (reference polygons2masks[_overlap]):
    each polygon scaled to mask pixels and truncated to int32, filled by
    ``cv.fill_poly`` in descending order of its float area (``contour_area``
    of the scaled float polygon). With ``overlap`` one (hm, wm) int32 map,
    segment i written as i + 1 (the smaller on top); else (max(len(labels),
    1), hm, wm) uint8, one 0/1 mask per segment."""
    if overlap:
        out = np.zeros((hm, wm), np.int32)
    else:
        out = np.zeros((max(len(labels), 1), hm, wm), np.uint8)
    scale_x, scale_y = wm / img_px, hm / img_px
    areas = []
    polys = []
    for seg in segments:
        p = seg.copy()
        p[:, 0] *= scale_x
        p[:, 1] *= scale_y
        polys.append(p.astype(np.int32))
        areas.append(contour_area(p.astype(np.float32)))
    order = np.argsort(-np.asarray(areas)) if areas else []
    for i in order:
        if overlap:
            fill_poly(out, polys[i], int(i) + 1)
        else:
            fill_poly(out[i], polys[i], 1)
    return out


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


# -- process-pool batch building ------------------------------------------
# Augmented training (a mosaic: 4 decodes, a paste and a warp a sample) is
# held by the GIL in threads; as the reference's DataLoader workers
# (utils/dataloaders.py:148-163), a persistent spawn pool builds whole
# collated batches (numpy in, numpy out: workers never touch torch). A batch
# is a function of (seed, epoch, batch index), so the pool gives the batches
# of the in-process path.

_WORKER_LOADER = None


def _mp_init(loader):
    global _WORKER_LOADER
    _WORKER_LOADER = loader


def _mp_build(task):
    return _WORKER_LOADER._build(*task)


def _available_ram():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable"):
                return int(line.split()[1]) * 1024
    return 8 << 30


class Loader:
    """Fixed-shape batches over a ``YOLODataset``.

    Validation (``augment`` False): rect (aspect-sorted, per-batch shape) or
    square (img_size²) batches in index order, the final partial batch
    padded with copies of its last image (``real`` counts the others).
    Training: a permutation seeded by (seed + epoch), the JAX package's order
    for the same seed (or ``set_image_weights``' draw), the final partial
    batch dropped; host-augmented batches (``get_item``, or ``quad``
    batches), or, with ``device_aug``, ``raw_batch``es for the device mosaic.
    With ``workers`` > 1 a training loader builds its batches in a pool of
    spawned processes, at most workers + 2 batches in flight; ``close()``
    ends it. Sample i of an epoch draws from ``default_rng(seed * 100003 +
    epoch * 1009 + i)``, a quad batch's layout from ``(seed * 100003 + epoch
    * 1009 + bi * 7919) * 31 + 7``, wherever the batch is built."""

    def __init__(self, dataset: YOLODataset, batch_size=16, max_labels=128, workers=8,
                 rect=False, stride=32, pad=0.5, seed=0, shuffle=None, quad=False,
                 masks=False, mask_ratio=4, overlap=True):
        self.ds = dataset
        self.bs = batch_size
        if max_labels in (None, "auto"):
            # the label capacity of the dataset's busiest image, in 8s
            most = max((len(lb) for lb in dataset.labels), default=1)
            max_labels = max(8, int(math.ceil(most / 8) * 8))
        self.max_labels = max_labels
        self.workers = max(1, min(workers, os.cpu_count() or 1))
        self.shuffle = dataset.augment if shuffle is None else shuffle
        self.drop_last = dataset.augment
        self.raw_images = dataset.augment and dataset.device_aug
        self.masks = masks
        self.mask_ratio = mask_ratio
        self.overlap = overlap
        # quad batches (reference collate_fn4): every 4 samples -> one 2s x 2s image
        self.quad = bool(quad)
        if self.quad:
            if batch_size % 4:
                raise ValueError("--quad needs batch_size divisible by 4")
            if self.raw_images or rect or masks:
                raise ValueError("--quad is incompatible with the device mosaic, rect "
                                 "batches and segmentation masks")
        # the JAX package's rule (dataset.py:603): a training set never gets
        # rect batches
        self.rect = rect and not dataset.augment
        self.stride = stride
        self.pad = pad
        self.seed = seed
        self.epoch = 0
        self.weighted_indices = None  # set per epoch by set_image_weights
        self._rect_plan = None
        if self.rect:
            self.shuffle = False
            self.drop_last = False
        self.use_processes = dataset.augment and self.workers > 1
        self._mp_pool = None

    def __getstate__(self):  # what the worker processes receive
        return {k: v for k, v in self.__dict__.items() if k != "_mp_pool"}

    def __len__(self):
        if self.rect:
            return math.ceil(len(self.ds) / self.bs)
        n = len(self.weighted_indices) if self.weighted_indices is not None else len(self.ds)
        return n // self.bs if self.drop_last else math.ceil(n / self.bs)

    def _indices(self, epoch):
        if self.weighted_indices is not None:
            return np.asarray(self.weighted_indices)
        idx = np.arange(len(self.ds))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(idx)
        return idx

    def set_image_weights(self, weights, epoch=0):
        """Resample the epoch's indices by per-image weights (reference
        image_weights resampling, train.py:359-362)."""
        rng = np.random.default_rng(self.seed + epoch)
        n = len(self.ds)
        p = np.asarray(weights, np.float64)
        p = p / p.sum() if p.sum() > 0 else None
        self.weighted_indices = rng.choice(n, size=n, replace=True, p=p)

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
        hm = wm = s // self.mask_ratio
        if self.masks:
            gt_masks = (np.zeros((bs, hm, wm), np.int32) if self.overlap
                        else np.zeros((bs, self.max_labels, hm, wm), np.uint8))
        for b, (im, labels, segments) in enumerate(samples):
            images[b] = im[..., ::-1]  # BGR -> RGB
            n = min(len(labels), self.max_labels)
            if n:
                targets[b, :n] = labels[:n]
                valid[b, :n] = True
            if self.masks and segments:
                m = rasterize_masks(segments[:self.max_labels], labels, hm, wm, s,
                                    overlap=self.overlap)
                if self.overlap:
                    gt_masks[b] = m
                else:
                    gt_masks[b, :m.shape[0]] = m
        batch = {"images": images, "targets": targets, "valid": valid}
        if self.masks:
            batch["masks"] = gt_masks
        return batch

    def _quad_collate(self, samples, rng):
        """Quad batches (reference collate_fn4, utils/dataloaders.py:865-891):
        each group of 4 samples becomes one 2s x 2s image, the first sample
        upsampled 2x (half the time) or the four tiled 2x2. The label
        capacity grows 4x so that a tiled group never truncates."""
        s = self.ds.img_size
        n_out = len(samples) // 4
        cap = self.max_labels * 4
        images = np.zeros((n_out, 2 * s, 2 * s, 3), np.uint8)
        targets = np.zeros((n_out, cap, 5), np.float32)
        valid = np.zeros((n_out, cap), bool)
        for o in range(n_out):
            group = samples[4 * o:4 * o + 4]
            if rng.random() < 0.5:
                im, lab, _ = group[0]
                images[o] = resize(im, (2 * s, 2 * s), "linear")[..., ::-1]
            else:
                rows = []
                for q, (im, labels, _) in enumerate(group):
                    dy, dx = divmod(q, 2)
                    images[o, dy * s:(dy + 1) * s, dx * s:(dx + 1) * s] = im[..., ::-1]
                    if len(labels):
                        lb = labels.copy()
                        lb[:, 1] = (lb[:, 1] + dx) / 2
                        lb[:, 2] = (lb[:, 2] + dy) / 2
                        lb[:, 3:5] /= 2
                        rows.append(lb)
                lab = np.concatenate(rows) if rows else np.zeros((0, 5), np.float32)
            n = min(len(lab), cap)
            if n:
                targets[o, :n] = lab[:n]
                valid[o, :n] = True
        return {"images": images, "targets": targets, "valid": valid}

    def _build(self, chunk, real, base_seed, bi, map_fn=map):
        """Batch ``bi`` of an epoch: indices ``chunk`` (``real`` of them not
        padding), sample i drawing from ``default_rng(base_seed + i)``."""
        if self.raw_images:
            batch = raw_batch(self.ds, chunk, self.max_labels)
        else:
            fetch = lambda i: self.ds.get_item(i, np.random.default_rng(base_seed + i))
            samples = list(map_fn(fetch, chunk[:real]))
            samples += [samples[-1]] * (len(chunk) - real)
            if self.quad:
                batch = self._quad_collate(samples, np.random.default_rng(
                    (base_seed + bi * 7919) * 31 + 7))
            else:
                batch = self._collate(samples)
        batch["real"] = real
        batch["indices"] = np.asarray(chunk, np.int64)
        return batch

    def _pool(self):
        if self._mp_pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: the parent holds CUDA and torch's threads. A
            # worker that dies breaks the pool, and the next batch raises
            self._mp_pool = ProcessPoolExecutor(self.workers, mp.get_context("spawn"),
                                                initializer=_mp_init, initargs=(self,))
        return self._mp_pool

    def close(self):
        """End the worker processes, if any were started: batches not begun
        are cancelled, those being built are finished."""
        if self._mp_pool is not None:
            self._mp_pool.shutdown(wait=True, cancel_futures=True)
            self._mp_pool = None

    def _mp_iter(self, tasks):
        """The pool's batches in order, at most workers + 2 in flight (a fast
        pool must not pile up batches in its result queue)."""
        pool = self._pool()
        tasks = iter(tasks)
        pending = deque(pool.submit(_mp_build, t)
                        for t in itertools.islice(tasks, self.workers + 2))
        while pending:
            batch = pending.popleft().result()
            nxt = next(tasks, None)
            if nxt is not None:
                pending.append(pool.submit(_mp_build, nxt))
            yield batch

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
        base_seed = self.seed * 100003 + self.epoch * 1009
        tasks = (self._pad_chunk(idx[bi * self.bs:(bi + 1) * self.bs]) + (base_seed, bi)
                 for bi in range(len(self)))
        with ThreadPoolExecutor(self.workers) as threads:
            batches = (self._mp_iter(tasks) if self.use_processes
                       else (self._build(*t, map_fn=threads.map) for t in tasks))
            for batch in batches:
                batch["paths"] = [self.ds.im_files[i] for i in batch["indices"]]
                yield batch


def create_loader(path, img_size=640, batch_size=16, augment=False, max_labels=128,
                  workers=8, seed=0, single_cls=False, cache=None, device_aug=False,
                  rect=False, stride=32, pad=0.5, hyp=None, shuffle=None, quad=False,
                  masks=False, mask_ratio=4, overlap=True):
    """Dataset + loader in one call (reference create_dataloader,
    utils/dataloaders.py:106-164). Validation (augment False) sees every
    image once and pads the final batch; training (augment True) shuffles
    (unless ``shuffle`` is False) and drops the final partial batch. cache:
    None = for a training set, the RAM cache when the decoded images fit in
    0.4 of the available memory (once per worker process), False = off,
    "ram" or "disk"."""
    ds = YOLODataset(path, img_size=img_size, single_cls=single_cls, cache=cache or None,
                     augment=augment, device_aug=device_aug, hyp=hyp)
    loader = Loader(ds, batch_size=batch_size, max_labels=max_labels, workers=workers,
                    rect=rect, stride=stride, pad=pad, seed=seed, shuffle=shuffle, quad=quad,
                    masks=masks, mask_ratio=mask_ratio, overlap=overlap)
    if cache is None and augment:
        # the reference's check_cache_ram (dataloaders.py:614-631)
        copies = loader.workers if loader.use_processes else 1
        if len(ds) * img_size * img_size * 3 * 1.1 * copies < 0.4 * _available_ram():
            ds.cache = "ram"
    return ds, loader
