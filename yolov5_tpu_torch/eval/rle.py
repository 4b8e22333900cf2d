"""COCO run-length-encoded masks, pycocotools-compatible (numpy).

A copy of ``yolov5_tpu/eval/rle.py``: the wire format that
``pycocotools.mask.encode`` writes into the reference's segm JSON
(segment/val.py:72-101) and COCOeval(iouType='segm') reads:
- masks are run-length encoded in column-major (Fortran) order, runs
  alternating background/foreground, always starting with a (possibly
  zero-length) background run;
- the "counts" string is pycocotools' LEB128-style ascii packing
  (rleToString/rleFrString in maskApi.c): 5 data bits per char, offset by
  48, bit 0x20 = continuation, counts from the third onward delta-encoded
  against the count two positions back.

``polygons_to_rle`` fills with ``data.cv.fill_poly`` (the pixels of
``cv2.fillPoly``), so no function here needs OpenCV.
"""

from __future__ import annotations

import numpy as np

from yolov5_tpu_torch.data.cv import fill_poly


def mask_to_rle(mask) -> dict:
    """Binary (h, w) mask -> {"size": [h, w], "counts": <ascii str>}, as
    ``pycocotools.mask.encode(np.asfortranarray(mask))`` with the counts
    decoded to str."""
    m = np.asarray(mask)
    h, w = m.shape
    flat = (m > 0).flatten(order="F").astype(np.int8)
    if flat.size == 0:
        counts = []
    else:
        change = np.flatnonzero(np.diff(flat)) + 1
        bounds = np.concatenate([[0], change, [flat.size]])
        counts = np.diff(bounds).tolist()
        if flat[0] == 1:
            counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": _counts_to_string(counts)}


def rle_to_mask(rle) -> np.ndarray:
    """{"size", "counts"} -> binary (h, w) uint8 mask; counts as the compact
    ascii string or an uncompressed list."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major layout


def rle_area(rle) -> int:
    """Foreground pixel count (``pycocotools.mask.area``)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts(counts)
    return int(sum(counts[1::2]))


def rle_iou(dt_rles, gt_rles, iscrowd=None) -> np.ndarray:
    """(n, m) mask IoU matrix (``pycocotools.mask.iou``): a crowd GT takes
    intersection over the detection's area. Exact, by decoding."""
    n, m = len(dt_rles), len(gt_rles)
    out = np.zeros((n, m), np.float64)
    if not n or not m:
        return out
    if iscrowd is None:
        iscrowd = np.zeros(m, bool)
    d = np.stack([rle_to_mask(r).reshape(-1) for r in dt_rles]).astype(bool)
    g = np.stack([rle_to_mask(r).reshape(-1) for r in gt_rles]).astype(bool)
    inter = d.astype(np.float64) @ g.T.astype(np.float64)
    da = d.sum(1, dtype=np.float64)[:, None]
    ga = g.sum(1, dtype=np.float64)[None, :]
    union = np.where(np.asarray(iscrowd)[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _counts_to_string(counts) -> str:
    chars = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])  # delta against two runs back
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            # stop when the remaining bits are all sign bits and the sign is
            # already in c's bit 0x10
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return "".join(chars)


def _string_to_counts(s) -> list:
    if isinstance(s, bytes):
        s = s.decode()
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))  # sign-extend
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def polygons_to_rle(polys, h, w) -> dict:
    """Polygons [(n, 2) xy arrays] filled at (h, w) and RLE-encoded: the GT
    side of segm scoring. Vertices are rounded to int32, as the JAX package
    hands them to ``cv2.fillPoly``."""
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(p) < 3:
            continue
        fill_poly(mask, np.round(p).astype(np.int32), 1)
    return mask_to_rle(mask)
