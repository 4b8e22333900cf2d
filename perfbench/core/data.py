"""Seeded inputs: frames of blocks, boxes and noise, drawn on the device
from a ``torch.Generator`` in a few large calls, their letterbox, and 24-bit
BMP files with YOLO label files.

The letterbox is a plain copy of yolov5's (ultralytics/yolov5 v7.0
utils/augmentations.py letterbox, pad 114, centred), for the two cases the
cells use: no resize, or an exact halving, which OpenCV's INTER_LINEAR
computes as the rounded mean of each 2x2 block.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

PAD = 114


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def frames(gen: torch.Generator, n: int, h: int, w: int) -> torch.Tensor:
    """(n, h, w, 3) uint8 RGB on the generator's device: a coarse colour
    grid, 4-15 solid boxes and noise."""
    dev = gen.device
    cell = 40
    gh, gw = -(-h // cell), -(-w // cell)
    coarse = torch.randint(0, 200, (n, gh, gw, 3), generator=gen, device=dev, dtype=torch.uint8)
    out = coarse.repeat_interleave(cell, 1).repeat_interleave(cell, 2)[:, :h, :w].contiguous()
    out += torch.randint(0, 56, (n, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
    k = 16
    count = torch.randint(4, k, (n,), generator=gen, device=dev).tolist()
    bh = torch.randint(16, h // 3, (n, k), generator=gen, device=dev)
    bw = torch.randint(16, w // 3, (n, k), generator=gen, device=dev)
    y = (torch.rand((n, k), generator=gen, device=dev) * (h - bh)).long()
    x = (torch.rand((n, k), generator=gen, device=dev) * (w - bw)).long()
    colour = torch.randint(0, 256, (n, k, 3), generator=gen, device=dev, dtype=torch.uint8)
    boxes = torch.stack([y, x, y + bh, x + bw], -1).tolist()
    for i in range(n):
        for j in range(count[i]):
            y1, x1, y2, x2 = boxes[i][j]
            out[i, y1:y2, x1:x2] = colour[i, j]
    return out


def pads(h0: int, w0: int, h: int, w: int):
    """(top, left) of an (h0, w0) image centred in (h, w), as yolov5 rounds."""
    dh, dw = (h - h0) / 2, (w - w0) / 2
    return int(round(dh - 0.1)), int(round(dw - 0.1))


def letterbox(ims: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(n, h0, w0, 3) uint8 -> (n, h, w, 3): scaled by min(h/h0, w/w0), which
    must be 1 or 1/2, and padded with 114 around the centre."""
    n, h0, w0, _ = ims.shape
    r = min(h / h0, w / w0)
    if r == 0.5:
        s = ims.view(n, h0 // 2, 2, w0 // 2, 2, 3).to(torch.int16).sum((2, 4))
        ims = ((s + 2) >> 2).to(torch.uint8)
    elif r < 1:
        raise ValueError(f"letterbox: scale {r} (only 1 or 1/2)")
    nh, nw = ims.shape[1:3]
    top, left = pads(nh, nw, h, w)
    out = torch.full((n, h, w, 3), PAD, dtype=torch.uint8, device=ims.device)
    out[:, top:top + nh, left:left + nw] = ims
    return out


def write_bmp(path, im_rgb: np.ndarray) -> None:
    """A 24-bit bottom-up BMP of an (h, w, 3) RGB image."""
    h, w, _ = im_rgb.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = im_rgb[::-1, :, ::-1].reshape(h, 3 * w)
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    Path(path).write_bytes(header + info + rows.tobytes())


def write_labels(path, rows) -> None:
    """YOLO label lines ``cls x y w h`` (normalised) from (n, 5) rows."""
    Path(path).write_text("".join(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} {r[4]:.6f}\n"
                                  for r in rows))


def read_labels(path) -> np.ndarray:
    """The (n, 5) float32 rows of a label file, as yolov5's loader parses
    them: duplicate rows dropped, the first of each kept in order."""
    lines = [ln.split() for ln in Path(path).read_text().splitlines() if ln.strip()]
    rows = np.asarray(lines, np.float32).reshape(-1, 5)
    _, keep = np.unique(rows, axis=0, return_index=True)
    return rows[np.sort(keep)]
