"""The training set resident in device memory.

The port of ``yolov5_tpu/data/device_cache.py``: every image is decoded and
resized once (long side = img_size, content in the top-left of an s x s
buffer, RGB), labels are padded to a fixed count, and the whole set is
uploaded once. Each step then ships only a (bs,) index vector and gathers
its batch on the card (``train.trainer.make_train_step`` with ``cache``),
where the mosaic also draws its partners from the whole set. For
segmentation the polygons ride along: each densified to V vertices
(``ops.rasterize.densify_polygon``, the original vertices kept), normalised
to the image content and stored as float16 (0.3 px at 640, under a mask
pixel).
"""

from __future__ import annotations

import numpy as np
import torch

from yolov5_tpu_torch.data.dataset import raw_batch
from yolov5_tpu_torch.ops.rasterize import densify_polygon


def build_cache_arrays(ds, max_labels=128, segments_v=0):
    """Decoded set as numpy arrays: images (N, s, s, 3) uint8 RGB, hw (N, 2)
    int32 content sizes, targets (N, M, 5) float32, valid (N, M) bool; with
    ``segments_v`` > 0 also segments (N, M, V, 2) float16, label j's polygon
    in row j (zeros where an image has none)."""
    out = raw_batch(ds, range(len(ds)), max_labels)
    if segments_v:
        segs = np.zeros((len(ds), max_labels, segments_v, 2), np.float16)
        for i in range(len(ds)):
            for j, seg in enumerate(ds.segments[i][:max_labels]):
                segs[i, j] = densify_polygon(seg, segments_v)
        out["segments"] = segs
    return out


def cache_nbytes(ds, max_labels=128, segments_v=0):
    s = ds.img_size
    return len(ds) * (s * s * 3 + max_labels * (24 + segments_v * 4) + 16)


def device_memory_budget(device, fraction=0.35):
    """A conservative share of the free memory of ``device``: the card's
    (``torch.cuda.mem_get_info``), or the host's available RAM for "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
    else:
        free = 0
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    free = int(line.split()[1]) * 1024
    return int(free * fraction)


def to_device(arrays: dict, device) -> dict:
    """Upload the cache arrays once."""
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def index_batches(loader, whole=False):
    """The epoch's shuffled index batches of ``loader``, the
    final one padded with its last index: the only thing the host ships per
    step. ``whole``: the global batches of a sharded loader (every rank's
    rows, interleaved as the shard strides them), which a rank gathers
    from its copy of the cache to augment the global batch."""
    idx = loader._order(loader.epoch) if whole else loader._indices(loader.epoch)
    bs = loader.bs * loader.world if whole else loader.bs
    for bi in range(len(loader)):
        chunk = [int(i) for i in idx[bi * bs:(bi + 1) * bs]]
        real = len(chunk)
        chunk += [chunk[-1]] * (bs - real)
        yield {"idx": np.asarray(chunk, np.int64), "real": real}
