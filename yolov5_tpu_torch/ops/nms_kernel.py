"""K1: exact greedy NMS keep mask over score-sorted candidates.

``greedy_nms`` launches the CUDA kernel ``csrc/greedy_nms.cu`` on CUDA
tensors and takes the plain PyTorch version ``greedy_nms_plain`` on CPU
tensors; on CUDA tensors it launches or raises. The JAX package's
counterparts are ``yolov5_tpu/ops/nms_pallas.py::greedy_nms_pallas`` and
``yolov5_tpu/ops/nms.py::_greedy_nms_tiled``.

Both versions keep candidate i iff its score is > 0 and no earlier kept
candidate overlaps it with IoU > ``iou_thres``, and stop at the
``max_det``-th keep or at the first score <= 0: later entries are False.
The IoU is the arithmetic of ``nms_pallas._iou`` in fp32, each operation
rounded on its own, so the two masks are equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from yolov5_tpu_torch import _build

# kept boxes live in the kernel's shared memory: 16 B each (64 KiB here)
MAX_DET_LIMIT = 4096


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., n, 4), b (..., m, 4) xyxy -> (..., n, m) IoU, as nms_pallas._iou."""
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])).clamp(min=0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])).clamp(min=0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-7)


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                     max_det: int, tile: int = 256) -> torch.Tensor:
    """Plain version: a straight greedy walk per image, tile by tile.

    The IoUs of a tile against the boxes kept so far, and within the tile,
    are computed on the tensors' device; the walk itself runs on the host."""
    bs, k, _ = boxes.shape
    thres = float(np.float32(iou_thres))  # the kernel compares in fp32
    keep = np.zeros((bs, k), bool)
    for b in range(bs):
        kept = boxes.new_zeros((0, 4))
        n_kept = 0
        for start in range(0, k, tile):
            tb = boxes[b, start:start + tile]
            ts = scores[b, start:start + tile].cpu().numpy()
            dead = np.zeros(len(tb), bool)
            if n_kept:
                dead = (_iou(kept, tb) > thres).any(0).cpu().numpy()
            later = (_iou(tb, tb) > thres).cpu().numpy()
            alive = np.zeros(len(tb), bool)
            stop = False
            for j in range(len(tb)):
                if not ts[j] > 0:  # sorted: padding from here on
                    stop = True
                    break
                if dead[j]:
                    continue
                alive[j] = True
                dead |= later[j]
                n_kept += 1
                if n_kept == max_det:
                    stop = True
                    break
            keep[b, start:start + len(tb)] = alive
            if stop:
                break
            kept = torch.cat([kept, tb[torch.from_numpy(alive).to(tb.device)]])
    return torch.from_numpy(keep).to(boxes.device)


def greedy_nms_traceable(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                         max_det: int) -> torch.Tensor:
    """The same keep mask as torch ops that ``torch.export`` traces with
    fixed shapes, for a graph that holds the NMS (``export --nms``): the
    JAX package's ``_greedy_nms_scan`` walk, one candidate a step of a
    ``while_loop`` over the whole batch, ending where every image has
    reached its first score <= 0 or its ``max_det``-th keep. The (bs, K, K)
    overlaps are computed once, so K is the export's cap (1024), not a
    validation cap."""
    from torch._higher_order_ops.while_loop import while_loop

    bs, k, _ = boxes.shape
    idx = torch.arange(k, device=boxes.device)
    earlier = idx[:, None] < idx[None, :]
    over = (_iou(boxes, boxes) > float(np.float32(iou_thres))) & earlier  # (bs, K, K)
    live = torch.cat([scores > 0, scores.new_zeros((bs, 1), dtype=torch.bool)], 1)

    def at(x, i):  # x[:, i] for a 0-d index tensor
        return torch.index_select(x, 1, i.reshape(1)).squeeze(1)

    def cond(i, keep, n_kept):
        return (at(live, i) & (n_kept < max_det)).any()

    def body(i, keep, n_kept):
        hit = (torch.index_select(over, 2, i.reshape(1)).squeeze(2) & keep).any(1)
        new = at(live, i) & (n_kept < max_det) & ~hit
        keep = keep | ((idx == i)[None, :] & new[:, None])
        return i + 1, keep, n_kept + new.to(n_kept.dtype)

    start = (torch.zeros((), dtype=torch.int64, device=boxes.device),
             torch.zeros((bs, k), dtype=torch.bool, device=boxes.device),
             torch.zeros((bs,), dtype=torch.int64, device=boxes.device))
    return while_loop(cond, body, start)[1]


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int) -> torch.Tensor:
    """boxes (bs, K, 4) f32 xyxy sorted by descending score; scores (bs, K)
    f32 with padding <= 0. Returns the keep mask (bs, K) bool."""
    if boxes.device.type == "cpu":
        return greedy_nms_plain(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_nms: no kernel for device {boxes.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"greedy_nms: boxes and scores must be float32, got "
                         f"{boxes.dtype}, {scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"greedy_nms: need boxes (bs, K, 4) and scores (bs, K); got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}")
    if not 1 <= max_det <= MAX_DET_LIMIT:
        raise ValueError(f"greedy_nms: max_det must be in [1, {MAX_DET_LIMIT}], got {max_det}")
    if not (boxes.is_contiguous() and scores.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("greedy_nms: boxes and scores must be contiguous, boxes 16-byte aligned")
    if scores.device != boxes.device:
        raise ValueError("greedy_nms: boxes and scores must be on one device")
    bs, k, _ = boxes.shape
    keep = torch.empty((bs, k), dtype=torch.bool, device=boxes.device)
    lib = _build.load()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.yolo_greedy_nms(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                                 bs, k, float(iou_thres), min(max_det, k), stream)
    _build.check(rc, "greedy_nms")
    greedy_nms.launches += 1
    return keep


greedy_nms.launches = 0
