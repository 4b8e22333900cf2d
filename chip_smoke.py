#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds yolov5_tpu_torch/csrc/*.cu for sm_90a;
  3. K2 (fused stem) against its plain PyTorch version on the card;
  4. K1 (greedy NMS) against its plain PyTorch version on the card, masks equal;
  5. the slice: yolov5s at 640 px in bf16 with seeded random weights,
     letterboxed requests, Detector.__call__ at b32, boxes scaled back; both
     kernels' launch counters must rise, and the detections must agree with
     the same batch run through the plain versions;
  6. times on the card (CUDA events, after warmup).
Then one JSON line with each kernel's launches, error and times, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; without
a CUDA device, or without the package beside this script, it exits non-zero
before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 32
IMGSZ = 640
# (h, w) of the source images: all need padding only at 640, no resize
SOURCE_SHAPES = ((480, 640), (640, 480), (640, 640), (640, 320))


def _import_port():
    import yolov5_tpu_torch

    where = Path(yolov5_tpu_torch.__file__).resolve().parent.parent
    if where != REPO:
        raise RuntimeError(f"yolov5_tpu_torch imported from {where}, not from {REPO}")


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def routed(stem=None, nms=None):
    """Route the model's stem and the NMS tail to other functions for a while
    (the plain versions, to compare the slice with them)."""
    import yolov5_tpu_torch.models.layers as layers_mod
    import yolov5_tpu_torch.ops.nms as nms_mod

    saved = layers_mod.stem_conv, nms_mod.greedy_nms
    layers_mod.stem_conv = stem or saved[0]
    nms_mod.greedy_nms = nms or saved[1]
    try:
        yield
    finally:
        layers_mod.stem_conv, nms_mod.greedy_nms = saved


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import torch

    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(f"device: {smi[0]} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.device_count()} visible")
    return smi[0]


def phase_build():
    from yolov5_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"build: {path.relative_to(REPO)} from {len(_build.sources())} sources "
          f"in {time.perf_counter() - t0:.1f} s")


def phase_stem(dev):
    """K2 against F.conv2d in f32 (TF32 off) + bias + SiLU, cast once."""
    import torch

    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"f32": 0.0, "bf16": 0.0}
    for B, H, W, c2 in ((4, 640, 640, 32), (2, 480, 320, 16), (2, 640, 640, 80)):
        x32 = torch.rand((B, 3, H, W), generator=gen, device=dev)
        x32 = x32.contiguous(memory_format=torch.channels_last)
        w = (torch.rand((c2, 3, 6, 6), generator=gen, device=dev) - 0.5) * 0.4
        b = (torch.rand((c2,), generator=gen, device=dev) - 0.5)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            got, ref = stem_conv(x, w, b), stem_conv_plain(x, w, b)
            torch.cuda.synchronize()
            if not got.is_contiguous(memory_format=torch.channels_last) or got.dtype != dt:
                raise AssertionError("stem_conv: output not channels_last in x's dtype")
            err = (got.float() - ref.float()).abs()
            if dt == torch.float32:  # tolerance of tests/test_stem_pallas.py
                bad = err > 1e-5 + 1e-4 * ref.abs()
            else:  # one bf16 rounding of two f32 sums that differ in order
                bad = err > bf16_ulp(ref) + 1e-5
            key = "f32" if dt == torch.float32 else "bf16"
            worst[key] = max(worst[key], err.max().item())
            if bad.any():
                raise AssertionError(f"stem_conv {B}x{H}x{W} c2={c2} {dt}: {int(bad.sum())} "
                                     f"elements out of tolerance, max err {err.max().item()}")
    print(f"K2 stem_conv vs plain: 3 shapes x (f32, bf16) ok; max abs err "
          f"f32 {worst['f32']:.3g} (atol 1e-5, rtol 1e-4), bf16 {worst['bf16']:.3g} (1 ulp)")
    return worst["bf16"]


def _sorted_candidates(gen, bs, k, dev, offset_classes=0):
    """Random xyxy boxes sorted by descending score, a tail of padding
    scores, optionally class-offset (+cls*7680) as the NMS tail does."""
    import torch

    from yolov5_tpu_torch.ops.nms import MAX_WH

    xy = torch.rand((bs, k, 2), generator=gen, device=dev) * 600
    wh = 5 + torch.rand((bs, k, 2), generator=gen, device=dev) * 55
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand((bs, k), generator=gen, device=dev).sort(-1, descending=True).values
    scores[:, int(0.9 * k):] = 0.0
    if offset_classes:
        cls = torch.randint(0, offset_classes, (bs, k), generator=gen, device=dev)
        boxes = boxes + (cls.float() * MAX_WH)[..., None]
    return boxes.contiguous(), scores.contiguous()


def phase_nms(dev):
    """K1 against the plain greedy walk: keep masks exactly equal."""
    import torch

    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    n = 0
    worst = 0
    for k, bs in ((300, 4), (2048, 4), (30720, 2)):
        for thres in (0.45, 0.6):
            for max_det in (300, 1000):
                for offset in (0, 80):
                    boxes, scores = _sorted_candidates(gen, bs, k, dev, offset)
                    got = greedy_nms(boxes, scores, thres, max_det)
                    ref = greedy_nms_plain(boxes, scores, thres, max_det)
                    torch.cuda.synchronize()
                    worst = max(worst, int((got != ref).sum()))
                    if worst:
                        raise AssertionError(
                            f"greedy_nms K={k} thres={thres} max_det={max_det} offset={offset}: "
                            f"{worst} mask entries differ")
                    n += 1
    print(f"K1 greedy_nms vs plain: {n} cases (K 300/2048/30720, thres 0.45/0.6, "
          f"max_det 300/1000, with and without class offsets) masks equal")
    return float(worst)


def random_weights(cfg, seed):
    """Seeded random yolov5 weights with BN statistics and Detect biases that
    give the head real candidates (a fresh init's priors gate nearly all out)."""
    import torch

    from yolov5_tpu_torch.models.yolo import DetectionModel

    sd = DetectionModel(cfg, seed=seed).state_dict()
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith("bn.weight") or k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=gen)
        elif k.endswith("bn.bias"):
            v.normal_(0.0, 0.1, generator=gen)
        elif k.endswith("running_mean"):
            v.normal_(0.0, 0.2, generator=gen)
        elif ".m." in k and k.startswith("model.24.") and k.endswith("bias"):
            v.normal_(-1.0, 0.5, generator=gen)
    return sd


def phase_slice(dev):
    """yolov5s@640 bf16 through Detector.__call__ at b32, against the twins."""
    import numpy as np
    import torch

    from yolov5_tpu_torch.data.letterbox import letterbox
    from yolov5_tpu_torch.infer import Detector
    from yolov5_tpu_torch.ops.boxes import scale_boxes
    from yolov5_tpu_torch.ops.nms import non_max_suppression_from_maps
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    det = Detector(random_weights("yolov5s", 0), cfg="yolov5s", imgsz=IMGSZ, half=True,
                   device=dev)
    rng = np.random.default_rng(0)
    sources = [rng.integers(0, 256, (*SOURCE_SHAPES[i % 4], 3), dtype=np.uint8)
               for i in range(BATCH)]
    batch = np.stack([letterbox(im, IMGSZ)[0] for im in sources])
    kw = dict(conf_thres=0.01, iou_thres=0.45, max_det=1000, max_nms=2048)
    det.warmup(batch_size=2)

    # the counted run of the main path
    stem_conv.launches = greedy_nms.launches = 0
    dets = det(batch, **kw)
    torch.cuda.synchronize()
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the slice did not launch {name}")

    counts = dets.counts.tolist()
    if min(counts) < 1:
        raise AssertionError(f"empty detections: {counts}")
    n_boxes = 0
    for i, im in enumerate(sources):
        v = dets.valid[i]
        out = scale_boxes((IMGSZ, IMGSZ), dets.boxes[i][v], im.shape[:2])
        h, w = im.shape[:2]
        if not (torch.isfinite(out).all() and (out[:, [0, 2]] <= w).all()
                and (out[:, [1, 3]] <= h).all() and (out >= 0).all()):
            raise AssertionError(f"image {i}: scaled boxes outside {w}x{h}")
        n_boxes += len(out)

    # the same batch through the plain versions on the card
    maps = det.forward_maps(batch)
    with routed(stem=stem_conv_plain):
        maps_plain = det.forward_maps(batch)
    map_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(maps, maps_plain))
    map_tol = max(8 * bf16_ulp(a.float().abs().max()).item() for a in maps)
    if map_err > map_tol:
        raise AssertionError(f"raw maps, stem kernel vs plain: max err {map_err} > {map_tol}")
    nms_kw = dict(kw, nc=det.nc)
    with routed(nms=greedy_nms_plain):
        d_plain = non_max_suppression_from_maps(maps, det.anchors, det.stride, **nms_kw)
    d_kern = non_max_suppression_from_maps(maps, det.anchors, det.stride, **nms_kw)
    for f in d_kern._fields:
        if not torch.equal(getattr(d_kern, f), getattr(d_plain, f)):
            raise AssertionError(f"detections on the same maps, K1 vs plain: {f} differ")
    with routed(stem=stem_conv_plain, nms=greedy_nms_plain):
        d_twin = det(batch, **kw)
    twin_counts = d_twin.counts.tolist()
    both = dets.valid & d_twin.valid
    box_err = (dets.boxes[both] - d_twin.boxes[both]).abs().max().item()
    print(f"slice: yolov5s {IMGSZ}px bf16 b{BATCH}, {n_boxes} detections "
          f"(per image {min(counts)}..{max(counts)}), launches {launches}; "
          f"maps vs plain stem max err {map_err:.3g} (tol {map_tol:.3g}); "
          f"K1 vs plain on the same maps: equal; full twin path counts "
          f"{'equal' if counts == twin_counts else 'DIFFER'}, box err {box_err:.3g}")
    if counts != twin_counts:
        raise AssertionError(f"valid counts, kernels vs plain: {counts} vs {twin_counts}")
    if box_err > 1.0:  # px at 640: a few bf16 ulps of the decoded coordinates
        raise AssertionError(f"boxes, kernels vs plain: max err {box_err} px")
    return det, batch, launches


def phase_times(dev, det, batch):
    """Times on the card by CUDA events, after warmup."""
    import torch
    import torch.nn.functional as F

    from yolov5_tpu_torch.ops.nms import non_max_suppression_from_maps
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for the plain convs
    images = torch.from_numpy(batch).to(dev)
    fwd = cuda_ms(lambda: det.forward_maps(images), iters=20)
    full = cuda_ms(lambda: det(images), iters=20)  # serving defaults: conf 0.25, cap 2048
    maps = det.forward_maps(images)
    nms_kw = dict(conf_thres=0.01, max_nms=2048, max_det=1000, nc=det.nc)
    nms = cuda_ms(lambda: non_max_suppression_from_maps(maps, det.anchors, det.stride,
                                                        **nms_kw), iters=10)

    # K1 at the main path's shape: the 2048-candidate, class-offset boxes
    captured = {}

    def capture(boxes, scores, thres, max_det):
        captured.update(args=(boxes, scores, thres, max_det))
        return greedy_nms(boxes, scores, thres, max_det)

    with routed(nms=capture):
        non_max_suppression_from_maps(maps, det.anchors, det.stride, **nms_kw)
    k1 = cuda_ms(lambda: greedy_nms(*captured["args"]), iters=20)
    k1_plain = cuda_ms(lambda: greedy_nms_plain(*captured["args"]), iters=2, warmup=1)

    # K2 at the main path's shape
    stem = det.model.model[0]
    x = images.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
    w, b = stem.conv.weight, stem.conv.bias
    k2 = cuda_ms(lambda: stem_conv(x, w, b), iters=50)
    k2_plain = cuda_ms(lambda: stem_conv_plain(x, w, b), iters=50)
    k2_cudnn_bf16 = cuda_ms(lambda: F.silu(F.conv2d(x, w, b, stride=2, padding=2)), iters=50)
    print(f"times: forward {BATCH / fwd * 1e3:.1f} img/s ({fwd:.3f} ms/b{BATCH}); "
          f"forward+NMS {BATCH / full * 1e3:.1f} img/s ({full:.3f} ms); "
          f"NMS at the 2048 cap {nms / BATCH:.4f} ms/img; "
          f"K1 {k1:.3f} ms vs plain {k1_plain:.3f} ms (b{BATCH}x2048); "
          f"K2 {k2:.3f} ms vs plain {k2_plain:.3f} ms (f32 cuDNN, TF32) vs cuDNN bf16 "
          f"{k2_cudnn_bf16:.3f} ms (b{BATCH}x640, bf16)")
    return {"greedy_nms": (k1, k1_plain), "stem_conv": (k2, k2_plain)}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    _import_port()
    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    stem_err = phase_stem(dev)
    nms_err = phase_nms(dev)
    det, batch, launches = phase_slice(dev)
    times = phase_times(dev, det, batch)
    kernels = [
        {"name": "greedy_nms", "route": "cuda", "source": "yolov5_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "yolov5_tpu/ops/nms_pallas.py:106", "launches": launches["greedy_nms"],
         "max_abs_err": nms_err, "ms": times["greedy_nms"][0], "plain_ms": times["greedy_nms"][1]},
        {"name": "stem_conv", "route": "cuda", "source": "yolov5_tpu_torch/csrc/stem_conv.cu",
         "replaces": "yolov5_tpu/ops/stem_pallas.py:180", "launches": launches["stem_conv"],
         "max_abs_err": stem_err, "ms": times["stem_conv"][0], "plain_ms": times["stem_conv"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
