#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: serving, validation,
training, the detect CLI's run, the HTTP service, segmentation predict,
segmentation training and validation, classification, every config of the
model zoo, export with the exported backends, and the benchmark and CI entry
points.

    python3 chip_smoke.py
    python3 chip_smoke.py --zoo-only   # phases 1, 2 and 19 alone
    python3 chip_smoke.py --bench-only # phases 1, 2 and 21 alone

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds yolov5_tpu_torch/csrc/*.cu for sm_90a;
  3. K2 (fused stem) against its plain PyTorch version on the card: 8
     shapes (B = 1, H = 2, output widths off the 64-pixel tile, every c2) x
     f32/bf16 inputs x f32/bf16 weights; f32 within atol 1e-5, rtol 1e-4,
     bf16 within one ulp;
  4. K1 (greedy NMS) against its plain PyTorch version on the card, masks
     equal: 24 cases at the paths' sizes and 21 edge cases (K at the 512-
     candidate chunk edges, max_det and padding mid-chunk, identical boxes,
     a threshold tie across a chunk, thresholds < 0);
  5. the slice: yolov5s at 640 px in bf16 with seeded random weights,
     letterboxed requests, Detector.__call__ at b32, boxes scaled back; both
     kernels' launch counters must rise; the raw maps agree with the plain
     stem's, K1's detections on the same maps equal its plain version's,
     and against the whole path through both plain versions the counts are
     equal and, at the serving defaults, the detections match as sets
     (same class, box within 1 px): K2 sums in another order than the plain
     f32 convolution, so bf16 scores may differ in the last place;
  6. times on the card (CUDA events, after warmup): each kernel at the main
     path's shapes beside its bound (computed here from the shapes and, for
     K1, from the IoUs greedy needs on the captured inputs), its plain
     version, its launches per call and, for K2, cuDNN's bf16 conv + SiLU
     as a yardstick; K2 also in f32;
  7. val data: 128 BMP images (4 shapes, long side 640) of filled
     rectangles of 3 classes, YOLO labels and a data YAML, in a temporary
     directory;
  8. val: eval.evaluator.run (the validation path: rect batches, multi-label
     NMS at the 30 720 cap, native-space matching) for yolov5s at 640 px,
     b32, bf16: (a) with the kernels, (b) through K1's plain version, with
     identical detections and mAP, and through both plain versions, with
     equal counts and >= 99% of the detections matched within 1 px; (c)
     save_hybrid, mAP50 >= 0.99; (d) save_json with COCO scoring; (e) TTA,
     equal to its run through K1's plain version, and against its runs
     through both plain versions equal in counts at conf 0.001 and with
     >= 99% of either run's detections matched within 1 px at the serving
     defaults (conf 0.25, IoU 0.45, max_det 1000); both launch counters
     must rise in (a), (c), (d) and (e);
  9. val times: the b32 and b1 speeds, K1 at the eval cap beside its plain
     version, and the multi-label selection sort;
 10. train data: 128 BMP train images written as the val set (4 shapes, long
     side 640, so nothing is resized), beside it, with a train+val YAML;
 11. train: train.run for yolov5s at 640 px, b32, bf16 autocast, hyp
     scratch-low (mosaic 1.0) with device augmentation and the device cache,
     3 epochs of 4 steps, EMA validation after each: every logged loss
     finite, both launch counters rising in each epoch's validation,
     last.ckpt and best.ckpt written, val.run on best.ckpt giving that
     epoch's metrics, and a run cut after epoch 2 and resumed from its
     last.ckpt giving epoch 3's losses of the uninterrupted run;
 12. train times: ms per b32 step with and without device augmentation,
     device augmentation alone, img/s, peak memory, one profiler line;
 16. train_host (run after 12, before 13): 128 train BMPs whose long side is not
     640 (32 each of 375x500, 600x800, 720x1280, 640x427; half labelled by
     polygons, so that copy-paste runs) and 32 such val BMPs (the loader's
     area and linear resizes, with numpy); train.run for yolov5s at 640 px,
     b32, bf16 autocast, hyp scratch-high (mosaic, mixup 0.1, copy-paste 0.1),
     host augmentation in min(16, cpu count) worker processes and the
     prefetcher, 2 epochs of 4 steps: finite losses, both launch counters
     rising in each epoch's validation, last.ckpt and best.ckpt written,
     val.run on best.ckpt giving that epoch's metrics; one epoch each of
     --quad, --multi-scale (host), --multi-scale --device-aug --cache device
     and --rect, two of --image-weights, each with finite losses; the
     loader's img/s alone, the numpy warp and resize per image, the step fed
     from host batches through the prefetcher (CUDA events, the copy
     included) beside the step on a batch already on the card, and one
     profiler line over 3 such steps;
 13. detect: infer.run (what the detect CLI calls) for yolov5s at 640 px, b32,
     bf16, over 32 of the val BMPs with seeded random weights whose BN
     statistics are the images' own (so detections depend on the image),
     writing label txts, the CSV and annotated BMPs: both launch counters
     rise; every txt row equals Detector.__call__ on the same letterboxed
     batch with the boxes scaled back; every BMP reads back at its source's
     size; against the runs through both plain versions, in f32 the counts
     are equal and >= 99% of the detections match within 1 px (in bf16,
     reported: a bf16 forward of image-dependent weights turns K2's one-ulp
     differences into other detections); wall ms/img of the pipelined loop
     and device ms per batch;
 14. serve: serve.make_handler (yolov5s, f32) on a ThreadingHTTPServer bound
     to 127.0.0.1: 32 BMP bodies (16 raw, 16 multipart) answered with the
     records of Detector.__call__ + scale_boxes_np on the same image; both
     launch counters rise; /healthz, 401 without the key, 400 for a PNG body
     (naming OpenCV where it is not installed); p50/p95 request latency;
 15. segment predict: infer_segment.run for yolov5s-seg at 640 px, f32,
     conf 0.25, over the 32 sources, writing overlays and polygon txts (the
     numpy border follower): both launch counters rise; against the run
     through both plain versions the counts are equal and matched
     detections' binary masks have IoU >= 0.99; ms/img, and K1 at 1 x 25 200
     candidates beside its bound and its plain version;
 17. segment train and val (run last): 64 train and 32 val BMPs of the val
     shapes, every label a polygon (triangles and 12-vertex ellipses);
     ``segment train`` (``yolov5_tpu_torch.segment.main`` in this process)
     for yolov5s-seg at 640 px, b16, bf16 autocast, hyp scratch-low, one
     epoch with host augmentation in min(8, cpu count) worker processes and
     one with --device-aug --cache device, each ending in the EMA validation
     through K1 and K2: finite losses, seg_overflow printed, both launch
     counters rising in each; ``segment val --half --save-json`` on the
     device run's best.ckpt equal (1e-6) to its epoch's EMA validation, COCO
     bbox and segm scored; in f32, evaluate_segment with the kernels against
     K1's plain version (identical rows and metrics) and against both plain
     versions (equal counts, >= 99% of the detections scoring over 1.01x
     their image's max_det cut matched within 1 px, every matched mask IoU
     >= 0.99); K1 at b16 x 30 720 and K2 at the seg val stem beside their
     bounds and plain versions; the b16 step by CUDA events with device
     augmentation and on a host-augmented batch already on the card.
 18. classify (run after 17): an ImageFolder of 10 classes, 640 train and 320 val
     BMPs of ImageNet-like shapes (256x256, 240x320, 320x240, 288x384);
     ``classify train`` (``yolov5_tpu_torch.classify.main`` in this
     process) for yolov5s-cls at 224 px, b64, f32, 3 epochs from the device
     cache (device augmentation) and 1 with --no-device-aug: finite losses,
     K2 launched 5 times an epoch (the BN-folded EMA validation) and K1
     never; ``classify val`` on best.ckpt: 5 K2 launches and the best
     epoch's top-1/top-5 exactly; in f32 without TF32, validate_classify
     through K2 against its run through K2's plain version (logits within
     1e-3 of each row's largest, >= 99% of top-1 predictions equal, top-1
     and top-5 within 1/320); K2 at b64 x 224² f32 within atol 1e-5, rtol
     1e-4 of its plain version, beside its bound, its plain version and
     cuDNN's f32 conv + SiLU; ``classify predict`` on 32 val BMPs (one K2
     launch each, top-5 equal to a direct call and to
     hub.load(task="classify")); the b64 step by CUDA events, its profile
     line and peak memory.
 19. zoo (run last): (a) every bundled config (hub.list_models) at full
     width with weights calibrated on 2 val BMPs (BN scales U(0.1, 0.4):
     with U(0.5, 1.5) the deepest random models are chaotic, and K2's last
     digits become other detections), BN folded, f32 without
     TF32, forward + NMS at b2 and 640 px (1280 for yolov5{n,s,m,l,x}6),
     conf 0.001, IoU 0.6, max_det 300: K1 launched for every config, K2
     exactly where the YAML's stem is the 6x6/s2 SiLU Conv (not yolov3*, not
     yolov5s-LeakyReLU); against the same batch through both plain versions
     equal counts and >= 99% of the detections scoring over 1.01x their
     image's cut matched within 1 px; (b) yolov5s-transformer,
     yolov5s-ghost and yolov3 at full width, 3 train steps each at b16 640
     bf16 autocast with device augmentation from the device cache: finite
     losses, ms/step by CUDA events, peak memory; (c) ``train --cfg
     yolov5s-transformer`` (1 epoch, b32, --device-aug --cache device, its
     EMA validation), then ``val --half`` and ``detect --half`` on its
     best.ckpt, K1 and K2 rising in each; (d) the b16 bf16 forward of
     yolov3, yolov3-spp, yolov3-tiny, yolov5s-ghost, yolov5s-transformer
     and yolov5s6 at 1280, a profile line of the ghost forward, K1 at the
     2048 cap of yolov5-p2's (640 px) and yolov5s6's (1280 px) 102 000
     candidates (masks equal to the plain version's), K2 at b8 x 1280² bf16
     within one ulp of its plain version, each beside its bound, its plain
     version and (K2) cuDNN's bf16 conv + SiLU; the phase's wall time.
 20. export (run after 19): yolov5s at 640 px, f32 without TF32, phase 13's
     calibrated weights: (a) ``python -m yolov5_tpu_torch.export --include
     ckpt pt2 onnx`` (``main`` in this process) at b32 and b1, each format's
     size and seconds; (b) Detector(.onnx) on the card, b32 over the smoke
     sources: decoded predictions within 1e-3 of the largest value of the
     BN-folded Detector.forward (K2), at conf 0.25 equal counts and >= 99%
     of the detections within 1 px, K1 launched; (c) phase 11's
     trained best.ckpt (the val set's classes) exported at b32: ``val
     --weights .onnx`` against ``val`` of its fused .ckpt at --no-rect: P, R,
     mAP50, mAP50-95 within 1e-3 and mAP50 above 0, equal detection counts,
     >= 99% within 1 px, K1 launched; (d) ``detect --weights .onnx`` (b1) over the 32 sources:
     every txt equals Detector.__call__ on the image; (e) a KServe v2 server
     on 127.0.0.1 running the b1 .onnx through the port's runtime:
     Detector("triton+http://...") gives (b)'s detections on KSERVE_IMAGES
     images, K1 launched; (f) ``dnn=True``: within 2e-3 of the runtime where
     OpenCV is installed, else ImportError naming it; (g) CUDA-event times of
     the runtime's b32 forward beside Detector.forward in f32 and bf16, a
     profile line (its launches), autobatch's batch for the yolov5s 640 bf16
     train step and one step at it with its peak memory beside the limit,
     model_info; the phase's wall time. K2 is counted on (b)-(e) too, and
     must launch nowhere: the exported graph holds the plain stem.
 21. bench (run last): (a) ``yolov5_tpu_torch.bench.main()`` in this
     process at its defaults (yolov5s 640 px b32 bf16 on the card): its last
     line must have the root bench.py's keys, the card's name from
     nvidia-smi, a positive value, and K1 and K2 launches equal to the
     counters' (both > 0); (b) K2 at the bench's b32 x 640² bf16 stem (within
     one bf16 ulp of its plain version) and K1 at its serve call's b32 x 2048
     candidates, max_det 300 (masks equal), each beside its bound, its plain
     version and (K2) cuDNN, and K2 beside phase 6's reading and the spread
     of the earlier readings in PERF.md, printed, not gated; (c) ``benchmarks`` on phase 13's calibrated
     weights (fused .ckpt) at 640 px: ckpt, pt2 and onnx exported, each
     passing its parity gate; then on phase 11's best.ckpt with the val
     set and --hard-fail HARD_FAIL: one val row per format Detector opens;
     (d) ``export --include pt2 --nms`` at b32 loaded on the card with
     torch.export.load alone: valid counts equal to the port's
     non_max_suppression (K1) at the export's settings on the same forward
     exported without it, every box within 1e-3 px, classes int32, no
     kernel launched by the graph; (e) ``ci_smoke --imgsz 96`` on the card,
     CI SMOKE PASSED, both kernels launched; (f) the phase's wall time.
Then one JSON line with each kernel's launches (in all, and per main-path
call), error, times, bound and yardstick (and under "zoo" phase 19's, under
"export" phase 20's numbers and K1's launches by path, under "bench" phase
21's readings at the bench's shapes; and at the top level under "bench" the
bench's line and the benchmarks rows), and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; without
a CUDA device, or without the package beside this script, it exits non-zero
before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BATCH = 32
IMGSZ = 640
# (h, w) of the source images: all need padding only at 640, no resize
SOURCE_SHAPES = ((480, 640), (640, 480), (640, 640), (640, 320))
VAL_IMAGES = 128
# (h, w) of the val images: long side 640, so nothing is resized on the way
VAL_SHAPES = ((480, 640), (640, 480), (640, 640), (360, 640))
VAL_CLASSES = 3
TRAIN_IMAGES = 128
TRAIN_EPOCHS = 3
# epoch 3's mean losses, resumed from epoch 2's last.ckpt against the
# uninterrupted run: equal but for the card's nondeterministic float sums
# (atomics in the backward), which four steps cannot grow past this
RESUME_RTOL = 1e-3
# phase 16: images whose long side is not 640, so that the loader resizes
HOST_SHAPES = ((375, 500), (600, 800), (720, 1280), (640, 427))
HOST_TRAIN_IMAGES = 128
HOST_VAL_IMAGES = 32
HOST_WORKERS = min(16, os.cpu_count() or 1)
# phases 13-15: the first SMOKE_SOURCES val BMPs, and the mean of the Detect
# biases of their weights (20-80 detections an image at conf 0.25)
SMOKE_SOURCES = 32
HEAD_BIAS = -3.0
# phase 17: segmentation training and validation, yolov5s-seg at b16 (the
# default of segment train), polygon-labelled BMPs of the val shapes
SEG_TRAIN_IMAGES = 64
SEG_VAL_IMAGES = 32
SEG_BATCH = 16
SEG_WORKERS = min(8, os.cpu_count() or 1)
# the share of segment val's detections (f32) that the run through both
# plain versions must match within 1 px, as phase 8's
SEG_MATCH_MIN = 0.99
# phase 18: classification, yolov5s-cls at 224 px, b64, f32 (the JAX
# package's defaults; the reference's classify/train.py --img 224), the 10
# classes of yolov5_tpu/data/configs/ImageNet10.yaml, ImageNet-like sources
CLS_IMGSZ = 224
CLS_BATCH = 64
CLS_CLASSES = 10
CLS_TRAIN_PER_CLASS = 64
CLS_VAL_PER_CLASS = 32
CLS_SHAPES = ((256, 256), (240, 320), (320, 240), (288, 384))
CLS_EPOCHS = 3
CLS_PREDICT = 32
# the share of top-1 predictions that the path through K2's plain version
# must give as the path through K2 does
CLS_MATCH_MIN = 0.99
# class colours of the generated sets (tests/torch_port_helpers.py)
CLASS_COLORS = ((200, 60, 40), (40, 180, 60), (50, 70, 220), (210, 200, 50), (160, 60, 200),
                (40, 200, 200), (240, 130, 30), (120, 120, 120), (250, 250, 250), (20, 20, 20))


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


@contextlib.contextmanager
def uncounted():
    """Leave the kernels' launch counters as they were: a run made only to
    compare with a plain version is not a run of the path."""
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv

    saved = stem_conv.launches, greedy_nms.launches
    try:
        yield
    finally:
        stem_conv.launches, greedy_nms.launches = saved


def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import torch

    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@contextlib.contextmanager
def captured_detections():
    """Record the per-image detections (numpy rows) of every batch that
    eval.evaluator scores while the context is open."""
    from yolov5_tpu_torch.eval import evaluator

    saved = evaluator.detections_to_numpy
    batches = []

    def record(dets):
        rows = saved(dets)
        batches.append(rows)
        return rows

    evaluator.detections_to_numpy = record
    try:
        yield batches
    finally:
        evaluator.detections_to_numpy = saved


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0])
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

    torch_tf32_off()
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"f32": 0.0, "bf16": 0.0}
    n = 0
    # the main path's shape, other widths, and edges: B = 1, H = 2, output
    # widths that are not a multiple of the kernel's 64-pixel tile
    for B, H, W, c2 in ((4, 640, 640, 32), (2, 480, 320, 16), (2, 640, 640, 80), (1, 2, 2, 32),
                        (1, 2, 258, 48), (3, 36, 142, 64), (2, 130, 6, 80), (2, 64, 96, 16)):
        x32 = torch.rand((B, 3, H, W), generator=gen, device=dev)
        x32 = x32.contiguous(memory_format=torch.channels_last)
        w32 = (torch.rand((c2, 3, 6, 6), generator=gen, device=dev) - 0.5) * 0.4
        b32 = (torch.rand((c2,), generator=gen, device=dev) - 0.5)
        for dt, wdt in itertools.product((torch.float32, torch.bfloat16), repeat=2):
            x, w, b = x32.to(dt), w32.to(wdt), b32.to(wdt)
            n += 1
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
                raise AssertionError(f"stem_conv {B}x{H}x{W} c2={c2} x {dt} w {wdt}: "
                                     f"{int(bad.sum())} "
                                     f"elements out of tolerance, max err {err.max().item()}")
    print(f"K2 stem_conv vs plain: {n} cases (8 shapes x x f32/bf16 x w f32/bf16) ok; max abs err "
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
    n_edge = 0
    for name, (boxes, scores, thres, max_det) in _nms_edge_cases(gen, dev):
        got = greedy_nms(boxes, scores, thres, max_det)
        ref = greedy_nms_plain(boxes, scores, thres, max_det)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"greedy_nms edge case {name}: {int((got != ref).sum())} "
                                 "mask entries differ")
        n_edge += 1
    print(f"K1 greedy_nms vs plain: {n} cases (K 300/2048/30720, thres 0.45/0.6, "
          f"max_det 300/1000, with and without class offsets) and {n_edge} edge cases "
          f"(K at chunk edges, max_det and padding mid-chunk, identical boxes, a threshold "
          f"tie across a chunk, thres < 0) masks equal")
    return float(worst)


def _nms_edge_cases(gen, dev):
    """(name, (boxes, scores, thres, max_det)) around K1's 512-candidate
    chunks and 32-bit words, its stops and its early reject."""
    import numpy as np
    import torch

    for k in (1, 63, 64, 65, 511, 512, 513, 1025, 2049):
        boxes, scores = _sorted_candidates(gen, 3, k, dev, offset_classes=3)
        yield f"K={k}", (boxes, scores, 0.45, 4096)
    for max_det in (1, 37, 513):
        boxes, scores = _sorted_candidates(gen, 3, 3000, dev, offset_classes=80)
        yield f"max_det={max_det}", (boxes, scores, 0.5, max_det)
    for pad_from in (0, 40, 512, 700):
        boxes, scores = _sorted_candidates(gen, 2, 1200, dev, offset_classes=80)
        scores[:, pad_from:pad_from + 5] = 0.0  # positive again after the padding
        yield f"pad_from={pad_from}", (boxes, scores.contiguous(), 0.45, 1000)
    same = torch.tensor([[10.0, 20.0, 50.0, 80.0]], device=dev).repeat(2, 1500, 1)
    line = torch.linspace(1.0, 0.1, 1500, device=dev).repeat(2, 1)
    yield "identical boxes", (same.contiguous(), line.contiguous(), 0.45, 1000)
    far = torch.tensor([[1000.0 * i, 5000.0, 1000.0 * i + 3, 5003.0] for i in range(511)])
    pair = torch.tensor([[200.0, 0.0, 210.0, 10.0], [205.0, 0.0, 215.0, 10.0]])
    f = np.float32
    tie = float(f(50) / (f(f(100) + f(100)) - f(50) + f(1e-7)))
    boxes = torch.cat([far, pair])[None].to(dev)
    scores = torch.linspace(1.0, 0.5, 513, device=dev)[None]
    for thres in (tie, float(np.nextafter(f(tie), f(0)))):
        yield f"tie thres={thres!r}", (boxes, scores, thres, 1000)
    boxes, scores = _sorted_candidates(gen, 2, 900, dev)
    for thres in (-0.5, 0.0):
        yield f"thres={thres}", (boxes, scores, thres, 1000)


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
    from yolov5_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression_from_maps
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
    # the whole path through both plain versions. K1 is exact, but the plain
    # stem is cuDNN's sequential f32 sum and K2 sums on the tensor cores in
    # another order, so a few bf16 stem outputs differ by one ulp (phase 3)
    # and the bf16 network carries that to the scores: detections are
    # compared as sets, at conf 0.01 (many near-tied scores from random
    # weights, reported) and at the serving defaults (required)
    with routed(stem=stem_conv_plain, nms=greedy_nms_plain):
        d_twin = det(batch, **kw)
        d_twin_def = det(batch)
    d_def = det(batch)
    twin_counts = d_twin.counts.tolist()
    low = match_detections(detections_to_numpy(dets), detections_to_numpy(d_twin))
    serve = match_detections(detections_to_numpy(d_def), detections_to_numpy(d_twin_def))
    print(f"slice: yolov5s {IMGSZ}px bf16 b{BATCH}, {n_boxes} detections "
          f"(per image {min(counts)}..{max(counts)}), launches {launches}; "
          f"maps vs plain stem max err {map_err:.3g} (tol {map_tol:.3g}); "
          f"K1 vs plain on the same maps: equal; against the plain twin path: counts "
          f"{'equal' if counts == twin_counts else 'DIFFER'}, {low[0]}/{low[1]} detections "
          f"matched within 1 px at conf 0.01; at the serving defaults (conf 0.25) counts "
          f"{'equal' if d_def.counts.tolist() == d_twin_def.counts.tolist() else 'DIFFER'}, "
          f"{serve[0]}/{serve[1]} matched, max box err {serve[3]:.3g} px, max score diff "
          f"{serve[2]:.3g}")
    if counts != twin_counts or d_def.counts.tolist() != d_twin_def.counts.tolist():
        raise AssertionError("valid counts, kernels vs plain twin differ")
    if serve[0] < 0.99 * serve[1]:
        raise AssertionError(f"serving defaults: only {serve[0]}/{serve[1]} detections of the "
                             "kernel path within 1 px of the plain twin's")
    return det, batch, launches


def match_detections(a, b, px=1.0):
    """Per-image detection rows [x1, y1, x2, y2, conf, cls, ...] of two runs:
    how many of a's rows b has too (same class, every coordinate within px;
    in a's score order, each b row used once), of how many, the largest
    score difference and box difference over the matched pairs."""
    hit = total = 0
    score_diff = box_err = 0.0
    for ra, rb in zip(a, b):
        used = np.zeros(len(rb), bool)
        total += len(ra)
        for r in ra[np.argsort(-ra[:, 4], kind="stable")]:
            d = np.abs(rb[:, :4] - r[:4]).max(1) if len(rb) else np.zeros(0)
            ok = ~used & (rb[:, 5] == r[5]) & (d <= px)
            if ok.any():
                j = np.flatnonzero(ok)[np.argmin(np.abs(rb[ok, 4] - r[4]))]
                used[j] = True
                hit += 1
                score_diff = max(score_diff, abs(float(rb[j, 4] - r[4])))
                box_err = max(box_err, float(d[j]))
    return hit, total, score_diff, box_err


def phase_times(dev, det, batch, launches, smi):
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
    k1_bound, k1_by, n_iou = nms_bound_ms(*captured["args"])

    # K2 at the main path's shape, and in f32 (the val CLI's default dtype)
    stem = det.model.model[0]
    x = images.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
    w, b = stem.conv.weight, stem.conv.bias
    k2 = cuda_ms(lambda: stem_conv(x, w, b), iters=50)
    k2_alone = cuda_ms(stem_kernel_call(x, w, b), iters=50)
    k2_plain = cuda_ms(lambda: stem_conv_plain(x, w, b), iters=50)
    k2_cudnn_bf16 = cuda_ms(lambda: F.silu(F.conv2d(x, w, b, stride=2, padding=2)), iters=50)
    k2_bound, k2_by = stem_bound_ms(x, w.shape[0])
    x32, w32, b32 = x.float(), w.float(), b.float()
    k2_f32 = cuda_ms(lambda: stem_conv(x32, w32, b32), iters=20)
    k2_f32_bound, _ = stem_bound_ms(x32, w.shape[0])
    print(f"times: forward {BATCH / fwd * 1e3:.1f} img/s ({fwd:.3f} ms/b{BATCH}); "
          f"forward+NMS {BATCH / full * 1e3:.1f} img/s ({full:.3f} ms); "
          f"NMS at the 2048 cap {nms / BATCH:.4f} ms/img | {smi}")
    print(f"K1 b{BATCH}x2048 IoU 0.45 max_det 1000: {k1:.4f} ms; bound {k1_bound:.5f} ms "
          f"({k1_by}: {n_iou} IoUs greedy needs on these inputs), {100 * k1_bound / k1:.2f}% of "
          f"it; plain {k1_plain:.3f} ms; no library call; "
          f"launches per call {launches['greedy_nms']} | {smi}")
    print(f"K2 b{BATCH}x640 bf16 c2={w.shape[0]}: {k2:.4f} ms through its wrapper (weights "
          f"packed per call), {k2_alone:.4f} ms the kernel alone; bound {k2_bound:.4f} ms "
          f"({k2_by}), {100 * k2_bound / k2:.1f}% of it; plain {k2_plain:.3f} ms (f32 cuDNN, "
          f"TF32); cuDNN bf16 conv + SiLU {k2_cudnn_bf16:.3f} ms; f32 {k2_f32:.4f} ms (bound "
          f"{k2_f32_bound:.4f} ms, {100 * k2_f32_bound / k2_f32:.1f}%); launches per call "
          f"{launches['stem_conv']} | {smi}")
    if not k2 < k2_cudnn_bf16:
        raise AssertionError(f"K2 {k2} ms is not faster than cuDNN bf16 {k2_cudnn_bf16} ms")
    return {"greedy_nms": dict(ms=k1, plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
                               library_ms=None),
            "stem_conv": dict(ms=k2, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
                              library_ms=k2_cudnn_bf16)}


def stem_kernel_call(x, w, b):
    """K2's C entry point on packed weights, without the wrapper's per-call
    packing: the kernel's own time."""
    import torch

    from yolov5_tpu_torch import _build
    from yolov5_tpu_torch.ops.stem import pack_stem_weights

    w_hi, w_lo = pack_stem_weights(w)
    bk = b.float().contiguous()
    B, c2, H, W = x.shape[0], w.shape[0], x.shape[2], x.shape[3]
    y = torch.empty((B, c2, H // 2, W // 2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), w_hi.data_ptr(), None if w_lo is None else w_lo.data_ptr(),
            bk.data_ptr(), y.data_ptr(), B, H, W, c2, 0 if x.dtype == torch.float32 else 1, stream)
    alive = (w_hi, w_lo, bk, y)  # the pointers in args stay valid while call lives

    def call():
        _build.check(lib.yolo_stem_conv(*args), "stem_conv")
        return alive

    return call


# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12
IOU_FLOPS = 17  # f32 operations of one IoU and its compare (nms_pallas._iou)


def stem_bound_ms(x, c2):
    """Least time of K2 on x: the input read and the output written once at
    the memory rate, against 2 x 108 operations an output at the bf16 peak
    (an f32 input runs three bf16 products on the tensor cores)."""
    B, _, H, W = x.shape
    outputs = B * (H // 2) * (W // 2) * c2
    nbytes = x.numel() * x.element_size() + outputs * x.element_size()
    flops = 2 * 108 * outputs * (3 if x.element_size() == 4 else 1)
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOP_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def nms_bound_ms(boxes, scores, thres, max_det):
    """Least time of K1 on these inputs: boxes and scores read and the mask
    written once, against the IoUs exact greedy needs here (each reached
    candidate against the keeps before it) at the f32 peak. Returns the
    bound, what sets it, and the IoU count."""
    import torch

    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms_plain

    keep = greedy_nms_plain(boxes, scores, thres, max_det).long()
    count = keep.cumsum(1)
    k = scores.shape[1]
    idx = torch.arange(k, device=boxes.device)

    def first(mask):  # per image, the index of the first True, or k
        return torch.where(mask, idx, k).min(1).values

    end = torch.minimum(first(~(scores > 0)), first(count >= max_det) + 1)
    n_iou = int(((count - keep) * (idx[None, :] < end[:, None])).sum())
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + keep.numel()
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, n_iou * IOU_FLOPS / F32_FLOP_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", n_iou


def write_split(root, split, n, seed, shapes=VAL_SHAPES, polygons=False):
    """n BMPs of the (h, w) ``shapes`` in turn with 1-6 filled rectangles
    each, on a noisy background, one per cell of a 3x2 grid so that no two
    overlap, and their YOLO labels (with ``polygons``, every second image's
    as the rectangles' corner polygons), under images/<split> and
    labels/<split>. Returns the number of labels."""
    from yolov5_tpu_torch.data.imageio import imwrite

    root = Path(root)
    (root / "images" / split).mkdir(parents=True)
    (root / "labels" / split).mkdir(parents=True)
    rng = np.random.default_rng(seed)
    n_labels = 0
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        im = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        rows = []
        for cell in rng.permutation(6)[:rng.integers(1, 7)]:
            cw, ch = w / 3, h / 2
            bw, bh = rng.uniform(0.3, 0.8) * cw, rng.uniform(0.3, 0.8) * ch
            x0 = int((cell % 3) * cw + rng.uniform(0, cw - bw))
            y0 = int((cell // 3) * ch + rng.uniform(0, ch - bh))
            x1, y1 = x0 + int(bw), y0 + int(bh)
            c = int(rng.integers(0, VAL_CLASSES))
            im[y0:y1, x0:x1] = ((90, 200, 40), (230, 60, 120), (40, 120, 250))[c]
            if polygons and i % 2 == 0:
                rows.append(f"{c} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in (
                    (x0, y0), (x1, y0), (x1, y1), (x0, y1))))
            else:
                rows.append(f"{c} {(x0 + x1) / 2 / w:.6f} {(y0 + y1) / 2 / h:.6f} "
                            f"{(x1 - x0) / w:.6f} {(y1 - y0) / h:.6f}")
        imwrite(root / "images" / split / f"{i:04d}.bmp", im)
        (root / "labels" / split / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")
        n_labels += len(rows)
    return n_labels


def phase_val_data(root):
    """The VAL_IMAGES val set and a data YAML. Returns the YAML's path."""
    t0 = time.perf_counter()
    root = Path(root)
    n_labels = write_split(root, "val", VAL_IMAGES, seed=3)
    data = root / "val_shapes.yaml"
    names = ", ".join(f"shape{c}" for c in range(VAL_CLASSES))
    data.write_text(f"path: {root}\nval: images/val\nnc: {VAL_CLASSES}\nnames: [{names}]\n")
    print(f"val data: {VAL_IMAGES} BMP images of (h, w) {VAL_SHAPES}, {n_labels} labels "
          f"of {VAL_CLASSES} classes, in {time.perf_counter() - t0:.1f} s")
    return data


def _same_detections(a, b):
    """Two runs' captured detections are identical, batch by batch and
    image by image (count, boxes, scores, classes)."""
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(p, q) for p, q in zip(x, y))
        for x, y in zip(a, b))


def phase_val(dev, data, smi):
    """eval.evaluator.run for yolov5s@640 b32 bf16, with the kernels and
    through their plain versions; hybrid, COCO and TTA runs."""
    import torch

    from yolov5_tpu_torch.eval import evaluator
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    torch.backends.cudnn.allow_tf32 = False  # the plain stem is an f32 reference
    kw = dict(data=str(data), weights=random_weights("yolov5s", 0), cfg="yolov5s",
              imgsz=IMGSZ, batch_size=BATCH, half=True, device=dev, verbose=False)
    candidates = []  # per image, the candidates (score > 0) that reach K1

    def counted_plain(boxes, scores, thres, max_det):
        candidates.extend((scores > 0).sum(1).tolist())
        return greedy_nms_plain(boxes, scores, thres, max_det)

    def kernel_run(name, **extra):
        n0 = (stem_conv.launches, greedy_nms.launches)
        with captured_detections() as dets:
            res = evaluator.run(**kw, **extra)
        rose = (stem_conv.launches - n0[0], greedy_nms.launches - n0[1])
        if min(rose) < 1:
            raise AssertionError(f"val run ({name}): launches rose by {rose} (stem, nms)")
        return res, dets

    stem_conv.launches = greedy_nms.launches = 0
    t0 = time.perf_counter()
    a, dets_a = kernel_run("a")
    with captured_detections() as dets_b, routed(nms=counted_plain), uncounted():
        b = evaluator.run(**kw)
    with captured_detections() as dets_p, routed(stem_conv_plain, greedy_nms_plain):
        p = evaluator.run(**kw)
    plain = match_detections([r for batch in dets_a for r in batch],
                             [r for batch in dets_p for r in batch])
    same_counts = [len(r) for bt in dets_a for r in bt] == [len(r) for bt in dets_p for r in bt]
    n_dets = sum(len(r) for batch in dets_a for r in batch)
    n_rows = sum(len(batch) for batch in dets_a)  # images, padding included
    if n_dets < 1 or not candidates or min(candidates) < 1:
        raise AssertionError(f"val (a): {n_dets} detections; candidates reaching K1 "
                             f"per image {candidates[:8]}...")
    if not _same_detections(dets_a, dets_b):
        raise AssertionError("val: detections with the kernels differ from the run with "
                             "K1's plain version")
    metrics = ("mp", "mr", "map50", "map")
    if any(a[k] != b[k] for k in metrics):
        raise AssertionError(f"val: kernels {[a[k] for k in metrics]} vs plain "
                             f"{[b[k] for k in metrics]}")
    print(f"val (a) kernels vs (b) K1's plain version: {a['images']} images, {n_dets} "
          f"detections (mean {n_dets / n_rows:.1f} per image), identical; mean candidates "
          f"reaching K1 {sum(candidates) / len(candidates):.0f} per image; "
          + ", ".join(f"{k} {a[k]:.6f}" for k in metrics)
          + f"; (a) vs both plain versions: counts {'equal' if same_counts else 'DIFFER'}, "
          f"{plain[0]}/{plain[1]} detections matched within 1 px, max score diff "
          f"{plain[2]:.3g}, " + ", ".join(f"{k} {p[k]:.6f}" for k in metrics))
    if not same_counts or plain[0] < 0.99 * plain[1]:
        raise AssertionError(f"val (a) vs both plain versions: counts equal {same_counts}, "
                             f"{plain[0]}/{plain[1]} matched")

    c, _ = kernel_run("c", save_hybrid=True)
    if c["map50"] < 0.99:
        raise AssertionError(f"val save_hybrid: map50 {c['map50']} < 0.99")
    with tempfile.TemporaryDirectory() as tmp:
        d, _ = kernel_run("d", save_json=str(Path(tmp) / "dets.json"), coco91=False)
    if "coco" not in d:
        raise AssertionError("val save_json: COCO scoring did not run")
    e, dets_e = kernel_run("e", augment=True)
    with captured_detections() as dets_e2, routed(nms=greedy_nms_plain), uncounted():
        evaluator.run(**kw, augment=True)
    n_tta = sum(len(r) for batch in dets_e for r in batch)
    if n_tta < 1 or not _same_detections(dets_e, dets_e2):
        raise AssertionError(f"val TTA: {n_tta} detections; equal to K1's plain run: "
                             f"{_same_detections(dets_e, dets_e2)}")
    # TTA through both plain versions (K2 at TTA's scaled shapes), compared as
    # sets as the slice is. At val's conf 0.001 every image is cut at
    # max_det, so the counts must be equal, but random weights give many
    # near-tied scores and one bf16 ulp reorders greedy cascades (the match
    # is reported). At the serving defaults no image reaches max_det, so a
    # score at the conf threshold may cross it (the counts are reported),
    # and >= 99% of either run's detections must match
    serving = dict(conf_thres=0.25, iou_thres=0.45, max_det=1000)
    tta = []
    for extra in ({}, serving):
        if extra:
            _, dets_k = kernel_run("e, serving defaults", augment=True, **extra)
        else:
            dets_k = dets_e
        with captured_detections() as dets_p, routed(stem_conv_plain, greedy_nms_plain):
            evaluator.run(**kw, augment=True, **extra)
        rows_k = [r for batch in dets_k for r in batch]
        rows_p = [r for batch in dets_p for r in batch]
        tta.append(([len(r) for r in rows_k], [len(r) for r in rows_p],
                    *match_detections(rows_k, rows_p)))
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    print(f"val (c) save_hybrid map50 {c['map50']:.4f} map {c['map']:.4f}; (d) COCO "
          f"map {d['coco']['map']:.6f} map50 {d['coco']['map50']:.6f} (in-house map "
          f"{d['map']:.6f}); (e) TTA {n_tta} detections, equal to K1's plain run, map50 "
          f"{e['map50']:.6f}; vs both plain versions, "
          + "; ".join(f"at {name}: {sum(nk)} vs {sum(np_)} detections, counts equal in "
                      f"{sum(a == b for a, b in zip(nk, np_))}/{len(nk)} images, {hit}/{total} "
                      f"matched within 1 px, max score diff {diff:.3g}"
                      for name, (nk, np_, hit, total, diff, _) in
                      zip(("conf 0.001", "the serving defaults"), tta))
          + f"; launches over (a)-(e) {launches}; {time.perf_counter() - t0:.1f} s | {smi}")
    (k0, p0, *_), (k1, p1, hit, *_) = tta
    if k0 != p0 or hit < 0.99 * max(sum(k1), sum(p1)):
        raise AssertionError(f"val TTA vs both plain versions: counts at conf 0.001 equal "
                             f"{k0 == p0}; {hit} of {sum(k1)} and {sum(p1)} matched at the "
                             "serving defaults")
    return a, launches


def phase_val_times(dev, data, a, smi):
    """The val path's speeds, K1 at the eval cap, and the selection sort."""
    import torch

    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.eval import evaluator
    from yolov5_tpu_torch.infer import Detector
    from yolov5_tpu_torch.ops import nms as nms_mod
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.utils.general import check_dataset

    weights = random_weights("yolov5s", 0)
    run_kw = dict(weights=weights, cfg="yolov5s", imgsz=IMGSZ, half=True, device=dev,
                  verbose=False)
    # run (a) met each of its 4 batch shapes for the first time; a second
    # run finds cuDNN's plans for them made
    warm = evaluator.run(str(data), batch_size=BATCH, **run_kw)["speed_ms"]
    for name, s in (("first run (a)", a["speed_ms"]), ("second run", warm)):
        print(f"val times b{BATCH}, {name} (host clock, synchronised, first batch dropped): "
              f"forward {s['forward']:.4f} ms/img, NMS {s['nms']:.4f} ms/img, host "
              f"{s['host']:.4f} ms/img | {smi}")
    r = evaluator.run_speed(str(data), **run_kw)
    s1 = r["speed_ms"]
    print(f"val times b1 (run_speed: conf 0.25, iou 0.45): forward {s1['forward']:.4f} "
          f"ms/img, NMS {s1['nms']:.4f} ms/img, host {s1['host']:.4f} ms/img "
          f"| {smi}")

    # the largest val batch at the eval configuration, its K1 arguments captured
    det = Detector(weights, cfg="yolov5s", imgsz=IMGSZ, half=True, device=dev)
    split = check_dataset(str(data))["val"]
    _, loader = create_loader(split, img_size=IMGSZ, batch_size=BATCH, rect=True,
                              stride=max(det.stride))
    im_np = max((b["images"] for b in loader), key=lambda x: x.shape[1] * x.shape[2])
    images = torch.from_numpy(im_np).to(dev)
    preds = det.forward(images)
    kw = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, max_det=300,
              max_nms=30720)
    captured = {}

    def capture(boxes, scores, thres, max_det):
        captured.update(args=(boxes, scores, thres, max_det))
        return greedy_nms(boxes, scores, thres, max_det)

    with routed(nms=capture):
        nms_mod.non_max_suppression(preds, **kw)
    boxes, scores, thres, max_det = captured["args"]
    k1 = cuda_ms(lambda: greedy_nms(*captured["args"]), iters=20)
    k1_plain = cuda_ms(lambda: greedy_nms_plain(*captured["args"]), iters=2, warmup=1)
    k1_bound, k1_by, n_iou = nms_bound_ms(*captured["args"])
    fwd = cuda_ms(lambda: det.forward(images), iters=10)
    nms = cuda_ms(lambda: nms_mod.non_max_suppression(preds, **kw), iters=10)
    flat = preds[..., 5:] * preds[..., 4:5]
    flat = flat.reshape(flat.shape[0], -1)
    flat = torch.where(flat > kw["conf_thres"], flat, 0.0)
    sort = cuda_ms(lambda: nms_mod._select_k(flat, kw["max_nms"]), iters=10)
    print(f"val times at the eval configuration, b{images.shape[0]} "
          f"{tuple(images.shape[1:3])}: forward+decode {fwd:.3f} ms; NMS (multi-label, "
          f"cap {kw['max_nms']}) {nms:.3f} ms ({nms / images.shape[0]:.4f} ms/img); "
          f"selection sort of {tuple(flat.shape)} {sort:.3f} ms; K1 on "
          f"{tuple(boxes.shape[:2])} (IoU {thres:.2f}, max_det {max_det}, "
          f"{(scores > 0).sum(1).float().mean().item():.0f} candidates > 0 per image) "
          f"{k1:.4f} ms vs plain {k1_plain:.3f} ms; K1 bound {k1_bound:.5f} ms ({k1_by}: "
          f"{n_iou} IoUs), {100 * k1_bound / k1:.2f}% of it | {smi}")
    print(profile_line(lambda: nms_mod.non_max_suppression(det.forward(images), **kw),
                       f"val batch b{images.shape[0]} {tuple(images.shape[1:3])}", smi))
    return k1, k1_plain


def phase_train_data(root):
    """TRAIN_IMAGES train images beside the val set, and a train+val YAML."""
    t0 = time.perf_counter()
    root = Path(root)
    n_labels = write_split(root, "train", TRAIN_IMAGES, seed=4)
    data = root / "train_shapes.yaml"
    names = ", ".join(f"shape{c}" for c in range(VAL_CLASSES))
    data.write_text(f"path: {root}\ntrain: images/train\nval: images/val\n"
                    f"nc: {VAL_CLASSES}\nnames: [{names}]\n")
    print(f"train data: {TRAIN_IMAGES} BMP images of (h, w) {VAL_SHAPES}, {n_labels} labels, "
          f"in {time.perf_counter() - t0:.1f} s")
    return data


class _Cut(Exception):
    """Stops a training run after an epoch, as an interruption would."""


def _csv_rows(save_dir):
    import csv

    with open(Path(save_dir) / "results.csv") as f:
        return list(csv.DictReader(f))


def phase_train(dev, data, root, smi):
    """train.run: yolov5s 640 b32 bf16, device augmentation and cache, 3
    epochs of 4 steps with EMA validation; then val.run on best.ckpt, and a
    run cut after epoch 2 and resumed."""
    from yolov5_tpu_torch.eval import evaluator
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv
    from yolov5_tpu_torch.train.run import run
    from yolov5_tpu_torch.utils.callbacks import Callbacks

    counts = lambda: (stem_conv.launches, greedy_nms.launches)
    marks = []  # (epoch, counts after training, counts after validation)
    cb = Callbacks()
    cb.register_action("on_train_epoch_end", callback=lambda epoch: marks.append(
        [epoch, counts()]))
    cb.register_action("on_fit_epoch_end", callback=lambda epoch, fitness: marks[-1].append(
        counts()))
    kw = dict(data=str(data), cfg="yolov5s", hyp="scratch-low", epochs=TRAIN_EPOCHS,
              batch_size=BATCH, imgsz=IMGSZ, device_aug=True, cache="device", device=dev,
              workers=4, project=str(Path(root) / "runs"), exist_ok=True)

    # the counted run of the training path
    stem_conv.launches = greedy_nms.launches = 0
    t0 = time.perf_counter()
    best_fitness, _, save_dir = run(**kw, name="straight", callbacks=cb)
    wall = time.perf_counter() - t0
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    rows = _csv_rows(save_dir)
    if len(rows) != TRAIN_EPOCHS:
        raise AssertionError(f"train: {len(rows)} epochs in results.csv")
    losses = [[float(r[f"train/{k}"]) for k in ("box", "obj", "cls", "total")] for r in rows]
    if not np.isfinite(losses).all():
        raise AssertionError(f"train: losses not finite: {losses}")
    for epoch, after_train, after_val in marks:
        rose = [v - t for v, t in zip(after_val, after_train)]
        if min(rose) < 1:
            raise AssertionError(f"train: epoch {epoch} validation launched {rose} (stem, nms)")
    for name in ("last.ckpt", "best.ckpt"):
        if not (save_dir / name).exists():
            raise AssertionError(f"train: {name} not written")
    print(f"train: yolov5s {IMGSZ}px bf16 b{BATCH}, {TRAIN_EPOCHS} epochs x "
          f"{TRAIN_IMAGES // BATCH} steps, device aug + device cache, {wall:.1f} s; "
          f"losses (box, obj, cls, total) per epoch {np.round(losses, 5).tolist()}; "
          f"launches in per-epoch val {[[v - t for v, t in zip(a, b)] for _, b, a in marks]} "
          f"(stem, nms) | {smi}")

    # val.run on best.ckpt gives the training-time EMA validation of its epoch
    best_epoch = json.loads((save_dir / "best.ckpt.json").read_text())["epoch"]
    again = evaluator.run(str(data), weights=str(save_dir / "best.ckpt"), imgsz=IMGSZ,
                          batch_size=BATCH, half=True, rect=False, device=dev, verbose=False)
    metrics = ("mp", "mr", "map50", "map")
    pairs = {k: (float(rows[best_epoch][f"val/{k}"]), again[k]) for k in metrics}
    if any(abs(a - b) > 1e-6 for a, b in pairs.values()):
        raise AssertionError(f"train: val.run on best.ckpt {pairs} (training-time, val.run)")
    print(f"train: val.run on best.ckpt (epoch {best_epoch + 1}, fitness {best_fitness:.6f}) "
          f"reproduces its EMA validation: " + ", ".join(f"{k} {b:.6f}" for k, (_, b) in
                                                           pairs.items()))

    # cut after epoch 2, resume from its last.ckpt, compare epoch 3
    def cut(epoch, fitness):
        if epoch == 1:
            raise _Cut

    cut_cb = Callbacks()
    cut_cb.register_action("on_fit_epoch_end", callback=cut)
    try:
        run(**kw, name="cut", callbacks=cut_cb)
        raise AssertionError("train: the cut run was not cut")
    except _Cut:
        pass
    cut_dir = Path(root) / "runs" / "cut"
    run(data=str(data), resume=str(cut_dir / "last.ckpt"), project=str(Path(root) / "runs"),
        device=dev)
    resumed = _csv_rows(cut_dir)
    got = [float(resumed[-1][f"train/{k}"]) for k in ("box", "obj", "cls", "total")]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses[-1]))
    print(f"train: resumed epoch 3 losses {np.round(got, 6).tolist()} vs uninterrupted "
          f"{np.round(losses[-1], 6).tolist()}: max relative difference {rel:.3g} "
          f"(tolerance {RESUME_RTOL})")
    if len(resumed) != TRAIN_EPOCHS or rel > RESUME_RTOL:
        raise AssertionError(f"train: resume differs from the uninterrupted run ({rel})")
    return launches, save_dir / "best.ckpt"


def phase_train_times(dev, data, smi):
    """A yolov5s b32 640 train step by CUDA events: with and without device
    augmentation, the augmentation alone; img/s, peak memory, profile."""
    import torch

    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.data.device_aug import aug_generator, device_augment, mosaic_in_batch
    from yolov5_tpu_torch.data.device_cache import build_cache_arrays, to_device
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.loss import ComputeLoss
    from yolov5_tpu_torch.train.optim import Optimizer, ema_update
    from yolov5_tpu_torch.train.trainer import (GEOMETRY_KEYS, batch_stats, init_train_state,
                                                make_train_step, scale_hyp)
    from yolov5_tpu_torch.utils.general import check_dataset
    from yolov5_tpu_torch.utils.hyp import load_hyp

    hyp = load_hyp("scratch-low")
    ds, loader = create_loader(check_dataset(str(data))["train"], img_size=IMGSZ,
                               batch_size=BATCH, augment=True, device_aug=True)
    cache = to_device(build_cache_arrays(ds, loader.max_labels), dev)
    model = DetectionModel("yolov5s", nc=VAL_CLASSES).to(dev).to(
        memory_format=torch.channels_last)
    scaled = scale_hyp(hyp, nl=3, nc=VAL_CLASSES, imgsz=IMGSZ)
    loss_fn = ComputeLoss(model.anchors_per_stride, VAL_CLASSES, scaled)
    state = init_train_state(model, Optimizer(dict(model.named_parameters()), scaled,
                                              TRAIN_EPOCHS, len(loader), BATCH))
    step = make_train_step(loss_fn, hyp, dtype=torch.bfloat16)
    step_plain = make_train_step(loss_fn, None, dtype=torch.bfloat16)
    idx = torch.arange(BATCH, device=dev)

    def augment():
        gen = aug_generator(0, state.step, dev)
        b = {k: cache[k][idx] for k in ("images", "hw", "targets", "valid")}
        im, t, v = mosaic_in_batch(b["images"], b["hw"], b["targets"], b["valid"], gen, hyp,
                                   pool=cache, self_idx=idx)
        return device_augment({"images": im, "targets": t, "valid": v}, gen,
                              dict(hyp, **{k: 0.0 for k in GEOMETRY_KEYS}))

    augmented = augment()
    torch.cuda.reset_peak_memory_stats(dev)
    aug_ms = cuda_ms(augment, iters=10)
    with_aug = cuda_ms(lambda: step(state, {"idx": idx}, cache), iters=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)
    no_aug = cuda_ms(lambda: step_plain(state, augmented), iters=10, warmup=3)

    # the step's parts: forward + loss + backward, and one real update of
    # the optimizer with the EMA (an optimizer that does not accumulate)
    params = state.opt.params

    def fwd_bwd():
        x = augmented["images"].permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            maps = model(x.contiguous(memory_format=torch.channels_last))
        total, _ = loss_fn(maps, augmented["targets"], augmented["valid"])
        return torch.autograd.grad(total, params)

    grads = fwd_bwd()
    fb = cuda_ms(fwd_bwd, iters=10)
    update = Optimizer(dict(model.named_parameters()), scaled, TRAIN_EPOCHS, len(loader),
                       BATCH, nbs=BATCH)

    def opt_ema():
        update.step(grads)
        state.ema = ema_update(state.ema, dict(model.named_parameters()), batch_stats(model))

    opt_ms = cuda_ms(opt_ema, iters=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, {"idx": idx}, cache)
    host = (time.perf_counter() - t0) * 1e3 / 5  # enqueue time, no sync inside
    torch.cuda.synchronize()
    print(f"train times, yolov5s b{BATCH} {IMGSZ}px bf16 autocast (forward, backward, "
          f"optimizer, EMA): {with_aug:.3f} ms/step with device augmentation "
          f"({BATCH / with_aug * 1e3:.1f} img/s), {no_aug:.3f} ms/step without "
          f"({BATCH / no_aug * 1e3:.1f} img/s); device augmentation alone {aug_ms:.3f} ms; "
          f"forward+loss+backward {fb:.3f} ms; optimizer update + EMA {opt_ms:.3f} ms; "
          f"host enqueue {host:.3f} ms/step; peak memory {peak / 2 ** 30:.2f} GiB | {smi}")
    print(profile_line(lambda: step(state, {"idx": idx}, cache),
                       f"train step b{BATCH} {IMGSZ}px with device augmentation", smi))


def phase_train_host_data(root):
    """Phase 16's train and val splits (HOST_SHAPES, half the train images
    labelled by polygons) beside the others, and their YAML."""
    t0 = time.perf_counter()
    root = Path(root)
    n_train = write_split(root, "train_host", HOST_TRAIN_IMAGES, seed=5, shapes=HOST_SHAPES,
                          polygons=True)
    n_val = write_split(root, "val_host", HOST_VAL_IMAGES, seed=6, shapes=HOST_SHAPES)
    data = root / "train_host.yaml"
    names = ", ".join(f"shape{c}" for c in range(VAL_CLASSES))
    data.write_text(f"path: {root}\ntrain: images/train_host\nval: images/val_host\n"
                    f"nc: {VAL_CLASSES}\nnames: [{names}]\n")
    print(f"train_host data: {HOST_TRAIN_IMAGES} train BMPs ({n_train} labels, half the images "
          f"as polygons) and {HOST_VAL_IMAGES} val BMPs ({n_val} labels) of (h, w) "
          f"{HOST_SHAPES}, in {time.perf_counter() - t0:.1f} s")
    return data


def _finite_losses(save_dir, epochs, what):
    rows = _csv_rows(save_dir)
    losses = [[float(r[f"train/{k}"]) for k in ("box", "obj", "cls", "total")] for r in rows]
    if len(rows) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"train_host {what}: {len(rows)} epochs, losses {losses}")
    return losses


def phase_train_host(dev, data, root, smi):
    """train.run with host augmentation: the counted run (yolov5s 640 b32 bf16,
    scratch-high, 2 epochs of 4 steps, EMA validation through K1/K2), val.run
    on its best.ckpt, and a short run of each training option."""
    from yolov5_tpu_torch.eval import evaluator
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv
    from yolov5_tpu_torch.train.run import run
    from yolov5_tpu_torch.utils.callbacks import Callbacks

    counts = lambda: (stem_conv.launches, greedy_nms.launches)
    marks = []  # (epoch, counts after training, counts after validation)
    cb = Callbacks()
    cb.register_action("on_train_epoch_end", callback=lambda epoch: marks.append(
        [epoch, counts()]))
    cb.register_action("on_fit_epoch_end", callback=lambda epoch, fitness: marks[-1].append(
        counts()))
    kw = dict(data=str(data), cfg="yolov5s", hyp="scratch-high", batch_size=BATCH,
              imgsz=IMGSZ, device_aug=False, workers=HOST_WORKERS, device=dev,
              project=str(Path(root) / "runs"), exist_ok=True)

    # the counted run of the host-augmented training path
    stem_conv.launches = greedy_nms.launches = 0
    t0 = time.perf_counter()
    best_fitness, _, save_dir = run(**kw, epochs=2, name="host", callbacks=cb)
    wall = time.perf_counter() - t0
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    losses = _finite_losses(save_dir, 2, "counted run")
    rose = [[v - t for v, t in zip(a, b)] for _, b, a in marks]
    if len(rose) != 2 or min(min(r) for r in rose) < 1:
        raise AssertionError(f"train_host: launches in per-epoch val {rose} (stem, nms)")
    for name in ("last.ckpt", "best.ckpt"):
        if not (save_dir / name).exists():
            raise AssertionError(f"train_host: {name} not written")
    speeds = [float(r["train/imgs_per_sec"]) for r in _csv_rows(save_dir)]
    best_epoch = json.loads((save_dir / "best.ckpt.json").read_text())["epoch"]
    again = evaluator.run(str(data), weights=str(save_dir / "best.ckpt"), imgsz=IMGSZ,
                          batch_size=BATCH, half=True, rect=False, device=dev, verbose=False)
    rows = _csv_rows(save_dir)
    pairs = {k: (float(rows[best_epoch][f"val/{k}"]), again[k])
             for k in ("mp", "mr", "map50", "map")}
    if any(abs(a - b) > 1e-6 for a, b in pairs.values()):
        raise AssertionError(f"train_host: val.run on best.ckpt {pairs} (training-time, val.run)")
    print(f"train_host: yolov5s {IMGSZ}px bf16 b{BATCH}, hyp scratch-high, host augmentation "
          f"in {HOST_WORKERS} worker processes (cpu count {os.cpu_count()}), 2 epochs x "
          f"{HOST_TRAIN_IMAGES // BATCH} steps, {wall:.1f} s; losses (box, obj, cls, total) per "
          f"epoch {np.round(losses, 5).tolist()}; train img/s per epoch (results.csv) "
          f"{np.round(speeds, 2).tolist()}; launches in per-epoch val {rose} (stem, nms); "
          f"val.run on best.ckpt (epoch {best_epoch + 1}, fitness {best_fitness:.6f}) "
          f"reproduces its EMA validation | {smi}")

    # each training option, briefly
    options = {"--quad": ("quad", dict(quad=True)),
               "--multi-scale (host)": ("ms_host", dict(multi_scale=True)),
               "--multi-scale --device-aug --cache device": (
                   "ms_device", dict(multi_scale=True, device_aug=True, cache="device")),
               "--rect": ("rect", dict(rect=True)),
               "--image-weights": ("image_weights", dict(image_weights=True, epochs=2))}
    done = []
    for name, (run_name, extra) in options.items():
        # validation only where the option needs it (image weights act on its AP)
        extra = {"epochs": 1, "noval": "epochs" not in extra, "nosave": True,
                 "noautoanchor": True, **extra}
        t0 = time.perf_counter()
        with uncounted():
            _, _, opt_dir = run(**{**kw, **extra}, name=run_name)
        opt_losses = _finite_losses(opt_dir, extra["epochs"], name)
        done.append(f"{name} {extra['epochs']} epoch(s) {time.perf_counter() - t0:.1f} s, "
                    f"last total loss {opt_losses[-1][-1]:.5f}")
    print("train_host options: " + "; ".join(done) + f" | {smi}")
    return launches


def _epochs_of(loader):
    """The loader's batches, epoch after epoch, without end."""
    for epoch in itertools.count():
        loader.set_epoch(epoch)
        yield from loader


def phase_train_host_times(dev, data, smi):
    """The host loader alone, the numpy warp and resize, and the yolov5s b32
    step fed from host batches through the prefetcher, by CUDA events."""
    import torch

    from yolov5_tpu_torch.data import cv
    from yolov5_tpu_torch.data.augment import augment_hsv
    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.loss import ComputeLoss
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.prefetch import prefetch
    from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
    from yolov5_tpu_torch.utils.general import check_dataset
    from yolov5_tpu_torch.utils.hyp import load_hyp

    hyp = load_hyp("scratch-high")
    ds, loader = create_loader(check_dataset(str(data))["train"], img_size=IMGSZ,
                               batch_size=BATCH, augment=True, hyp=hyp, workers=HOST_WORKERS)
    try:
        rates = []
        for epoch in range(2):  # the first pass starts the workers, decodes and resizes
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            n = sum(len(b["images"]) for b in loader)
            rates.append(n / (time.perf_counter() - t0))
        rng = np.random.default_rng(0)
        canvas = rng.integers(0, 256, (2 * IMGSZ, 2 * IMGSZ, 3), dtype=np.uint8)
        M = np.array([[0.8, 0.0, -0.3 * IMGSZ], [0.0, 0.8, -0.25 * IMGSZ]])
        big = rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
        small = rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
        host_ms = {}
        for name, fn in ((f"warp_affine {2 * IMGSZ}^2 -> {IMGSZ}^2", lambda: cv.warp_affine(
                             canvas, M, (IMGSZ, IMGSZ))),
                         ("resize 720x1280 -> 360x640 area", lambda: cv.resize(
                             big, (640, 360), "area")),
                         ("resize 375x500 -> 480x640 linear", lambda: cv.resize(
                             small, (640, 480), "linear")),
                         ("resize 600x800 -> 480x640 linear", lambda: cv.resize(
                             big[:600, :800], (640, 480), "linear"))):
            fn()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            host_ms[name] = 1e3 * (time.perf_counter() - t0) / 5
        # where a worker's time goes: decode + resize, then whole augmented
        # samples from the RAM cache, the HSV jitter and one pasted polygon
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds.load_image(i)
        host_ms["read + resize (each image once)"] = 1e3 * (time.perf_counter() - t0) / len(ds)
        t0 = time.perf_counter()
        for i in range(16):
            ds.get_item(i, np.random.default_rng(i))
        host_ms["get_item (scratch-high, from RAM)"] = 1e3 * (time.perf_counter() - t0) / 16
        im_s = canvas[:IMGSZ, :IMGSZ].copy()
        poly = np.array([[100, 100], [700, 150], [650, 900], [120, 800]], np.int32)
        for name, fn in ((f"augment_hsv {IMGSZ}^2", lambda: augment_hsv(
                             im_s, 0.015, 0.7, 0.4, rng)),
                         (f"fill_poly on the {2 * IMGSZ}^2 canvas", lambda: cv.fill_poly(
                             np.zeros((2 * IMGSZ, 2 * IMGSZ), bool), poly, True))):
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            host_ms[name] = 1e3 * (time.perf_counter() - t0) / 5
        print(f"train_host times: loader alone {rates[0]:.1f} img/s (first epoch: worker "
              f"start, decode and resize) and {rates[1]:.1f} img/s (second: RAM cache), b{BATCH}, "
              f"{loader.workers} worker processes, cpu count {os.cpu_count()}; numpy per image "
              f"(one host thread): " + ", ".join(f"{k} {v:.2f} ms" for k, v in host_ms.items())
              + f" | {smi}")

        model = DetectionModel("yolov5s", nc=VAL_CLASSES).to(dev).to(
            memory_format=torch.channels_last)
        scaled = scale_hyp(hyp, nl=3, nc=VAL_CLASSES, imgsz=IMGSZ)
        state = init_train_state(model, Optimizer(dict(model.named_parameters()), scaled, 3,
                                                  len(loader), BATCH))
        step = make_train_step(ComputeLoss(model.anchors_per_stride, VAL_CLASSES, scaled),
                               None, dtype=torch.bfloat16)
        keys = ("images", "targets", "valid")
        feed = prefetch(_epochs_of(loader), dev, depth=2,
                        transform=lambda b: {k: b[k] for k in keys})
        fed = cuda_ms(lambda: step(state, next(feed)), iters=8, warmup=2)
        resident = next(feed)
        alone = cuda_ms(lambda: step(state, resident), iters=5, warmup=1)
        print(f"train_host step, yolov5s b{BATCH} {IMGSZ}px bf16, fed from host batches "
              f"through the prefetcher: {fed:.3f} ms/step ({BATCH / fed * 1e3:.1f} img/s, CUDA "
              f"events, the copy and any wait for the loader included); on a batch already on "
              f"the card {alone:.3f} ms/step ({BATCH / alone * 1e3:.1f} img/s) | {smi}")
        print(profile_line(lambda: step(state, next(feed)),
                           f"train step b{BATCH} {IMGSZ}px fed from host batches", smi))
        feed.close()
    finally:
        loader.close()


def calibrated_weights(cfg, seed, images, dev, gamma=(0.5, 1.5)):
    """Seeded random weights of ``cfg`` (a Detect or Segment head) whose BN
    running statistics are those of ``images`` (a uint8 (b, s, s, 3) RGB
    batch), so that every layer's output is normalised and the detections
    depend on the image, with BN scales U(``gamma``) and Detect biases
    around HEAD_BIAS. A state_dict on the host."""
    import torch

    from yolov5_tpu_torch.models.yolo import DetectionModel, SegmentationModel

    model = (SegmentationModel if cfg.endswith("-seg") else DetectionModel)(cfg, seed=seed)
    head = f"model.{len(model.specs) - 1}.m."
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("bn.weight"):
                v.uniform_(*gamma, generator=gen)
            elif k.endswith("bn.bias"):
                v.normal_(0.0, 0.1, generator=gen)
            elif k.startswith(head) and k.endswith("bias"):
                v.normal_(HEAD_BIAS, 0.5, generator=gen)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.momentum = 1.0  # the running statistics become the batch's
        model = model.to(dev).to(memory_format=torch.channels_last).train()
        x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).float() / 255.0
        model(x)
    return {k: v.cpu() for k, v in model.state_dict().items()}


def smoke_sources(root):
    """Phases 13-15's sources: the first SMOKE_SOURCES val BMPs, their BGR
    pixels and their letterboxed RGB batch."""
    from yolov5_tpu_torch.data.imageio import imread
    from yolov5_tpu_torch.data.letterbox import letterbox

    paths = sorted((Path(root) / "images" / "val").glob("*.bmp"))[:SMOKE_SOURCES]
    im0s = [imread(p) for p in paths]
    return paths, im0s, np.stack([letterbox(im, IMGSZ)[0][..., ::-1] for im in im0s])


def _txt_lines(r, im0):
    """A detect label file's lines for rows r on the source image im0, as
    infer.run writes them."""
    h0, w0 = im0.shape[:2]
    return [" ".join(f"{v:.6g}" for v in (int(c), (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                                          (x2 - x1) / w0, (y2 - y1) / h0))
            for x1, y1, x2, y2, _, c in r[:, :6]]


def phase_detect(dev, root, smi):
    """infer.run for yolov5s@640 b32 bf16 over the smoke sources, against a
    direct Detector call and against the run through both plain versions."""
    import torch

    from yolov5_tpu_torch import infer
    from yolov5_tpu_torch.data.imageio import imread
    from yolov5_tpu_torch.data.letterbox import scale_boxes_np
    from yolov5_tpu_torch.data.sources import LoadImages
    from yolov5_tpu_torch.ops.nms import detections_to_numpy
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    torch_tf32_off()
    paths, im0s, batch = smoke_sources(root)
    weights = calibrated_weights("yolov5s", 0, batch[:4], dev)
    kw = dict(weights=weights, cfg="yolov5s", source=[str(p) for p in paths], imgsz=IMGSZ,
              batch_size=BATCH, half=True, device=dev, project=str(Path(root) / "runs"),
              exist_ok=True)

    # the counted run of the detect path
    stem_conv.launches = greedy_nms.launches = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        results, save_dir = infer.run(name="detect", save_txt=True, save_csv=True, **kw)
    wall = time.perf_counter() - t0
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"detect: launches {launches}")
    loop_ms = float(re.search(r"done: \d+ images, ([\d.]+) ms/img", printed.getvalue()).group(1))
    rows = [r for _, r in results]
    n_dets = sum(len(r) for r in rows)
    if len(results) != len(paths) or n_dets < len(paths):
        raise AssertionError(f"detect: {len(results)} results, {n_dets} detections")

    with uncounted():
        det = infer.Detector(weights, cfg="yolov5s", imgsz=IMGSZ, half=True, device=dev)
        direct = detections_to_numpy(det(batch))
        for p, r, im0 in zip(paths, direct, im0s):
            r[:, :4] = scale_boxes_np(batch.shape[1:3], r[:, :4], im0.shape[:2])
            txt = save_dir / "labels" / f"{p.stem}.txt"
            got = txt.read_text().splitlines() if txt.exists() else []
            if got != _txt_lines(r, im0):
                raise AssertionError(f"detect: {txt.name} differs from Detector.__call__")
            if imread(save_dir / p.name).shape != im0.shape:
                raise AssertionError(f"detect: annotated {p.name} not at its source's size")
        n_csv = len((save_dir / "predictions.csv").read_text().splitlines()) - 1
        if n_csv != n_dets:
            raise AssertionError(f"detect: {n_csv} CSV rows for {n_dets} detections")
        images = torch.from_numpy(batch).to(dev)
        device_ms = cuda_ms(lambda: det(images), iters=10)
        t0 = time.perf_counter()  # the reader thread's work: read and letterbox
        n_read = sum(1 for _ in LoadImages(kw["source"], img_size=IMGSZ))
        read_ms = 1e3 * (time.perf_counter() - t0) / n_read
    # the run through both plain versions. In bf16 it is reported only: K2
    # rounds some stem outputs one ulp apart from the plain f32 convolution,
    # and with weights that carry the image through the network a bf16
    # forward turns such differences into other scores and other greedy
    # cascades. The f32 pair is held to equal counts and >= 99% matched.
    twins = {}
    for half in (True, False):
        runs = []
        for plain in (False, True):
            if half and not plain:
                runs.append(rows)
                continue
            with (routed(stem_conv_plain, greedy_nms_plain) if plain
                  else contextlib.nullcontext()), uncounted(), \
                    contextlib.redirect_stdout(io.StringIO()):
                res, _ = infer.run(name=f"detect_{half}_{plain}", save_img=False,
                                   **dict(kw, half=half))
            runs.append([r for _, r in res])
        a, b = runs
        twins["bf16" if half else "f32"] = ([len(r) for r in a] == [len(r) for r in b],
                                            *match_detections(a, b))
    print(f"detect: infer.run yolov5s {IMGSZ}px bf16 b{BATCH}, {len(paths)} BMP sources, "
          f"{n_dets} detections (per image {min(map(len, rows))}..{max(map(len, rows))}), "
          f"launches {launches}; txt rows equal Detector.__call__, annotated BMPs at their "
          f"sources' sizes, {n_csv} CSV rows; against both plain versions: "
          + "; ".join(f"{k} counts {'equal' if same else 'DIFFER'}, {hit}/{total} matched "
                      f"within 1 px, max score diff {diff:.3g}"
                      for k, (same, hit, total, diff, _) in twins.items())
          + f"; pipelined loop wall {loop_ms:.3f} ms/img, reading and letterboxing alone "
          f"{read_ms:.3f} ms/img (host clock; run in all "
          f"{1e3 * wall / len(paths):.3f} ms/img with model load and warmup), device "
          f"{device_ms:.3f} ms per b{BATCH} (forward + NMS, CUDA events) | {smi}")
    same_counts, hit, total, *_ = twins["f32"]
    if not same_counts or hit < 0.99 * total:
        raise AssertionError(f"detect f32 vs both plain versions: counts equal {same_counts}, "
                             f"{hit}/{total} matched")
    return weights, launches


def _post(url, body, headers):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve_requests(handler, paths, key):
    """Start a ThreadingHTTPServer at 127.0.0.1 with ``handler``, check
    /healthz, POST every path's bytes (every second one as multipart) and
    then the two refused requests; stop it. Returns the replies, the
    latencies in ms, and the answers without the key and to a PNG body."""
    import urllib.request
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    detect = url + "/v1/object-detection/yolov5s"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health != {"ok": True, "models": ["yolov5s"]}:
            raise AssertionError(f"serve: /healthz {health}")
        replies, latency = [], []
        for i, p in enumerate(paths):
            body, ctype = p.read_bytes(), "image/bmp"
            if i % 2:
                b = "smokeBoundary"
                body = (f"--{b}\r\nContent-Disposition: form-data; name=\"image\"; "
                        f"filename=\"{p.name}\"\r\n\r\n").encode() + body + \
                    f"\r\n--{b}--\r\n".encode()
                ctype = f"multipart/form-data; boundary={b}"
            t0 = time.perf_counter()
            code, reply = _post(detect, body, {"Content-Type": ctype, **key})
            latency.append(1e3 * (time.perf_counter() - t0))
            if code != 200:
                raise AssertionError(f"serve: {p.name}: {code} {reply}")
            replies.append(reply)
        no_key = _post(detect, paths[0].read_bytes(), {"Content-Type": "image/bmp"})
        png = _post(detect, b"\x89PNG\r\n\x1a\n" + bytes(64), {"Content-Type": "image/png", **key})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return replies, latency, no_key, png


class _Inline:
    """An executor that runs what it is given at once, on the caller's thread."""

    @staticmethod
    def submit(fn, *args):
        from concurrent.futures import Future

        f = Future()
        f.set_result(fn(*args))
        return f


def phase_serve(dev, root, weights, smi):
    """serve.make_handler on a ThreadingHTTPServer at 127.0.0.1: 32 BMP
    requests, raw and multipart, against Detector.__call__ on each image."""
    import torch

    from yolov5_tpu_torch import serve
    from yolov5_tpu_torch.data.imageio import imdecode
    from yolov5_tpu_torch.data.letterbox import letterbox, scale_boxes_np
    from yolov5_tpu_torch.infer import Detector
    from yolov5_tpu_torch.ops.nms import detections_to_numpy
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv

    paths, im0s, _ = smoke_sources(root)
    det = Detector(weights, cfg="yolov5s", imgsz=IMGSZ, device=dev)
    key = {"X-API-Key": "smoke-key"}
    handler = serve.make_handler({"yolov5s": det}, "smoke-key", 0.25)
    handler.executor.submit(det.warmup).result()

    # the counted run of the serving path
    stem_conv.launches = greedy_nms.launches = 0
    replies, latency, no_key, png_reply = _serve_requests(handler, paths, key)
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"serve: launches {launches}")
    try:
        import cv2  # noqa: F401
        png_error = "undecodable image"
    except ImportError:
        png_error = "OpenCV"
    if no_key[0] != 401 or png_reply[0] != 400 or png_error not in png_reply[1]["error"]:
        raise AssertionError(f"serve: without the key {no_key}, a PNG body {png_reply}")
    direct = []  # the handler's work on each body without HTTP, synchronised
    with uncounted():
        for p, im0, reply in zip(paths, im0s, replies):
            t0 = time.perf_counter()
            im = letterbox(imdecode(p.read_bytes()), IMGSZ)[0]
            rows = detections_to_numpy(det(im[..., ::-1][None].copy(), conf_thres=0.25))[0]
            rows[:, :4] = scale_boxes_np(im.shape[:2], rows[:, :4], im0.shape[:2])
            records = serve.detections_to_records(rows, det.names)
            direct.append(1e3 * (time.perf_counter() - t0))
            if reply != records:
                raise AssertionError(f"serve: {p.name}: records differ from Detector.__call__")
        # the same requests with the model called on each request's own
        # thread (no worker): PyTorch's cuDNN plan cache is per thread
        inline = type("Handler", (handler,), {"executor": _Inline()})
        per_thread = np.percentile(_serve_requests(inline, paths, key)[1], [50, 95])
        images = torch.from_numpy(np.stack([letterbox(im0s[0], IMGSZ)[0][..., ::-1]])).to(dev)
        device_ms = cuda_ms(lambda: det(images, conf_thres=0.25), iters=20)
    handler.executor.shutdown()
    n_dets = sum(map(len, replies))
    p50, p95 = np.percentile(latency, [50, 95])
    d50, d95 = np.percentile(direct, [50, 95])
    print(f"serve: {len(paths)} BMP requests ({len(paths) - len(paths) // 2} raw, "
          f"{len(paths) // 2} multipart) to yolov5s {IMGSZ}px f32, "
          f"{n_dets} detections, records equal Detector.__call__ + scale_boxes_np; launches "
          f"{launches}; /healthz ok, 401 without the key, 400 for a PNG body "
          f"({png_reply[1]['error'][:60]!r}); latency p50 {p50:.3f} ms, p95 {p95:.3f} ms "
          f"(host clock, one request at a time); with the model called on each request's "
          f"thread instead of the handler's worker: p50 {per_thread[0]:.3f}, p95 "
          f"{per_thread[1]:.3f} ms; the handler's work without HTTP (decode, letterbox, "
          f"forward + NMS, copy back) p50 {d50:.3f} ms, p95 {d95:.3f} ms; device "
          f"{device_ms:.3f} ms per b1 forward + NMS (CUDA events) | {smi}")
    return launches


def _mask_iou(a, b):
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


def phase_segment(dev, root, smi):
    """infer_segment.run for yolov5s-seg@640 f32 over the smoke sources,
    against the run through both plain versions; K1 at 1 x 25 200."""
    from yolov5_tpu_torch import infer_segment
    from yolov5_tpu_torch.ops.masks import masks2segments
    from yolov5_tpu_torch.ops.nms import non_max_suppression
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    torch_tf32_off()
    paths, _, batch = smoke_sources(root)
    weights = calibrated_weights("yolov5s-seg", 0, batch[:4], dev)
    kw = dict(weights=weights, cfg="yolov5s-seg", source=[str(p) for p in paths],
              imgsz=IMGSZ, conf_thres=0.25, device=dev, project=str(Path(root) / "runs"),
              exist_ok=True, verbose=False)

    # the counted run of the segment predict path
    stem_conv.launches = greedy_nms.launches = 0
    t0 = time.perf_counter()
    results, save_dir = infer_segment.run(name="segment", save_txt=True, **kw)
    wall = time.perf_counter() - t0
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"segment: launches {launches}")
    n_dets = sum(len(r) for _, r, _ in results)
    n_txt = len(list((save_dir / "labels").glob("*.txt")))
    if n_dets < len(paths) or n_txt != sum(len(r) > 0 for _, r, _ in results):
        raise AssertionError(f"segment: {n_dets} detections, {n_txt} polygon txts")
    with routed(stem_conv_plain, greedy_nms_plain), uncounted():
        twin, _ = infer_segment.run(name="segment_plain", save_img=False, **kw)
    # where a predict's time goes: the run without writing anything, and the
    # polygons of all its masks
    with uncounted():
        t0 = time.perf_counter()
        infer_segment.run(name="segment_nosave", save_img=False, **kw)
        bare_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    t0 = time.perf_counter()
    for _, _, masks in results:
        if masks is not None:
            masks2segments(masks)
    poly_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    same_counts = [len(r) for _, r, _ in results] == [len(r) for _, r, _ in twin]
    pairs = ious = 0
    worst = 1.0
    for (_, ra, ma), (_, rb, mb) in zip(results, twin):
        used = np.zeros(len(rb), bool)
        for i in np.argsort(-ra[:, 4], kind="stable"):
            d = np.abs(rb[:, :4] - ra[i, :4]).max(1) if len(rb) else np.zeros(0)
            ok = ~used & (rb[:, 5] == ra[i, 5]) & (d <= 1.0)
            if ok.any():
                j = np.flatnonzero(ok)[np.argmin(d[ok])]
                used[j] = True
                iou = _mask_iou(ma[i], mb[j])
                pairs += 1
                ious += iou >= 0.99
                worst = min(worst, iou)

    # K1 at the segment shape: the 25 200 candidates of the image with the
    # most instances
    with uncounted():
        seg = infer_segment.Segmenter(weights, cfg="yolov5s-seg", device=dev)
        busiest = int(np.argmax([len(r) for _, r, _ in results]))
        preds, _ = seg.forward(batch[busiest:busiest + 1])
        captured = {}

        def capture(boxes, scores, thres, max_det):
            captured.update(args=(boxes, scores, thres, max_det))
            return greedy_nms(boxes, scores, thres, max_det)

        with routed(nms=capture):
            non_max_suppression(preds, conf_thres=0.25, iou_thres=0.45, max_det=300, nc=seg.nc)
        boxes, scores, _, _ = captured["args"]
        k1 = cuda_ms(lambda: greedy_nms(*captured["args"]), iters=20)
        k1_plain = cuda_ms(lambda: greedy_nms_plain(*captured["args"]), iters=2, warmup=1)
        k1_bound, k1_by, n_iou = nms_bound_ms(*captured["args"])
    print(f"segment: infer_segment.run yolov5s-seg {IMGSZ}px f32 conf 0.25, {len(paths)} "
          f"sources, {n_dets} instances, {n_txt} polygon txts, launches {launches}; "
          f"{1e3 * wall / len(paths):.3f} ms/img (host clock, b1 loop, overlays, txts and "
          f"model load included), {bare_ms:.3f} ms/img writing nothing, polygons alone "
          f"{poly_ms:.3f} ms/img; against both plain versions: counts "
          f"{'equal' if same_counts else 'DIFFER'}, {pairs}/{n_dets} matched within 1 px, "
          f"{ious} with mask IoU >= 0.99 (lowest {worst:.4f}) | {smi}")
    print(f"K1 b1x{boxes.shape[1]} (segment predict, the busiest image: "
          f"{len(results[busiest][1])} instances, {int((scores > 0).sum())} candidates > 0, "
          f"IoU 0.45, max_det 300): {k1:.4f} ms; bound {k1_bound:.5f} ms ({k1_by}: {n_iou} "
          f"IoUs greedy needs on these inputs), {100 * k1_bound / k1:.2f}% of it; plain "
          f"{k1_plain:.3f} ms | {smi}")
    if not same_counts or pairs < 0.99 * n_dets or ious != pairs:
        raise AssertionError(f"segment vs both plain versions: counts equal {same_counts}, "
                             f"{pairs}/{n_dets} matched, {ious} with mask IoU >= 0.99")
    return launches


def write_seg_split(root, split, n, seed, shapes=VAL_SHAPES):
    """n BMPs of the (h, w) ``shapes`` in turn with 1-6 filled polygons each
    (triangles and 12-vertex ellipses, one per cell of a 3x2 grid) on a noisy
    background, and their YOLO labels, every label a polygon, under
    images/<split> and labels/<split>. Returns the number of labels."""
    from yolov5_tpu_torch.data.cv import fill_poly
    from yolov5_tpu_torch.data.imageio import imwrite

    root = Path(root)
    (root / "images" / split).mkdir(parents=True)
    (root / "labels" / split).mkdir(parents=True)
    rng = np.random.default_rng(seed)
    n_labels = 0
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        im = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        rows = []
        for cell in rng.permutation(6)[:rng.integers(1, 7)]:
            cw, ch = w / 3, h / 2
            cx = (cell % 3 + rng.uniform(0.35, 0.65)) * cw
            cy = (cell // 3 + rng.uniform(0.35, 0.65)) * ch
            rx, ry = rng.uniform(0.15, 0.35) * cw, rng.uniform(0.15, 0.35) * ch
            k = 3 if rng.random() < 0.5 else 12
            ang = rng.uniform(0, 2 * np.pi) + np.arange(k) * 2 * np.pi / k
            poly = np.stack([cx + rx * np.cos(ang), cy + ry * np.sin(ang)], 1)
            c = int(rng.integers(0, VAL_CLASSES))
            fill_poly(im, np.round(poly).astype(np.int32),
                      ((90, 200, 40), (230, 60, 120), (40, 120, 250))[c])
            rows.append(f"{c} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in poly))
        imwrite(root / "images" / split / f"{i:04d}.bmp", im)
        (root / "labels" / split / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")
        n_labels += len(rows)
    return n_labels


def phase_seg_data(root):
    """Phase 17's polygon-labelled train and val splits and their YAML."""
    t0 = time.perf_counter()
    root = Path(root)
    n_train = write_seg_split(root, "train_seg", SEG_TRAIN_IMAGES, seed=7)
    n_val = write_seg_split(root, "val_seg", SEG_VAL_IMAGES, seed=8)
    data = root / "seg.yaml"
    names = ", ".join(f"shape{c}" for c in range(VAL_CLASSES))
    data.write_text(f"path: {root}\ntrain: images/train_seg\nval: images/val_seg\n"
                    f"nc: {VAL_CLASSES}\nnames: [{names}]\n")
    print(f"seg data: {SEG_TRAIN_IMAGES} train BMPs ({n_train} polygons) and {SEG_VAL_IMAGES} "
          f"val BMPs ({n_val} polygons) of (h, w) {VAL_SHAPES}, triangles and ellipses, in "
          f"{time.perf_counter() - t0:.1f} s")
    return data


class _Tee(io.TextIOBase):
    """Standard output kept as it is written, and still written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _seg_cli(argv):
    """``python -m yolov5_tpu_torch.segment <argv>`` in this process, with
    what it printed."""
    from yolov5_tpu_torch.segment import main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = main(argv)
    return out, "".join(tee.text)


@contextlib.contextmanager
def captured_seg_batches():
    """Record each batch's detections (numpy rows and the padded tensors)
    and prototypes that run_segment.evaluate_segment scores while open."""
    from yolov5_tpu_torch.train import run_segment

    saved = run_segment.detections_to_numpy, run_segment._mask_ious
    batches = []

    def rows_of(dets):
        rows = saved[0](dets)
        batches.append({"rows": rows, "dets": dets})
        return rows

    def ious_of(proto, dets, *a):
        batches[-1]["proto"] = proto
        return saved[1](proto, dets, *a)

    run_segment.detections_to_numpy, run_segment._mask_ious = rows_of, ious_of
    try:
        yield batches
    finally:
        run_segment.detections_to_numpy, run_segment._mask_ious = saved


def phase_segment_train(dev, data, root, smi):
    """``segment train`` for yolov5s-seg 640 b16 bf16, one epoch with host
    augmentation and one with --device-aug and the device cache, each ending
    in the EMA validation through K1 and K2. Returns (launches, the
    device-augmented run's directory)."""
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv

    base = ["train", "--data", str(data), "--cfg", "yolov5s-seg", "--imgsz", str(IMGSZ),
            "--batch-size", str(SEG_BATCH), "--epochs", "1", "--workers", str(SEG_WORKERS),
            "--project", str(Path(root) / "runs"), "--exist-ok", "--device", str(dev)]
    launches = {"stem_conv": 0, "greedy_nms": 0}
    runs = {}
    for name, extra in (("seg_host", []), ("seg_device", ["--device-aug", "--cache", "device"])):
        # the counted runs of the segmentation training path
        stem_conv.launches = greedy_nms.launches = 0
        t0 = time.perf_counter()
        out, text = _seg_cli(base + ["--name", name] + extra)
        wall = time.perf_counter() - t0
        got = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
        if min(got.values()) < 1:
            raise AssertionError(f"segment train {name}: launches {got}")
        save_dir = Path(out["save_dir"])
        rows = _csv_rows(save_dir)
        losses = [float(rows[0][f"train/{k}"]) for k in ("box", "obj", "cls", "seg", "total")]
        if len(rows) != 1 or not np.isfinite(losses).all():
            raise AssertionError(f"segment train {name}: {len(rows)} epochs, losses {losses}")
        for f in ("last.ckpt", "best.ckpt"):
            if not (save_dir / f).exists():
                raise AssertionError(f"segment train {name}: {f} not written")
        m = re.search(r"WARNING: (\d+) mask-loss candidates exceeded", text)
        overflow = int(m.group(1)) if m else 0
        for k in launches:
            launches[k] += got[k]
        runs[name] = save_dir
        print(f"segment train {name}: yolov5s-seg {IMGSZ}px bf16 b{SEG_BATCH}, 1 epoch x "
              f"{SEG_TRAIN_IMAGES // SEG_BATCH} steps, {wall:.1f} s; losses (box, obj, cls, "
              f"seg, total) {np.round(losses, 5).tolist()}; seg_overflow {overflow}; train "
              f"img/s {float(rows[0]['train/imgs_per_sec']):.2f} (results.csv, host clock over "
              f"the epoch); EMA val box mAP50 {float(rows[0]['val/box_map50']):.5f}, mask "
              f"mAP50 {float(rows[0]['val/mask_map50']):.5f}; launches in the epoch's val "
              f"{got} | {smi}")
    return launches, runs["seg_device"]


def _seg_pairs(a, b, px=1.0):
    """Detections of two evaluate_segment runs (captured batches), matched
    per image: for each detection of a, in score order, the free one of b
    with its class and box within px; then the binary masks
    (process_mask(upsample=True) > 0.5) of each matched pair. Returns (equal
    counts, detections of a, matched, lowest mask IoU of a matched pair,
    matched with mask IoU >= 0.99, unmatched (rank in its image, score over
    the image's lowest))."""
    import torch

    from yolov5_tpu_torch.ops.masks import process_mask

    same = True
    n = pairs = good = 0
    worst = 1.0
    missed = []
    for ba, bb in zip(a, b):
        for i, (ra, rb) in enumerate(zip(ba["rows"], bb["rows"])):
            same &= len(ra) == len(rb)
            n += len(ra)
            used = np.zeros(len(rb), bool)
            ia, ib = [], []
            for rank, j in enumerate(np.argsort(-ra[:, 4], kind="stable")):
                d = np.abs(rb[:, :4] - ra[j, :4]).max(1) if len(rb) else np.zeros(0)
                ok = ~used & (rb[:, 5] == ra[j, 5]) & (d <= px)
                if ok.any():
                    k = np.flatnonzero(ok)[np.argmin(d[ok])]
                    used[k] = True
                    ia.append(j)
                    ib.append(k)
                else:
                    missed.append((rank, float(ra[j, 4] / ra[:, 4].min())))
            if not ia:
                continue
            masks = []
            for batch, idx in ((ba, ia), (bb, ib)):
                t = torch.as_tensor(np.asarray(idx), device=batch["proto"].device)
                dets = batch["dets"]
                masks.append(process_mask(batch["proto"][i], dets.masks[i][t], dets.boxes[i][t],
                                          (IMGSZ, IMGSZ), upsample=True) > 0.5)
            inter = (masks[0] & masks[1]).sum((1, 2)).float()
            union = (masks[0] | masks[1]).sum((1, 2)).float()
            iou = torch.where(union > 0, inter / union.clamp(min=1), 1.0)
            pairs += len(ia)
            good += int((iou >= 0.99).sum())
            worst = min(worst, float(iou.min()))
    return same, n, pairs, worst, good, missed


def phase_segment_val(dev, data, run_dir, smi):
    """``segment val --save-json`` on the device-augmented run's best.ckpt
    (the counted run, bf16 as trained): its metrics equal the epoch's EMA
    validation, COCO bbox and segm scored. Then, in f32, evaluate_segment
    with the kernels against the run through both plain versions: the same
    detections as sets, mask IoU >= 0.99 on matched ones. Then K1 and K2 at
    the seg val shapes. Returns (launches, kernel times)."""
    import torch
    import torch.nn.functional as F

    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.infer_segment import Segmenter
    from yolov5_tpu_torch.ops.nms import non_max_suppression
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain
    from yolov5_tpu_torch.train.run_segment import evaluate_segment
    from yolov5_tpu_torch.utils.general import check_dataset

    best = run_dir / "best.ckpt"
    row = _csv_rows(run_dir)[-1]
    stem_conv.launches = greedy_nms.launches = 0
    t0 = time.perf_counter()
    out, _ = _seg_cli(["val", "--data", str(data), "--weights", str(best), "--imgsz", str(IMGSZ),
                       "--batch-size", str(SEG_BATCH), "--half", "--workers", str(SEG_WORKERS),
                       "--save-json", str(run_dir / "seg.json"), "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"segment val: launches {launches}")
    pairs = {k: (float(row[f"val/{k}"]), out[a][b]) for k, (a, b) in {
        "box_map50": ("box", "map50"), "box_map": ("box", "map"),
        "mask_map50": ("mask", "map50"), "mask_map": ("mask", "map")}.items()}
    if any(abs(x - y) > 1e-6 for x, y in pairs.values()):
        raise AssertionError(f"segment val on best.ckpt {pairs} (training-time, segment val)")
    cb, cs = out["coco_bbox"], out["coco_segm"]
    if not all(np.isfinite([cb["map"], cb["map50"], cs["map"], cs["map50"]])):
        raise AssertionError(f"segment val: COCO scores {cb}, {cs}")
    print(f"segment val on best.ckpt (bf16, --save-json): reproduces the EMA validation "
          f"{pairs}; COCO bbox mAP {cb['map']:.5f} mAP50 {cb['map50']:.5f}, COCO segm mAP "
          f"{cs['map']:.5f} mAP50 {cs['map50']:.5f}; {wall:.1f} s in all (JSON rows and "
          f"scoring on the host), evaluate_segment {out['speed_ms']:.3f} ms/img (host clock, "
          f"b{SEG_BATCH}); launches {launches} | {smi}")

    # f32, the weights of phase 15 (BN statistics of these images, so that
    # scores spread with the image): the path with the kernels against the
    # plain versions
    torch_tf32_off()
    _, loader = create_loader(check_dataset(str(data))["val"], img_size=IMGSZ,
                              batch_size=SEG_BATCH, workers=SEG_WORKERS, masks=True)
    images = next(iter(loader))["images"]
    seg = Segmenter(calibrated_weights("yolov5s-seg", 0, images[:4], dev), cfg="yolov5s-seg",
                    device=dev)
    with uncounted():
        with captured_seg_batches() as a:
            res_a = evaluate_segment(seg.forward, loader, dev, seg.nc)
        with routed(nms=greedy_nms_plain), captured_seg_batches() as k1p:
            res_k1p = evaluate_segment(seg.forward, loader, dev, seg.nc)
        with routed(stem_conv_plain, greedy_nms_plain), captured_seg_batches() as b:
            res_b = evaluate_segment(seg.forward, loader, dev, seg.nc)
    k1_same = (all(np.array_equal(x, y) for ba, bb in zip(a, k1p)
                   for x, y in zip(ba["rows"], bb["rows"]))
               and {k: res_a[k] for k in ("box", "mask")}
               == {k: res_k1p[k] for k in ("box", "mask")})
    print(f"segment val f32 through K1's plain version: rows and metrics "
          f"{'identical' if k1_same else 'DIFFER'} | {smi}")
    if not k1_same:
        raise AssertionError("segment val: K1 against its plain version differ")
    same, n, matched, worst, good, missed = _seg_pairs(a, b)
    ranks = [r for r, _ in missed] or [0]
    over = [q for _, q in missed] or [0.0]
    print(f"segment val f32, kernels against both plain versions: counts "
          f"{'equal' if same else 'DIFFER'}, {matched}/{n} detections matched within 1 px (the "
          f"{len(missed)} unmatched ranked {min(ranks)}-{max(ranks)} in their images, at "
          f"{min(over):.6f}-{max(over):.6f}x its lowest score), {good} with mask IoU >= 0.99 "
          f"(lowest {worst:.4f}); box mAP50 {res_a['box']['map50']:.6f} / "
          f"{res_b['box']['map50']:.6f}, mask mAP50 {res_a['mask']['map50']:.6f} / "
          f"{res_b['mask']['map50']:.6f}; {res_a['speed_ms']:.3f} ms/img with the kernels | {smi}")
    if not same or matched < SEG_MATCH_MIN * n or good != matched:
        raise AssertionError(f"segment val vs both plain versions: counts equal {same}, "
                             f"{matched}/{n} matched, {good}/{matched} with mask IoU >= 0.99")

    # K1 at b16 x 30 720 and K2 at the seg val stem (bf16, as trained)
    seg16 = Segmenter(str(best), device=dev, half=True)
    images = torch.from_numpy(images).to(dev)
    captured = {}

    def capture_nms(boxes, scores, thres, max_det):
        captured.update(nms=(boxes, scores, thres, max_det))
        return greedy_nms(boxes, scores, thres, max_det)

    def capture_stem(x, w, bias):
        captured.update(stem=(x, w, bias))
        return stem_conv(x, w, bias)

    with uncounted(), routed(capture_stem, capture_nms):
        preds, _ = seg16.forward(images)
        non_max_suppression(preds, conf_thres=0.001, iou_thres=0.6, multi_label=True,
                            max_det=300, nc=seg16.nc)
    with uncounted():
        k1 = cuda_ms(lambda: greedy_nms(*captured["nms"]), iters=20)
        k1_plain = cuda_ms(lambda: greedy_nms_plain(*captured["nms"]), iters=2, warmup=1)
        k1_bound, k1_by, n_iou = nms_bound_ms(*captured["nms"])
        x, w, bias = captured["stem"]
        k2 = cuda_ms(lambda: stem_conv(x, w, bias), iters=50)
        k2_alone = cuda_ms(stem_kernel_call(x, w, bias), iters=50)
        k2_plain = cuda_ms(lambda: stem_conv_plain(x, w, bias), iters=20)
        wd, bd = w.detach().to(x.dtype), bias.detach().to(x.dtype)
        k2_cudnn = cuda_ms(lambda: F.silu(F.conv2d(x, wd, bd, stride=2, padding=2)), iters=50)
        k2_bound, k2_by = stem_bound_ms(x, w.shape[0])
    boxes = captured["nms"][0]
    print(f"K1 b{boxes.shape[0]}x{boxes.shape[1]} (segment val, IoU 0.6, max_det 300, "
          f"multi-label, 32 coefficient columns gathered after it): {k1:.4f} ms; bound "
          f"{k1_bound:.5f} ms ({k1_by}: {n_iou} IoUs greedy needs on these inputs), "
          f"{100 * k1_bound / k1:.2f}% of it; plain {k1_plain:.3f} ms | {smi}")
    print(f"K2 b{x.shape[0]}x{x.shape[2]} {str(x.dtype).split('.')[-1]} c2={w.shape[0]} "
          f"(segment val stem, BN-folded EMA model): {k2:.4f} ms through its wrapper, "
          f"{k2_alone:.4f} ms the kernel alone; bound {k2_bound:.4f} ms ({k2_by}), "
          f"{100 * k2_bound / k2:.1f}% of it; plain {k2_plain:.3f} ms; cuDNN "
          f"{str(x.dtype).split('.')[-1]} conv + SiLU {k2_cudnn:.3f} ms | {smi}")
    return launches


def phase_segment_times(dev, data, smi):
    """The yolov5s-seg b16 step by CUDA events: with device augmentation
    from the device cache, and on a host-augmented batch already on the
    card."""
    import torch

    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.data.device_aug import (aug_generator, mosaic_in_batch_seg,
                                                  rasterize_batch_masks)
    from yolov5_tpu_torch.data.device_cache import build_cache_arrays, to_device
    from yolov5_tpu_torch.models.yolo import SegmentationModel
    from yolov5_tpu_torch.train.loss import ComputeSegmentLoss
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
    from yolov5_tpu_torch.utils.general import check_dataset
    from yolov5_tpu_torch.utils.hyp import load_hyp

    hyp = load_hyp(None)
    ds, loader = create_loader(check_dataset(str(data))["train"], img_size=IMGSZ,
                               batch_size=SEG_BATCH, augment=True, hyp=hyp, workers=1,
                               masks=True)
    model = SegmentationModel("yolov5s-seg", nc=VAL_CLASSES).to(dev).to(
        memory_format=torch.channels_last)
    scaled = scale_hyp(hyp, nl=3, nc=VAL_CLASSES, imgsz=IMGSZ)
    state = init_train_state(model, Optimizer(dict(model.named_parameters()), scaled, 3,
                                              len(loader), SEG_BATCH))
    loss_fn = ComputeSegmentLoss(model.anchors_per_stride, VAL_CLASSES, scaled, nm=model.nm)
    mask_shape = (IMGSZ // 4, IMGSZ // 4)
    cache = to_device(build_cache_arrays(ds, loader.max_labels, segments_v=32), dev)
    dev_step = make_train_step(loss_fn, device_aug_hyp=hyp, has_masks=True,
                               mask_shape=mask_shape)
    idx = {"idx": torch.arange(SEG_BATCH, device=dev)}
    with uncounted():
        t_dev = cuda_ms(lambda: dev_step(state, idx, cache), iters=5, warmup=2)
        host_step = make_train_step(loss_fn, has_masks=True, mask_shape=mask_shape)
        hb = next(iter(loader))
        hb = {k: torch.from_numpy(hb[k]).to(dev) for k in ("images", "targets", "valid",
                                                             "masks")}
        t_host = cuda_ms(lambda: host_step(state, hb), iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        # the device path's GT masks alone, on a mosaic's polygons
        raw = {k: cache[k][idx["idx"]] for k in ("images", "hw", "targets", "segments", "valid")}
        _, _, segs, valid = mosaic_in_batch_seg(*raw.values(), aug_generator(0, 0, dev), hyp,
                                                pool=cache, self_idx=idx["idx"])
        t_rast = cuda_ms(lambda: rasterize_batch_masks(segs, valid, *mask_shape), iters=5)
        rast_line = profile_line(lambda: rasterize_batch_masks(segs, valid, *mask_shape),
                                 f"rasterize_batch_masks b{SEG_BATCH} x {segs.shape[1]} slots "
                                 f"at {mask_shape[0]}^2", smi)
    loader.close()
    print(f"segment train step, yolov5s-seg b{SEG_BATCH} {IMGSZ}px bf16 (CUDA events): with "
          f"device augmentation from the device cache {t_dev:.3f} ms ({SEG_BATCH / t_dev * 1e3:.1f}"
          f" img/s); on a host-augmented batch already on the card {t_host:.3f} ms "
          f"({SEG_BATCH / t_host * 1e3:.1f} img/s); peak memory {peak:.2f} GiB; the device "
          f"path's GT masks alone {t_rast:.3f} ms ({segs.shape[1]} polygon slots an image, "
          f"{int(valid.sum())} of {valid.numel()} real) | {smi}")
    print(rast_line)


def write_class_folder(root, n_per_class, seed):
    """CLS_CLASSES class folders of n_per_class 24-bit BMPs each under root,
    of the (h, w) CLS_SHAPES in turn: noise around the class's colour with
    one noisy rectangle of another (tests/torch_port_helpers.py
    ``write_imagefolder``). Returns the number of images."""
    from yolov5_tpu_torch.data.imageio import imwrite

    rng = np.random.default_rng(seed)
    k = 0
    for c in range(CLS_CLASSES):
        d = Path(root) / f"cls{c:02d}"
        d.mkdir(parents=True)
        base = np.array(CLASS_COLORS[c], np.int16)[::-1]  # BGR
        for i in range(n_per_class):
            h, w = CLS_SHAPES[k % len(CLS_SHAPES)]
            im = (base + rng.integers(-60, 60, (h, w, 3))).clip(0, 255).astype(np.uint8)
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            y1, x1 = y0 + int(rng.integers(h // 8, h // 2)), x0 + int(rng.integers(w // 8, w // 2))
            im[y0:y1, x0:x1] = rng.integers(0, 256, 3)
            imwrite(d / f"{i:03d}.bmp", im)
            k += 1
    return k


def phase_cls_data(root):
    """Phase 18's ImageFolder: train/ and val/ of CLS_CLASSES classes.
    Returns its root."""
    t0 = time.perf_counter()
    root = Path(root) / "cls"
    n_train = write_class_folder(root / "train", CLS_TRAIN_PER_CLASS, seed=11)
    n_val = write_class_folder(root / "val", CLS_VAL_PER_CLASS, seed=12)
    mb = sum(f.stat().st_size for f in root.rglob("*.bmp")) / 1e6
    print(f"cls data: {n_train} train and {n_val} val BMPs of {CLS_CLASSES} classes, (h, w) "
          f"{CLS_SHAPES}, {mb:.0f} MB, in {time.perf_counter() - t0:.1f} s")
    return root


def _cls_cli(argv):
    """``python -m yolov5_tpu_torch.classify <argv>`` in this process, with
    what it printed."""
    from yolov5_tpu_torch.classify import main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = main(argv)
    return out, "".join(tee.text)


def torch_tf32_default():
    """PyTorch's defaults, which a user of the classify CLI runs with: cuDNN
    convolutions in TF32, matrix products in full f32."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_classify_train(dev, data, root, smi):
    """``classify train`` for yolov5s-cls 224 b64 f32: CLS_EPOCHS epochs from
    the device cache, then one with --no-device-aug, each epoch validated by
    the BN-folded EMA model (K2 once a val batch). Returns (launches, the
    device-cache run's directory)."""
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv

    torch_tf32_default()
    base = ["train", "--data", str(data), "--cfg", "yolov5s", "--imgsz", str(CLS_IMGSZ),
            "--batch-size", str(CLS_BATCH), "--project", str(Path(root) / "runs"),
            "--exist-ok", "--device", str(dev)]
    val_batches = CLS_CLASSES * CLS_VAL_PER_CLASS // CLS_BATCH
    launches = {"stem_conv": 0, "greedy_nms": 0}
    runs = {}
    for name, epochs, extra in (("cls_device", CLS_EPOCHS, []),
                                ("cls_host", 1, ["--no-device-aug"])):
        # the counted runs of the classification training path
        stem_conv.launches = greedy_nms.launches = 0
        t0 = time.perf_counter()
        out, text = _cls_cli(base + ["--name", name, "--epochs", str(epochs)] + extra)
        wall = time.perf_counter() - t0
        got = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
        if got != {"stem_conv": val_batches * epochs, "greedy_nms": 0}:
            raise AssertionError(f"classify train {name}: launches {got}, expected "
                                 f"{val_batches} K2 launches an epoch and no K1")
        if (name == "cls_device") != ("device cache:" in text):
            raise AssertionError(f"classify train {name}: device cache used: "
                                 f"{'device cache:' in text}")
        save_dir = Path(out["save_dir"])
        rows = _csv_rows(save_dir)
        losses = [float(r["train/loss"]) for r in rows]
        if len(rows) != epochs or not np.isfinite(losses).all():
            raise AssertionError(f"classify train {name}: {len(rows)} epochs, losses {losses}")
        for f in ("last.ckpt", "best.ckpt"):
            if not (save_dir / f).exists():
                raise AssertionError(f"classify train {name}: {f} not written")
        for k in launches:
            launches[k] += got[k]
        runs[name] = save_dir
        print(f"classify train {name}: yolov5s-cls {CLS_IMGSZ}px f32 b{CLS_BATCH}, {epochs} "
              f"epoch(s) x {CLS_CLASSES * CLS_TRAIN_PER_CLASS // CLS_BATCH} steps, {wall:.1f} s; "
              f"train/loss {np.round(losses, 5).tolist()}, train img/s "
              f"{[round(float(r['train/imgs_per_sec']), 2) for r in rows]} (results.csv, host "
              f"clock over each epoch); EMA val top1 {[float(r['val/top1']) for r in rows]}, top5 "
              f"{[float(r['val/top5']) for r in rows]}; K2 launches {got['stem_conv']} "
              f"({val_batches} a validated epoch) | {smi}")
    return launches, runs["cls_device"]


@contextlib.contextmanager
def captured_logits():
    """Record the logits of every batch that run_classify scores."""
    from yolov5_tpu_torch.train import run_classify

    saved = run_classify.classify_logits
    batches = []

    def record(model, images):
        batches.append(saved(model, images))
        return batches[-1]

    run_classify.classify_logits = record
    try:
        yield batches
    finally:
        run_classify.classify_logits = saved


def phase_classify_val(dev, data, run_dir, smi):
    """``classify val`` on best.ckpt (the counted run): K2 once a b64 batch,
    top-1/top-5 equal to the best epoch's EMA validation. Then, in f32 with
    TF32 off, validate_classify through K2 against its run through K2's
    plain version; K2 at b64 x 224² f32 against its plain version at the
    f32 tolerance and beside its bound, its plain version and cuDNN.
    Returns the launches."""
    import torch
    import torch.nn.functional as F

    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain
    from yolov5_tpu_torch.train.run_classify import (classify_logits, load_classifier,
                                                     validate_classify)

    torch_tf32_default()
    best = run_dir / "best.ckpt"
    best_epoch = json.loads(Path(str(best) + ".json").read_text())["epoch"]
    row = _csv_rows(run_dir)[best_epoch]
    n_val = CLS_CLASSES * CLS_VAL_PER_CLASS
    stem_conv.launches = greedy_nms.launches = 0
    t0 = time.perf_counter()
    out, _ = _cls_cli(["val", "--data", str(data), "--weights", str(best), "--batch-size",
                       str(CLS_BATCH), "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    if launches != {"stem_conv": -(-n_val // CLS_BATCH), "greedy_nms": 0}:
        raise AssertionError(f"classify val: launches {launches}")
    pairs = {k: (float(row[f"val/{k}"]), out[k]) for k in ("top1", "top5")}
    if out["images"] != n_val or any(a != b for a, b in pairs.values()):
        raise AssertionError(f"classify val on best.ckpt: {out['images']} images, "
                             f"{pairs} (training-time, classify val)")
    print(f"classify val on best.ckpt (epoch {best_epoch}): reproduces the EMA validation "
          f"{pairs}, loss {out['loss']:.5f}; {wall:.2f} s for {n_val} images "
          f"({1e3 * wall / n_val:.3f} ms/img host clock, BMP decode and center crop included); "
          f"launches {launches} | {smi}")

    # f32 without TF32: the path through K2 against the path through its
    # plain version, on the same checkpoint and images
    torch_tf32_off()
    with uncounted():
        with captured_logits() as a:
            res_a = validate_classify(str(best), str(data), batch_size=CLS_BATCH, verbose=False,
                                      device=dev)
        with routed(stem=stem_conv_plain), captured_logits() as b:
            res_b = validate_classify(str(best), str(data), batch_size=CLS_BATCH, verbose=False,
                                      device=dev)
    la, lb = torch.cat(a), torch.cat(b)
    rel = ((la - lb).abs().max(1).values / lb.abs().max(1).values).max().item()
    same_top1 = (la.argmax(1) == lb.argmax(1)).float().mean().item()
    d1, d5 = abs(res_a["top1"] - res_b["top1"]), abs(res_a["top5"] - res_b["top5"])
    print(f"classify val f32 (TF32 off), K2 against its plain version: logits within "
          f"{rel:.3g} of each row's largest (limit 1e-3), top-1 predictions equal in "
          f"{100 * same_top1:.2f}% (limit {100 * CLS_MATCH_MIN:.0f}%), top1 {res_a['top1']:.5f} / "
          f"{res_b['top1']:.5f}, top5 {res_a['top5']:.5f} / {res_b['top5']:.5f} (limit "
          f"1/{n_val}) | {smi}")
    if rel > 1e-3 or same_top1 < CLS_MATCH_MIN or max(d1, d5) > 1 / n_val + 1e-12:
        raise AssertionError(f"classify val, K2 against its plain version: rel {rel}, "
                             f"top-1 equal {same_top1}, top1/top5 differ by {d1}, {d5}")

    # K2 at the path's shape: the f32 tolerance on phase 3's inputs, and the
    # error on the path's own input (normalized images, EMA weights folded)
    model, _, _ = load_classifier(str(best), device=dev)
    images = torch.from_numpy(np.stack([im for im, _ in (
        _cls_val_ds(data).load(i) for i in range(CLS_BATCH))])).to(dev)
    captured = {}

    def capture_stem(x, w, bias):
        captured.update(stem=(x, w, bias))
        return stem_conv(x, w, bias)

    with uncounted():
        with routed(stem=capture_stem):
            classify_logits(model, images)
        x, w, bias = captured["stem"]
        path_err = (stem_conv(x, w, bias) - stem_conv_plain(x, w, bias)).abs().max().item()
        gen = torch.Generator(device=dev).manual_seed(18)
        xr = torch.rand(x.shape, generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)
        wr = (torch.rand(w.shape, generator=gen, device=dev) - 0.5) * 0.4
        br = torch.rand(bias.shape, generator=gen, device=dev) - 0.5
        got, ref = stem_conv(xr, wr, br), stem_conv_plain(xr, wr, br)
        err = (got - ref).abs()
        bad = int((err > 1e-5 + 1e-4 * ref.abs()).sum())
        if bad:
            raise AssertionError(f"K2 b{CLS_BATCH}x{CLS_IMGSZ} f32: {bad} elements out of "
                                 f"tolerance, max err {err.max().item()}")
        torch_tf32_default()
        k2 = cuda_ms(lambda: stem_conv(x, w, bias), iters=50)
        k2_alone = cuda_ms(stem_kernel_call(x, w, bias), iters=50)
        k2_plain = cuda_ms(lambda: stem_conv_plain(x, w, bias), iters=50)
        k2_cudnn = cuda_ms(lambda: F.silu(F.conv2d(x, w, bias, stride=2, padding=2)), iters=50)
        fwd = cuda_ms(lambda: classify_logits(model, images), iters=10)
        k2_bound, k2_by = stem_bound_ms(x, w.shape[0])
    print(f"K2 b{CLS_BATCH}x{CLS_IMGSZ} f32 c2={w.shape[0]} (yolov5s-cls stem, BN-folded EMA "
          f"model): {k2:.4f} ms through its wrapper, {k2_alone:.4f} ms the kernel alone; bound "
          f"{k2_bound:.4f} ms ({k2_by}), {100 * k2_bound / k2:.1f}% of it "
          f"({100 * k2_bound / k2_alone:.1f}% alone); plain {k2_plain:.3f} ms; cuDNN f32 conv + "
          f"SiLU (TF32, PyTorch's default) {k2_cudnn:.3f} ms; max abs err against the plain "
          f"version {err.max().item():.3g} on uniform inputs (atol 1e-5, rtol 1e-4), "
          f"{path_err:.3g} on the path's normalized input; the b{CLS_BATCH} forward "
          f"{fwd:.3f} ms ({fwd / CLS_BATCH:.4f} ms/img, CUDA events) | {smi}")
    return launches, {"ms": k2, "alone_ms": k2_alone, "plain_ms": k2_plain,
                      "bound_ms": k2_bound, "library_ms": k2_cudnn}


def _cls_val_ds(data):
    from yolov5_tpu_torch.data.classify import ImageFolder

    return ImageFolder(Path(data) / "val", CLS_IMGSZ)


def phase_classify_predict(dev, data, run_dir, root, smi):
    """``classify predict`` on CLS_PREDICT val BMPs (letterboxed to 224, b1,
    K2 once an image): each image's top-5 equal to a direct call on the
    same letterboxed input; hub.load(task="classify") on best.ckpt gives
    the same logits. Returns the launches."""
    import torch

    from yolov5_tpu_torch import hub
    from yolov5_tpu_torch.data.sources import LoadImages
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv
    from yolov5_tpu_torch.train.run_classify import classify_logits, load_classifier

    torch_tf32_default()
    src = Path(root) / "cls_predict"
    src.mkdir()
    files = [f for c in sorted((Path(data) / "val").iterdir()) for f in sorted(c.iterdir())]
    for f in files[::len(files) // CLS_PREDICT][:CLS_PREDICT]:
        (src / f"{f.parent.name}_{f.name}").symlink_to(f)
    best = str(run_dir / "best.ckpt")
    stem_conv.launches = greedy_nms.launches = 0
    t0 = time.perf_counter()
    out, _ = _cls_cli(["predict", "--weights", best, "--source", str(src), "--imgsz",
                       str(CLS_IMGSZ), "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
    if launches != {"stem_conv": CLS_PREDICT, "greedy_nms": 0} or len(out) != CLS_PREDICT:
        raise AssertionError(f"classify predict: {len(out)} images, launches {launches}")
    with uncounted():
        model, names, _ = load_classifier(best, device=dev)
        cls = hub.load(best, task="classify", device=dev)
        hits = 0
        for (path, top), (p2, im, _, _) in zip(out, LoadImages(str(src), img_size=CLS_IMGSZ)):
            x = torch.from_numpy(im[None]).to(dev)
            logits = classify_logits(model, x)
            prob = torch.softmax(logits.double(), 1)[0]
            ref = [names[int(i)] for i in torch.argsort(-prob, stable=True)[:5]]
            if path != p2 or [c for c, _ in top] != ref or not torch.equal(
                    classify_logits(cls, x), logits):
                raise AssertionError(f"classify predict {path}: {top} against {ref}")
            if not all(0.0 <= p <= 1.0 for _, p in top):
                raise AssertionError(f"classify predict {path}: probabilities {top}")
            hits += top[0][0] == Path(path).name.split("_")[0]
    print(f"classify predict: {CLS_PREDICT} val BMPs letterboxed to {CLS_IMGSZ}, b1, top-5 "
          f"equal to a direct call and to hub.load(task='classify'); top-1 the image's class "
          f"in {hits}/{CLS_PREDICT}; {1e3 * wall / CLS_PREDICT:.3f} ms/img (host clock, model "
          f"load included); launches {launches} | {smi}")
    return launches


def phase_classify_times(dev, smi):
    """The yolov5s-cls b64 224 f32 train step from the device cache (device
    augmentation inside) by CUDA events, its profile line and peak memory."""
    import torch

    from yolov5_tpu_torch.models.yolo import ClassificationModel
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.run_classify import make_classify_step
    from yolov5_tpu_torch.train.trainer import init_train_state

    torch_tf32_default()
    n = CLS_CLASSES * CLS_TRAIN_PER_CLASS
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = {"images": torch.randint(0, 256, (n, CLS_IMGSZ, CLS_IMGSZ, 3), generator=gen,
                                     device=dev, dtype=torch.uint8),
             "labels": torch.randint(0, CLS_CLASSES, (n,), generator=gen, device=dev)}
    model = ClassificationModel("yolov5s", nc=CLS_CLASSES).to(dev).to(
        memory_format=torch.channels_last)
    hyp = {"lr0": 0.001, "lrf": 0.01, "momentum": 0.9, "weight_decay": 5e-5,
           "warmup_epochs": 0.0, "warmup_bias_lr": 0.0, "warmup_momentum": 0.9}
    state = init_train_state(model, Optimizer(dict(model.named_parameters()), hyp, CLS_EPOCHS,
                                              n // CLS_BATCH, 64, name="adam", cos_lr=True))
    step = make_classify_step(0.1, seed=0, device_aug=True)
    idx = {"idx": torch.arange(CLS_BATCH, device=dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    t_step = cuda_ms(lambda: step(state, idx, cache), iters=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    line = profile_line(lambda: step(state, idx, cache),
                        f"classify train step b{CLS_BATCH} {CLS_IMGSZ}px f32 from the device cache",
                        smi)
    print(f"classify train step, yolov5s-cls b{CLS_BATCH} {CLS_IMGSZ}px f32 (device augmentation "
          f"from the device cache, forward, backward, Adam, EMA; CUDA events over 10 warm "
          f"steps): {t_step:.3f} ms ({CLS_BATCH / t_step * 1e3:.1f} img/s); peak memory "
          f"{peak:.2f} GiB | {smi}")
    print(line)


# phase 19: the model zoo
ZOO_BATCH = 2
# BN scales of the zoo's calibrated weights. With U(0.5, 1.5) the deepest
# random models are chaotic: yolov5x6 at 1280 turns a relative noise of 1e-7
# on its plain stem's output (an f32 ulp) into raw maps 0.9% apart and other
# detections; at U(0.1, 0.4) 1e-5 moves them 0.66% and K2's rounding 0.25%
# (NVIDIA H100 80GB HBM3, 700 W)
ZOO_GAMMA = (0.1, 0.4)
ZOO_IMGSZ_P6 = 1280  # the yolov5{n,s,m,l,x}6 configs' own size
ZOO_CONF, ZOO_IOU, ZOO_MAX_DET = 0.001, 0.6, 300  # the val defaults: max_det cuts every image
ZOO_TRAIN = ("yolov5s-transformer", "yolov5s-ghost", "yolov3")
ZOO_TRAIN_BATCH = 16
ZOO_TRAIN_STEPS = 3
ZOO_CLI = "yolov5s-transformer"
ZOO_TIMED = ("yolov3", "yolov3-spp", "yolov3-tiny", "yolov5s-ghost", "yolov5s-transformer",
             "yolov5s6")
ZOO_TIME_BATCH = 16
ZOO_STEM_BATCH = 8


def zoo_configs():
    """Every bundled model config (hub.list_models)."""
    from yolov5_tpu_torch.hub import list_models

    return list_models()


def zoo_imgsz(name):
    return ZOO_IMGSZ_P6 if re.fullmatch(r"yolov5[nsmlx]6", name) else IMGSZ


def zoo_stem_expected(name):
    """True where the config's stem is the 6x6/s2/p2 Conv with SiLU (no
    global activation), the stem K2 computes once BN is folded: read from
    the YAML, not from the model."""
    from yolov5_tpu_torch.models.yolo import load_config

    cfg = load_config(name)
    f, n, m, args = cfg["backbone"][0]
    return (m == "Conv" and list(args[1:4]) == [6, 2, 2]
            and cfg.get("activation") in (None, "nn.SiLU()", "silu"))


def _zoo_model(name, weights, dev, half=False):
    """A BN-folded predictor of ``name`` on the card and its call: uint8
    (b, s, s, 3) -> padded Detections (Detector.__call__, NMS from the raw
    maps, for a Detect head; Segmenter.forward then non_max_suppression for
    a Segment head)."""
    from yolov5_tpu_torch.infer import Detector
    from yolov5_tpu_torch.infer_segment import Segmenter
    from yolov5_tpu_torch.ops.nms import non_max_suppression

    kw = dict(conf_thres=ZOO_CONF, iou_thres=ZOO_IOU, max_det=ZOO_MAX_DET)
    if name.endswith("-seg"):
        seg = Segmenter(weights, cfg=name, device=dev, half=half)
        return seg, lambda b: non_max_suppression(seg.forward(b)[0], nc=seg.nc, **kw)
    det = Detector(weights, cfg=name, imgsz=zoo_imgsz(name), device=dev, half=half)
    return det, lambda b: det(b, **kw)


def _zoo_match(a, b, px=1.0):
    """Per-image rows of two runs cut by max_det: whether the counts are
    equal, and of a's detections scoring over 1.01x their image's lowest
    kept score (near-ties at the cut may trade places), how many b has
    within px (same class), of how many."""
    same = [len(x) for x in a] == [len(x) for x in b]
    hit = total = 0
    for ra, rb in zip(a, b):
        top = ra[ra[:, 4] > 1.01 * ra[:, 4].min()] if len(ra) else ra
        h, t, _, _ = match_detections([top], [rb], px)
        hit, total = hit + h, total + t
    return same, hit, total


def phase_zoo_detect(dev, root, smi):
    """Every bundled config at full width, BN folded, calibrated weights
    (BN scales U(ZOO_GAMMA)), f32 without TF32, forward + NMS at b2 (1280
    px for the *6 configs): K1 every time, K2 exactly where the stem is
    6x6/s2 SiLU, and the same batch through both plain versions."""
    import torch

    from yolov5_tpu_torch.data.imageio import imread
    from yolov5_tpu_torch.data.letterbox import letterbox
    from yolov5_tpu_torch.ops.nms import detections_to_numpy
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    torch_tf32_off()
    im0s = [imread(p) for p in sorted((Path(root) / "images" / "val").glob("*.bmp"))[:ZOO_BATCH]]
    launches = {"stem_conv": 0, "greedy_nms": 0}
    weights, lines, bad = {}, [], []
    for name in zoo_configs():
        s = zoo_imgsz(name)
        batch = np.stack([letterbox(im, s)[0][..., ::-1] for im in im0s])
        sd = calibrated_weights(name, 0, batch, dev, gamma=ZOO_GAMMA)
        if name in ZOO_TIMED or name == "yolov5-p2":
            weights[name] = sd  # phase_zoo_times runs these again
        _, call = _zoo_model(name, sd, dev)
        with uncounted():
            call(batch)  # warm up: cuDNN picks its algorithms, K1/K2 load
        stem_conv.launches = greedy_nms.launches = 0
        dets = call(batch)
        torch.cuda.synchronize()
        got = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
        for k in launches:
            launches[k] += got[k]
        with routed(stem_conv_plain, greedy_nms_plain), uncounted():
            twin = call(batch)
        a, b = detections_to_numpy(dets), detections_to_numpy(twin)
        same, hit, total = _zoo_match(a, b)
        stem_ok = (got["stem_conv"] > 0) == zoo_stem_expected(name)
        lines.append(f"{name} {s}px: {sum(map(len, a))} detections, launches (stem, nms) "
                     f"({got['stem_conv']}, {got['greedy_nms']}); vs plain: counts "
                     f"{'equal' if same else 'DIFFER'}, {hit}/{total} matched")
        if got["greedy_nms"] < 1 or not stem_ok or not same or hit < 0.99 * total:
            bad.append(lines[-1])
    print(f"zoo detect: {len(lines)} configs at full width, BN folded, b{ZOO_BATCH} f32 (TF32 "
          f"off), conf {ZOO_CONF} IoU {ZOO_IOU} max_det {ZOO_MAX_DET}; K2 expected where the "
          f"stem is 6x6/s2 SiLU; against both plain versions: equal counts and >= 99% of the "
          f"detections over 1.01x their image's cut within 1 px:\n  " + "\n  ".join(lines))
    if bad:
        raise AssertionError("zoo detect:\n  " + "\n  ".join(bad))
    return weights, launches


def phase_zoo_train(dev, data, smi):
    """ZOO_TRAIN at full width: ZOO_TRAIN_STEPS train steps each at
    b16@640, bf16 autocast, device augmentation from the device cache."""
    import torch

    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.data.device_cache import build_cache_arrays, to_device
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.loss import ComputeLoss
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
    from yolov5_tpu_torch.utils.general import check_dataset
    from yolov5_tpu_torch.utils.hyp import load_hyp

    torch_tf32_default()
    hyp = load_hyp("scratch-low")
    ds, loader = create_loader(check_dataset(str(data))["train"], img_size=IMGSZ,
                               batch_size=ZOO_TRAIN_BATCH, augment=True, device_aug=True)
    cache = to_device(build_cache_arrays(ds, loader.max_labels), dev)
    for name in ZOO_TRAIN:
        model = DetectionModel(name, nc=VAL_CLASSES).to(dev).to(
            memory_format=torch.channels_last)
        scaled = scale_hyp(hyp, nl=len(model.stride), nc=VAL_CLASSES, imgsz=IMGSZ)
        state = init_train_state(model, Optimizer(dict(model.named_parameters()), scaled, 1,
                                                  len(loader), ZOO_TRAIN_BATCH))
        step = make_train_step(ComputeLoss(model.anchors_per_stride, VAL_CLASSES, scaled), hyp,
                               dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses = [], []
        for i in range(ZOO_TRAIN_STEPS):
            idx = torch.arange(i * ZOO_TRAIN_BATCH, (i + 1) * ZOO_TRAIN_BATCH, device=dev) % len(ds)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step(state, {"idx": idx}, cache)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append([float(metrics[k]) for k in ("box", "obj", "cls", "total")])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"zoo train: {name} b{ZOO_TRAIN_BATCH} {IMGSZ}px bf16 autocast, device "
              f"augmentation from the device cache, {ZOO_TRAIN_STEPS} steps: ms/step "
              f"{[round(t, 3) for t in ms]} (the first with cuDNN's algorithm search; CUDA "
              f"events); losses (box, obj, cls, total) {np.round(losses, 5).tolist()}; peak "
              f"memory {peak:.2f} GiB | {smi}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"zoo train {name}: losses not finite {losses}")
        del model, state, step


def _cli(module, argv):
    """``python -m <module> <argv>`` in this process; what it printed
    (captured, not shown: the detect CLI prints a line an image)."""
    import importlib

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(module).main(argv)
    return out.getvalue()


def phase_zoo_cli(dev, data, root, smi):
    """``train --cfg yolov5s-transformer`` for one epoch ending in its EMA
    validation, then ``val`` and ``detect`` on its best.ckpt: K1 and K2 rise
    in each."""
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.ops.stem import stem_conv

    project = Path(root) / "runs"
    run_dir = project / "zoo_cli"
    steps = [("train", "yolov5_tpu_torch.train.__main__",
              ["--data", str(data), "--cfg", ZOO_CLI, "--epochs", "1", "--batch-size", str(BATCH),
               "--imgsz", str(IMGSZ), "--device-aug", "--cache", "device", "--project",
               str(project), "--name", "zoo_cli", "--exist-ok", "--device", str(dev)]),
             ("val", "yolov5_tpu_torch.val",
              ["--data", str(data), "--weights", str(run_dir / "best.ckpt"), "--imgsz",
               str(IMGSZ), "--batch-size", str(BATCH), "--half", "--no-verbose", "--project",
               str(project), "--name", "zoo_val", "--exist-ok", "--device", str(dev)]),
             ("detect", "yolov5_tpu_torch.detect",
              ["--weights", str(run_dir / "best.ckpt"), "--source",
               str(Path(root) / "images" / "val"), "--imgsz", str(IMGSZ), "--batch-size",
               str(BATCH), "--half", "--nosave", "--save-txt", "--project", str(project),
               "--name", "zoo_detect", "--exist-ok", "--device", str(dev)])]
    launches = {"stem_conv": 0, "greedy_nms": 0}
    parts = []
    for what, module, argv in steps:
        stem_conv.launches = greedy_nms.launches = 0
        t0 = time.perf_counter()
        out = _cli(module, argv)
        wall = time.perf_counter() - t0
        got = {"stem_conv": stem_conv.launches, "greedy_nms": greedy_nms.launches}
        if min(got.values()) < 1:
            raise AssertionError(f"zoo cli {what}: launches {got}")
        for k in launches:
            launches[k] += got[k]
        last = out.strip().splitlines()[-1]
        parts.append(f"{what} {wall:.1f} s, launches (stem, nms) ({got['stem_conv']}, "
                     f"{got['greedy_nms']}): {last[:160]}")
    rows = _csv_rows(run_dir)
    losses = [float(rows[-1][f"train/{k}"]) for k in ("box", "obj", "cls", "total")]
    if not np.isfinite(losses).all():
        raise AssertionError(f"zoo cli: train losses {losses}")
    print(f"zoo cli, {ZOO_CLI} {IMGSZ}px b{BATCH} bf16 (--device-aug --cache device):\n  "
          + "\n  ".join(parts) + f" | {smi}")
    return launches


def phase_zoo_times(dev, weights, smi):
    """The forward ms per b16 batch (bf16) of the new configs and yolov5s6
    at 1280; K2 at b8 x 1280² bf16 and K1 at the 2048 cap of P2's and
    yolov5s6's 102 000 candidates, beside their bounds, plain versions and
    the library call; a profile line of the ghost forward."""
    import torch
    import torch.nn.functional as F

    from yolov5_tpu_torch.ops.nms import non_max_suppression_from_maps
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    torch_tf32_default()
    gen = torch.Generator(device=dev).manual_seed(19)
    parts = []
    k1 = {}
    for name in (*ZOO_TIMED, "yolov5-p2"):
        s = zoo_imgsz(name)
        det, _ = _zoo_model(name, weights[name], dev, half=True)
        images = torch.randint(0, 256, (ZOO_TIME_BATCH, s, s, 3), generator=gen, device=dev,
                               dtype=torch.uint8)
        if name in ZOO_TIMED:
            fwd = cuda_ms(lambda: det.forward_maps(images), iters=10)
            parts.append(f"{name} {s}px {fwd:.3f} ms ({ZOO_TIME_BATCH / fwd * 1e3:.1f} img/s)")
        if name == "yolov5s-ghost":
            ghost = profile_line(lambda: det.forward_maps(images),
                                 f"yolov5s-ghost forward b{ZOO_TIME_BATCH} {s}px bf16", smi)
        if name in ("yolov5-p2", "yolov5s6"):
            maps = det.forward_maps(images)
            n_cand = sum(m.shape[1] * m.shape[2] * m.shape[3] for m in maps)
            captured = {}

            def capture(boxes, scores, thres, max_det):
                captured.update(args=(boxes, scores, thres, max_det))
                return greedy_nms(boxes, scores, thres, max_det)

            with routed(nms=capture):
                non_max_suppression_from_maps(maps, det.anchors, det.stride, conf_thres=0.01,
                                              max_nms=2048, max_det=1000, nc=det.nc)
            args = captured["args"]
            with uncounted():
                if not torch.equal(greedy_nms(*args), greedy_nms_plain(*args)):
                    raise AssertionError(f"zoo times: K1 at {name}'s candidates differs from "
                                         "its plain version")
                t = cuda_ms(lambda: greedy_nms(*args), iters=20)
                t_plain = cuda_ms(lambda: greedy_nms_plain(*args), iters=2, warmup=1)
            bound, by, n_iou = nms_bound_ms(*args)
            k1[name] = dict(ms=t, plain_ms=t_plain, bound_ms=bound, bound_by=by,
                            library_ms=None, candidates=n_cand, shape=list(args[1].shape))
        if name == "yolov5s6":
            stem = det.model.model[0]
            w, b = stem.conv.weight, stem.conv.bias
    print(f"zoo forward, b{ZOO_TIME_BATCH} bf16, BN folded (CUDA events): " + "; ".join(parts)
          + f" | {smi}")
    print(ghost)
    for name, r in k1.items():
        print(f"K1 at {name}'s {r['candidates']} candidates, cut to the 2048 cap ({r['shape']}), "
              f"IoU 0.45 max_det 1000: {r['ms']:.4f} ms; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.2f}% of it; plain "
              f"{r['plain_ms']:.3f} ms; no library call; masks equal the plain version's | {smi}")

    # K2 at the P6 size: b8 x 1280², bf16, yolov5s6's folded stem
    x = torch.rand((ZOO_STEM_BATCH, 3, ZOO_IMGSZ_P6, ZOO_IMGSZ_P6), generator=gen, device=dev)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
    with uncounted():
        torch_tf32_off()
        err = (stem_conv(x, w, b).float() - stem_conv_plain(x, w, b).float()).abs()
        ref = stem_conv_plain(x, w, b).float()
        if (err > bf16_ulp(ref) + 1e-5).any():
            raise AssertionError(f"zoo times: K2 at b{ZOO_STEM_BATCH}x{ZOO_IMGSZ_P6} bf16 off its "
                                 f"plain version by {err.max().item()}")
        torch_tf32_default()
        k2 = cuda_ms(lambda: stem_conv(x, w, b), iters=20)
        k2_plain = cuda_ms(lambda: stem_conv_plain(x, w, b), iters=20)
        k2_cudnn = cuda_ms(lambda: F.silu(F.conv2d(x, w, b, stride=2, padding=2)), iters=20)
    k2_bound, k2_by = stem_bound_ms(x, w.shape[0])
    print(f"K2 b{ZOO_STEM_BATCH}x{ZOO_IMGSZ_P6}² bf16 c2={w.shape[0]} (yolov5s6's stem): "
          f"{k2:.4f} ms; bound {k2_bound:.4f} ms ({k2_by}), {100 * k2_bound / k2:.1f}% of it; "
          f"plain {k2_plain:.3f} ms; cuDNN bf16 conv + SiLU {k2_cudnn:.3f} ms; within one bf16 "
          f"ulp of the plain version (max err {err.max().item():.3g}) | {smi}")
    return {"greedy_nms": k1, "stem_conv": dict(ms=k2, plain_ms=k2_plain, bound_ms=k2_bound,
                                                 bound_by=k2_by, library_ms=k2_cudnn)}


def phase_zoo(dev, root, train_data, smi):
    """Phase 19: the model zoo (a)-(d); its wall time."""
    t0 = time.perf_counter()
    weights, detect_launches = phase_zoo_detect(dev, root, smi)
    phase_zoo_train(dev, train_data, smi)
    cli_launches = phase_zoo_cli(dev, train_data, root, smi)
    times = phase_zoo_times(dev, weights, smi)
    print(f"zoo: phase 19 in {time.perf_counter() - t0:.1f} s")
    return {k: detect_launches[k] + cli_launches[k] for k in detect_launches}, times


# phase 20: export and the exported backends, yolov5s at 640 px in f32 with
# phase 13's calibrated weights; the KServe phase's images (a b1 request's
# JSON body is ~5 MB in and ~40 MB out), and autobatch's probe batches
KSERVE_IMAGES = 2
AUTOBATCH_PROBES = (16, 64)


def _export_cli(argv):
    """``python -m yolov5_tpu_torch.export <argv>`` in this process: its
    artifacts, wall seconds, and each format's (MB, s) from its report."""
    t0 = time.perf_counter()
    out = _cli("yolov5_tpu_torch.export", argv)
    wall = time.perf_counter() - t0
    sizes = {m.group(1): (float(m.group(2)), float(m.group(3)))
             for m in re.finditer(r"export (\w+): ok, \S+ \(([\d.]+) MB, ([\d.]+)s\)", out)}
    arts = {m.group(1): Path(m.group(2))
            for m in re.finditer(r"'(\w+)': '([^']+)'", out.strip().splitlines()[-1])}
    traced = re.search(r"export: traced .* in ([\d.]+)s", out)
    if set(sizes) != {"ckpt", "pt2", "onnx"} or not all(a.exists() for a in arts.values()):
        raise AssertionError(f"export {argv}: {out[-2000:]}")
    return arts, wall, sizes, float(traced.group(1))


def phase_export(dev, root, data, weights, trained, smi):
    """Phase 20 (a)-(g): export yolov5s at b32 and b1 with the CLI, then the
    .onnx on the card through Detector, val (on the export of ``trained``,
    phase 11's best.ckpt), detect, a KServe server and --dnn, against the
    BN-folded model; the runtime's and the forwards' times, autobatch and
    model_info. Returns the kernels' launches on the exported paths (K2's
    must be 0) and the phase's numbers."""
    import torch

    from yolov5_tpu_torch import export as export_mod
    from yolov5_tpu_torch import infer
    from yolov5_tpu_torch.data.letterbox import scale_boxes_np
    from yolov5_tpu_torch.eval.evaluator import run as val_run
    from yolov5_tpu_torch.ops.nms import detections_to_numpy
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms
    from yolov5_tpu_torch.onnx.kserve import serve_kserve
    from yolov5_tpu_torch.onnx.runtime import Runtime
    from yolov5_tpu_torch.ops.stem import stem_conv

    def reset():
        stem_conv.launches = greedy_nms.launches = 0

    def read(path):
        launches[path], stem_launches[path] = greedy_nms.launches, stem_conv.launches

    launches, stem_launches = {}, {}
    t_phase = time.perf_counter()
    torch_tf32_off()
    out_dir = Path(root) / "export"
    paths, im0s, batch = smoke_sources(root)
    # (a) the CLI at b32 and at b1, from a fused .ckpt of the calibrated weights
    with contextlib.redirect_stdout(io.StringIO()):
        src = export_mod.run(weights=weights, cfg="yolov5s", imgsz=IMGSZ, include=("ckpt",),
                             output_dir=str(out_dir), name="calibrated", device=dev)["ckpt"]
    made = {}
    for bs in (BATCH, 1):
        made[bs] = _export_cli(["--weights", str(src), "--imgsz", str(IMGSZ), "--batch-size",
                                str(bs), "--include", "ckpt", "pt2", "onnx", "--output-dir",
                                str(out_dir / f"b{bs}")])
    print(f"export (a): python -m yolov5_tpu_torch.export yolov5s {IMGSZ}px f32 --include ckpt "
          "pt2 onnx: " + "; ".join(
              f"b{bs} {wall:.1f} s wall (trace {traced:.1f} s; "
              + ", ".join(f"{k} {mb:.1f} MB in {sec:.1f} s" for k, (mb, sec) in sizes.items())
              + ")" for bs, (_, wall, sizes, traced) in made.items()) + f" | {smi}")
    onnx32, onnx1 = made[BATCH][0]["onnx"], made[1][0]["onnx"]

    # (b) the .onnx on the card against the BN-folded model (K2 in f32)
    images = torch.from_numpy(batch).to(dev)
    det = infer.Detector(str(onnx32))
    if det.backend != "onnx" or det.model is not None or det.device.type != dev.type:
        raise AssertionError(f"export (b): backend {det.backend} on {det.device}")
    reset()
    with uncounted():
        ref_det = infer.Detector(weights, cfg="yolov5s", imgsz=IMGSZ, device=dev)
        ref_pred = ref_det.forward(images)
        ref_rows = detections_to_numpy(ref_det(images))
    pred = det.forward(images)
    err = (pred - ref_pred).abs().max().item()
    scale = ref_pred.abs().max().item()
    rows = detections_to_numpy(det(images))
    read("b")
    same_counts = [len(r) for r in rows] == [len(r) for r in ref_rows]
    hit, total, score_diff, box_err = match_detections(rows, ref_rows)
    print(f"export (b): Detector(.onnx) on {det.device} b{BATCH}: decoded predictions within "
          f"{err:.3g} of the BN-folded Detector.forward f32 (largest {scale:.4g}, relative "
          f"{err / scale:.3g}); conf 0.25: {sum(map(len, rows))} detections, counts "
          f"{'equal' if same_counts else 'DIFFER'}, {hit}/{total} within 1 px (max box "
          f"{box_err:.3g} px, score {score_diff:.3g}); K1 launches {launches['b']}, K2 "
          f"{stem_launches['b']} | {smi}")
    if err > 1e-3 * scale or launches["b"] < 1 or not same_counts or hit < 0.99 * total:
        raise AssertionError("export (b): the .onnx on the card differs from the model")

    # (c) val --weights x.onnx (b32) against val of the fused .ckpt at
    # rect=False, both exported from phase 11's trained yolov5s: its classes
    # are the val set's, so P, R and the mAPs are not all zero
    with contextlib.redirect_stdout(io.StringIO()):
        val_arts = export_mod.run(weights=str(trained), cfg="yolov5s", imgsz=IMGSZ,
                                  batch_size=BATCH, include=("ckpt", "onnx"),
                                  output_dir=str(out_dir / "trained"), device=dev)
    reset()
    with captured_detections() as val_rows:
        cli = _cli("yolov5_tpu_torch.val", ["--data", str(data), "--weights",
                                            str(val_arts["onnx"]), "--imgsz", str(IMGSZ),
                                            "--batch-size", str(BATCH), "--workers", "0",
                                            "--no-verbose"])
    got = json.loads(cli.strip().splitlines()[-1])
    with uncounted(), contextlib.redirect_stdout(io.StringIO()), \
            captured_detections() as ckpt_rows:
        ref = val_run(str(data), weights=str(val_arts["ckpt"]), imgsz=IMGSZ,
                      batch_size=BATCH, rect=False, workers=0, verbose=False, device=dev)
    read("c")
    diffs = {k: abs(got[k] - ref[k]) for k in ("mp", "mr", "map50", "map")}
    a, b = (sum(batches, []) for batches in (val_rows, ckpt_rows))
    val_counts = [len(r) for r in a] == [len(r) for r in b]
    v_hit, v_total, *_ = match_detections(a, b)
    print(f"export (c): val --weights .onnx b{BATCH} (phase 11's best.ckpt): P {got['mp']:.5f} R {got['mr']:.5f} "
          f"mAP50 {got['map50']:.5f} mAP50-95 {got['map']:.5f} over {got['images']} images "
          f"(speed_ms {got['speed_ms']}); the fused .ckpt at --no-rect: P {ref['mp']:.5f} "
          f"R {ref['mr']:.5f} mAP50 {ref['map50']:.5f} mAP50-95 {ref['map']:.5f}; largest "
          f"difference {max(diffs.values()):.3g}; detections (conf 0.001, max_det 300) counts "
          f"{'equal' if val_counts else 'DIFFER'}, {v_hit}/{v_total} within 1 px; K1 launches "
          f"{launches['c']}, K2 {stem_launches['c']} | {smi}")
    if max(diffs.values()) > 1e-3 or not ref["map50"] > 0 or launches["c"] < 1 \
            or not val_counts or v_hit < 0.99 * v_total:
        raise AssertionError(f"export (c): val of the .onnx against the .ckpt: {diffs}")

    # (d) detect --weights x.onnx (b1) over the smoke sources: txt rows =
    # Detector.__call__ on the same images
    src_dir = Path(root) / "export_sources"
    src_dir.mkdir(exist_ok=True)
    for p in paths:
        (src_dir / p.name).write_bytes(p.read_bytes())
    reset()
    t0 = time.perf_counter()
    _cli("yolov5_tpu_torch.detect", ["--weights", str(onnx1), "--source", str(src_dir),
                                     "--imgsz", str(IMGSZ),
                                     "--save-txt", "--nosave", "--project",
                                     str(Path(root) / "runs"), "--name", "export_detect",
                                     "--exist-ok"])
    detect_s = time.perf_counter() - t0
    read("d")
    save_dir = Path(root) / "runs" / "export_detect"
    det1 = infer.Detector(str(onnx1))
    n_rows = 0
    with uncounted():
        for p, im0, lb in zip(paths, im0s, batch):
            r = detections_to_numpy(det1(lb[None]))[0]
            r[:, :4] = scale_boxes_np(batch.shape[1:3], r[:, :4], im0.shape[:2])
            txt = save_dir / "labels" / f"{p.stem}.txt"
            if (txt.read_text().splitlines() if txt.exists() else []) != _txt_lines(r, im0):
                raise AssertionError(f"export (d): {txt.name} differs from Detector.__call__")
            n_rows += len(r)
    print(f"export (d): detect --weights .onnx b1 over {len(paths)} BMPs in {detect_s:.1f} s "
          f"(model load included): every txt equals Detector.__call__ ({n_rows} rows); K1 "
          f"launches {launches['d']}, K2 {stem_launches['d']} | {smi}")
    if launches["d"] < len(paths):
        raise AssertionError(f"export (d): K1 launched {launches['d']} times for {len(paths)} "
                             "images")

    # (e) a KServe v2 server on 127.0.0.1 running the b1 .onnx; Detector("triton+http://")
    with serve_kserve(Runtime(Path(onnx1).read_bytes(), device=dev)) as url:
        reset()
        remote = infer.Detector(f"triton+{url}/det", imgsz=IMGSZ)
        t0 = time.perf_counter()
        kserve_rows = [detections_to_numpy(remote(batch[i:i + 1]))[0]
                       for i in range(KSERVE_IMAGES)]
        kserve_ms = 1e3 * (time.perf_counter() - t0) / KSERVE_IMAGES
        read("e")
    same = [len(r) for r in kserve_rows] == [len(r) for r in rows[:KSERVE_IMAGES]]
    k_hit, k_total, *_ = match_detections(kserve_rows, rows[:KSERVE_IMAGES])
    print(f"export (e): Detector(triton+http://127.0.0.1/det) over a KServe v2 server running "
          f"the b1 .onnx on the card: {KSERVE_IMAGES} images, counts "
          f"{'equal' if same else 'DIFFER'} to (b), {k_hit}/{k_total} within 1 px; "
          f"{kserve_ms:.0f} ms/image (JSON tensors); K1 launches {launches['e']}, K2 "
          f"{stem_launches['e']} | {smi}")
    if not same or k_hit < 0.99 * k_total or launches["e"] < KSERVE_IMAGES:
        raise AssertionError("export (e): the remote detections differ from (b)")

    # (f) --dnn: OpenCV's DNN module where OpenCV is installed, else ImportError naming it
    try:
        dnn = infer.Detector(str(onnx1), dnn=True)
    except ImportError as e:
        if "OpenCV" not in str(e):
            raise
        print(f"export (f): --dnn raises ImportError naming OpenCV: {e}")
    else:
        a = dnn.forward(batch[:1])
        b = det1.forward(batch[:1])
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=2e-3, rtol=2e-3)
        print(f"export (f): --dnn (OpenCV {__import__('cv2').__version__}) within 2e-3 of "
              f"the runtime (max {(a - b).abs().max().item():.3g})")

    # (g) times by CUDA events, the runtime's launches, autobatch, model_info
    times = phase_export_times(dev, det, onnx32, ref_det, weights, images, smi)
    print(f"export: phase 20 in {time.perf_counter() - t_phase:.1f} s")
    if any(stem_launches.values()):
        raise AssertionError(f"export: K2 launched on an exported path: {stem_launches}")
    return {"greedy_nms": sum(launches.values()), "stem_conv": sum(stem_launches.values())}, \
        dict(times, max_abs_err=err, launches_by_path=launches, val_map50=ref["map50"])


def phase_export_times(dev, det, onnx_path, ref_det, weights, images, smi):
    """Phase 20 (g): the ONNX runtime's b32 forward beside Detector.forward
    in f32 and bf16, its launches per call (profiler), autobatch's batch for
    the yolov5s 640 bf16 train step and one step at it, model_info."""
    import torch

    from yolov5_tpu_torch import infer
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.loss import ComputeLoss
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
    from yolov5_tpu_torch.utils.autobatch import autobatch, device_memory_bytes
    from yolov5_tpu_torch.utils.hyp import load_hyp
    from yolov5_tpu_torch.utils.profile import model_info

    with uncounted():
        half = infer.Detector(weights, cfg="yolov5s", imgsz=IMGSZ, half=True, device=dev)
        rt_ms = cuda_ms(lambda: det.forward(images), iters=5)
        f32_ms = cuda_ms(lambda: ref_det.forward(images), iters=5)
        bf16_ms = cuda_ms(lambda: half.forward(images), iters=5)
        line = profile_line(lambda: det.forward(images), f"ONNX runtime forward b{BATCH} "
                            f"{IMGSZ}px f32", smi)
    from yolov5_tpu_torch.onnx import proto

    n_nodes = len(proto.parse_model(Path(onnx_path).read_bytes()).graph.nodes)
    print(f"export (g): b{BATCH} {IMGSZ}px decoded forward: ONNX runtime {rt_ms:.3f} ms "
          f"({n_nodes} nodes a call), Detector.forward f32 {f32_ms:.3f} ms, bf16 "
          f"{bf16_ms:.3f} ms (CUDA events) | {smi}")
    print(line)
    del half

    # autobatch: the bf16 train step on a resident batch of bs images
    hyp = load_hyp("scratch-low")
    model = DetectionModel("yolov5s", nc=VAL_CLASSES).to(dev).to(memory_format=torch.channels_last)
    scaled = scale_hyp(hyp, nl=3, nc=VAL_CLASSES, imgsz=IMGSZ)
    loss_fn = ComputeLoss(model.anchors_per_stride, VAL_CLASSES, scaled)
    state = init_train_state(model, Optimizer(dict(model.named_parameters()), scaled, 1, 1, BATCH))
    step = make_train_step(loss_fn, None, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)

    def make(bs):
        boxes = torch.rand((bs, 8, 4), device=dev, generator=gen) * 0.3 + 0.2
        batch = {"images": torch.randint(0, 256, (bs, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                                         device=dev, generator=gen),
                 "targets": torch.cat([torch.randint(0, VAL_CLASSES, (bs, 8, 1), device=dev,
                                                     generator=gen).float(), boxes], -1),
                 "valid": torch.ones((bs, 8), dtype=torch.bool, device=dev)}
        return step, state, batch

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        bs = autobatch(make, probes=AUTOBATCH_PROBES)
    limit = 0.8 * device_memory_bytes()
    _, _, chosen = make(bs)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: step(state, chosen), iters=2, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev)
    del chosen, state, model
    torch.cuda.empty_cache()
    print(f"export (g): {printed.getvalue().strip()} (probes b{AUTOBATCH_PROBES[0]}, "
          f"b{AUTOBATCH_PROBES[1]}); one yolov5s {IMGSZ}px bf16 train step at b{bs}: "
          f"{step_ms:.1f} ms, peak {peak / 2 ** 30:.2f} GiB "
          f"({'within' if peak <= limit else 'OVER'}) the {limit / 2 ** 30:.2f} GiB limit | {smi}")
    info = model_info(DetectionModel("yolov5s"), imgsz=IMGSZ, verbose=False)
    print(f"export (g): model_info yolov5s {IMGSZ}px: {info['layers']} layers, "
          f"{info['parameters']} parameters, {info['gflops_per_img']} GFLOPs an image "
          "(convolutions and products, FlopCounterMode)")
    return {"onnx_runtime_ms": rt_ms, "forward_f32_ms": f32_ms, "forward_bf16_ms": bf16_ms,
            "autobatch": bs, "autobatch_step_ms": step_ms, "autobatch_peak_gib": peak / 2 ** 30}


# phase 21: bench.main at its defaults (yolov5s, 640 px, b32, bf16, k 20, the
# card), and ci_smoke at 96 px
BENCH_KW = {}
CI_IMGSZ = 96
# K2 through its wrapper at b32 x 640² bf16 in the earlier runs of phase 6
# (PERF.md §6), which (b) prints beside its own reading
K2_SPREAD_MS = (0.1887, 0.2157)
# the mAP50-95 floor of (c)'s run on phase 11's best.ckpt: random weights
# score 0 on the val set, phase 11's 12 steps score above it (0.00015 to
# 0.0005 in phase 20 (c) and here, PERF.md), so the floor asks each format
# for true positives
HARD_FAIL = 0.0
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extras"}


def bench_trained(dev, data, root):
    """Phase 11's training run alone (yolov5s 640 b32 bf16, device
    augmentation and cache, 3 epochs of 4 steps), for --bench-only: its
    best.ckpt."""
    from yolov5_tpu_torch.train.run import run

    with contextlib.redirect_stdout(io.StringIO()):
        _, _, save_dir = run(data=str(data), cfg="yolov5s", hyp="scratch-low",
                             epochs=TRAIN_EPOCHS, batch_size=BATCH, imgsz=IMGSZ, device_aug=True,
                             cache="device", device=dev, workers=4,
                             project=str(Path(root) / "runs"), name="bench", exist_ok=True)
    return save_dir / "best.ckpt"


def _rows_line(rows):
    return "; ".join(
        f"{r['format']} " + (r["note"] if "note" in r else
                             f"{'ok' if r['ok'] else 'FAILED'} {r['map50_95']:.5f} mAP50-95"
                             if "map50_95" in r else
                             f"{'ok' if r['ok'] else 'FAILED'} {r['ms']:.3f} ms, max diff "
                             f"{r['max_abs_diff']:.3g}, corr {r['corr']:.6f}")
        for r in rows if not r.get("note", "").startswith("unavailable: needs a torch"))


def phase_bench(dev, root, data, weights, trained, smi, stem_ms=None):
    """Phase 21 (a)-(f): ``bench.main`` at its defaults (its line, K1 and K2
    launched), K1 and K2 at the bench's shapes, ``benchmarks`` on the
    calibrated weights and on phase 11's best.ckpt with --data and a
    --hard-fail floor, the pt2 graph with the NMS against the port's NMS,
    and ``ci_smoke`` on the card. Returns the launches of the counted paths
    and the phase's numbers."""
    import torch

    from yolov5_tpu_torch import bench, benchmarks, ci_smoke, infer
    from yolov5_tpu_torch import export as export_mod
    from yolov5_tpu_torch.ops.nms import non_max_suppression
    from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

    t_phase = time.perf_counter()
    torch_tf32_default()
    launches = {}

    def counted(path, fn):
        """fn() with the counters set to 0 just before and read just after;
        what it printed, captured."""
        stem_conv.launches = greedy_nms.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = fn()
        launches[path] = {"greedy_nms": greedy_nms.launches, "stem_conv": stem_conv.launches}
        return res, out.getvalue()

    # (a) the bench's line
    res, out = counted("bench", lambda: bench.main(**BENCH_KW))
    last = out.strip().splitlines()[-1]
    line = json.loads(last)
    ex = line.get("extras", {})
    card = smi.rsplit(",", 1)[0].strip()
    print(f"bench (a): {last}")
    if set(line) != BENCH_KEYS or line != json.loads(json.dumps(res)) \
            or not line["value"] > 0 or ex["device"]["platform"] != "gpu" \
            or ex["device"]["name"] != card or ex["kernels"] != launches["bench"] \
            or min(launches["bench"].values()) < 1:
        raise AssertionError(f"bench (a): line or launches wrong: {launches['bench']} | {last}")
    print(f"bench (a): {line['metric']} {line['value']:.1f} img/s ({ex['device_ms_per_img']:.4f} "
          f"ms/img on the card, MFU {ex['mfu_pct']}%); from numpy "
          f"{ex['with_dispatch_ms_per_img']:.4f} ms/img; serve + NMS "
          f"{ex['serve_e2e_nms_ms_per_img']:.4f} ms/img; NMS {ex['nms_ms_per_img_p50']:.4f}, "
          f"eval cap {ex['nms_eval30k_ms_per_img_p50']:.4f} ms/img; train "
          f"{ex['train_ms_per_img'] * ex['batch']:.3f} ms/step ({ex['train_img_s']:.1f} img/s); "
          f"launches K1 {launches['bench']['greedy_nms']}, K2 {launches['bench']['stem_conv']} "
          f"| {smi}")

    # (b) K2 and K1 at the bench's shapes, beside their plain versions
    with uncounted():
        det = infer.Detector(None, cfg="yolov5s", imgsz=IMGSZ, half=True, device=dev)
        images = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)).to(dev)
        x = images.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
        stem = det.model.model[0]
        w, b = stem.conv.weight, stem.conv.bias
        torch_tf32_off()  # the plain stem as an f32 reference, as phase 3
        got, ref = stem_conv(x, w, b).float(), stem_conv_plain(x, w, b).float()
        k2_err = (got - ref).abs()
        k2_bad = int((k2_err > bf16_ulp(ref) + 1e-5).sum())
        k2_err = k2_err.max().item()
        torch_tf32_default()
        k2 = cuda_ms(lambda: stem_conv(x, w, b), iters=50)
        k2_alone = cuda_ms(stem_kernel_call(x, w, b), iters=50)
        k2_plain = cuda_ms(lambda: stem_conv_plain(x, w, b), iters=50)
        k2_lib = cuda_ms(lambda: torch.nn.functional.silu(torch.nn.functional.conv2d(
            x, w, b, stride=2, padding=2)), iters=50)
        k2_bound, k2_by = stem_bound_ms(x, w.shape[0])
        captured = {}

        def capture(boxes, scores, thres, max_det):
            captured.update(args=(boxes, scores, thres, max_det))
            return greedy_nms(boxes, scores, thres, max_det)

        with routed(nms=capture):
            det(images, conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=2048)
        args = captured["args"]
        k1_equal = torch.equal(greedy_nms(*args), greedy_nms_plain(*args))
        k1 = cuda_ms(lambda: greedy_nms(*args), iters=20)
        k1_plain = cuda_ms(lambda: greedy_nms_plain(*args), iters=2, warmup=1)
        k1_bound, k1_by, n_iou = nms_bound_ms(*args)
    print(f"bench (b): K2 b{BATCH}x{IMGSZ}² bf16 c2={w.shape[0]} (the bench's stem): {k2:.4f} ms "
          f"through its wrapper, {k2_alone:.4f} ms alone; phase 6 "
          f"{'not run' if stem_ms is None else f'{stem_ms:.4f} ms'}; earlier runs "
          f"{K2_SPREAD_MS[0]}-{K2_SPREAD_MS[1]} ms; bound {k2_bound:.4f} ms ({k2_by}); plain "
          f"{k2_plain:.3f} ms; cuDNN bf16 conv + SiLU {k2_lib:.3f} ms; against its plain "
          f"version (f32, TF32 off) max abs err {k2_err:.3g}, {k2_bad} elements over one bf16 "
          f"ulp + 1e-5 | {smi}")
    print(f"bench (b): K1 b{BATCH}x{args[0].shape[1]} IoU 0.45 max_det 300 (the bench's serve "
          f"call): {k1:.4f} ms; bound {k1_bound:.5f} ms ({k1_by}: {n_iou} IoUs); plain "
          f"{k1_plain:.3f} ms; mask {'equal to' if k1_equal else 'DIFFERS from'} its plain "
          f"version's | {smi}")
    if k2_bad or not k1_equal:
        raise AssertionError(f"bench (b): K2 {k2_bad} elements over one ulp, K1 equal "
                             f"{k1_equal}")

    # (c) benchmarks on the calibrated weights, then on phase 11's best.ckpt
    # with the val set and the mAP floor; f32 without TF32, as phase 20: in
    # TF32 the exported graphs' plain stem and K2 round apart, and the
    # calibrated random model amplifies that past the gate's 3 px
    torch_tf32_off()
    out_dir = Path(root) / "benchmarks"
    with contextlib.redirect_stdout(io.StringIO()):
        src = export_mod.run(weights=weights, cfg="yolov5s", imgsz=IMGSZ, include=("ckpt",),
                             output_dir=str(out_dir), name="calibrated", device=dev)["ckpt"]
    rows, _ = counted("benchmarks", lambda: benchmarks.run(
        weights=str(src), cfg="yolov5s", imgsz=IMGSZ, output_dir=str(out_dir / "calibrated"),
        device=dev))
    rows_t, out_t = counted("benchmarks_val", lambda: benchmarks.run(
        weights=str(trained), cfg="yolov5s", imgsz=IMGSZ, data=str(data), hard_fail=HARD_FAIL,
        output_dir=str(out_dir / "trained"), device=dev))
    for what, rs in (("calibrated", rows), ("phase 11's best.ckpt", rows_t)):
        print(f"bench (c): benchmarks {what} {IMGSZ}px f32 (TF32 off): {_rows_line(rs)} | "
              f"{smi}")
    print(f"bench (c): {out_t.strip().splitlines()[-1]}; launches {launches['benchmarks']}, "
          f"with --data {launches['benchmarks_val']}")
    need = {"torch (native)", "ckpt (fused)", "pt2", "onnx (port runtime)"}
    for rs in (rows, rows_t):
        passed = {r["format"] for r in rs if r["ok"]}
        bad = [r["format"] for r in rs if not r["ok"] and "unavailable" not in r.get("note", "")]
        if not need <= passed or bad:
            raise AssertionError(f"bench (c): formats failed {bad}, passed {passed}")
    if launches["benchmarks"]["stem_conv"] < 1 or min(launches["benchmarks_val"].values()) < 1:
        raise AssertionError(f"bench (c): launches {launches}")
    torch_tf32_default()

    # (d) the pt2 graph with the NMS, on the card, against the port's NMS
    # (K1) of the same forward exported without it
    paths, _, batch = smoke_sources(root)
    smoke = torch.from_numpy(batch).to(dev)
    with contextlib.redirect_stdout(io.StringIO()):
        pt2 = {nms: export_mod.run(weights=str(src), imgsz=IMGSZ, batch_size=len(batch),
                                   include=("pt2",), with_nms=nms, output_dir=str(out_dir),
                                   name=f"nms{int(nms)}", device=dev)["pt2"]
               for nms in (True, False)}
    graph = benchmarks.load_pt2(pt2[True], dev)
    got, _ = counted("pt2_nms", lambda: graph(smoke))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph(smoke)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3
    with uncounted():
        ref = non_max_suppression(benchmarks.load_pt2(pt2[False], dev)(smoke),
                                  **export_mod.EXPORT_NMS)

    def rows_of(boxes, scores, classes, valid):
        v = valid.cpu().numpy()
        r = torch.cat([boxes, scores[..., None], classes[..., None].float()], -1).cpu().numpy()
        return [r[i][v[i]] for i in range(len(v))]

    a, b_ = rows_of(*got), rows_of(ref.boxes, ref.scores, ref.classes, ref.valid)
    same = [len(r) for r in a] == [len(r) for r in b_]
    hit, total, score_diff, box_err = match_detections(a, b_, px=1e-3)
    print(f"bench (d): export --include pt2 --nms b{len(batch)} on the card ({len(paths)} smoke "
          f"sources): {total} detections, counts {'equal' if same else 'DIFFER'} to the port's "
          f"non_max_suppression (K1) at conf 0.25, IoU 0.45, max_det 100, cap 1024 on the "
          f"same forward; {hit}/{total} within 1e-3 px (max box {box_err:.3g} px, score "
          f"{score_diff:.3g}); dtypes {[str(t.dtype) for t in got]}; the graph {graph_ms:.1f} "
          f"ms a call; launches K1 {launches['pt2_nms']['greedy_nms']}, K2 "
          f"{launches['pt2_nms']['stem_conv']} | {smi}")
    if not same or hit < total or got[2].dtype != torch.int32 or any(
            launches["pt2_nms"].values()):
        raise AssertionError("bench (d): the pt2 --nms graph differs from the port's NMS")

    # (e) the CI matrix on the card
    t0 = time.perf_counter()
    _, out_ci = counted("ci_smoke", lambda: ci_smoke.main(["--imgsz", str(CI_IMGSZ)]))
    ci_s = time.perf_counter() - t0
    steps = [ln for ln in out_ci.splitlines() if ln.startswith("[")]
    print(f"bench (e): ci_smoke --imgsz {CI_IMGSZ} in {ci_s:.1f} s: {' | '.join(steps)}; "
          f"{out_ci.strip().splitlines()[-1]}; launches {launches['ci_smoke']}")
    if out_ci.strip().splitlines()[-1] != "CI SMOKE PASSED" \
            or min(launches["ci_smoke"].values()) < 1:
        raise AssertionError(f"bench (e): ci_smoke: {out_ci[-2000:]}")

    # (f)
    wall = time.perf_counter() - t_phase
    print(f"bench: phase 21 in {wall:.1f} s")
    counted_paths = ("bench", "benchmarks", "benchmarks_val", "ci_smoke")
    total_launches = {k: sum(launches[p][k] for p in counted_paths)
                      for k in ("greedy_nms", "stem_conv")}
    numbers = {
        "line": line, "benchmarks": rows, "benchmarks_val": rows_t,
        "launches_by_path": launches, "wall_s": wall, "ci_smoke_s": ci_s,
        "pt2_nms_graph_ms": graph_ms,
        "greedy_nms": dict(shape=f"b{BATCH}x{args[0].shape[1]}, IoU 0.45, max_det 300", ms=k1,
                           plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
                           library_ms=None, launches=launches["bench"]["greedy_nms"]),
        "stem_conv": dict(shape=f"b{BATCH}x{IMGSZ}² bf16", ms=k2, alone_ms=k2_alone,
                          plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
                          library_ms=k2_lib, launches=launches["bench"]["stem_conv"]),
    }
    return total_launches, numbers


def torch_tf32_off():
    """F32 convolutions and products in full f32: the plain stem is an f32
    reference."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def profile_line(fn, what, smi, iters=3):
    """torch.profiler over ``iters`` warm calls of fn: device time by
    kernel (the largest eight) and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    parts = "; ".join(f"{e.key[:48]} {e.self_device_time_total / iters / 1e3:.3f} ms "
                      f"x{e.count // iters}" for e in top)
    launches = sum(e.count for e in kernels) // iters
    return (f"profile, {what}, per call: wall {wall_us / iters / 1e3:.3f} ms, device busy "
            f"{busy_us / iters / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), {launches} "
            f"kernel launches; {parts} | {smi}")


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description="Drive the port's paths on one CUDA card.")
    parser.add_argument("--zoo-only", action="store_true",
                        help="phases 1, 2 and 19 alone (on the val and train data that 19 "
                             "needs), and no result lines: a copy of this script in each of "
                             "two checkouts compares their phase 19 readings in one call")
    parser.add_argument("--bench-only", action="store_true",
                        help="phases 1, 2 and 21 alone (on the data, the calibrated weights "
                             "and phase 11's training run that 21 needs), then its numbers as "
                             "one JSON line and no result line")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    _import_port()
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    if opt.zoo_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as root:
            phase_val_data(root)
            phase_zoo(dev, root, phase_train_data(root), smi)
        return 0
    if opt.bench_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as root:
            data = phase_val_data(root)
            trained = bench_trained(dev, phase_train_data(root), root)
            weights = calibrated_weights("yolov5s", 0, smoke_sources(root)[2][:4], dev)
            _, bench_numbers = phase_bench(dev, root, data, weights, trained, smi)
        print(json.dumps({"bench": bench_numbers}))
        return 0
    stem_err = phase_stem(dev)
    nms_err = phase_nms(dev)
    det, batch, launches = phase_slice(dev)
    times = phase_times(dev, det, batch, launches, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_val_") as root:
        data = phase_val_data(root)
        a, val_launches = phase_val(dev, data, smi)
        phase_val_times(dev, data, a, smi)
        train_data = phase_train_data(root)
        train_launches, trained = phase_train(dev, train_data, root, smi)
        phase_train_times(dev, train_data, smi)
        host_data = phase_train_host_data(root)
        host_launches = phase_train_host(dev, host_data, root, smi)
        phase_train_host_times(dev, host_data, smi)
        weights, detect_launches = phase_detect(dev, root, smi)
        serve_launches = phase_serve(dev, root, weights, smi)
        segment_launches = phase_segment(dev, root, smi)
        seg_data = phase_seg_data(root)
        seg_train_launches, seg_run = phase_segment_train(dev, seg_data, root, smi)
        seg_val_launches = phase_segment_val(dev, seg_data, seg_run, smi)
        phase_segment_times(dev, seg_data, smi)
        cls_data = phase_cls_data(root)
        cls_train_launches, cls_run = phase_classify_train(dev, cls_data, root, smi)
        cls_val_launches, _ = phase_classify_val(dev, cls_data, cls_run, smi)
        cls_predict_launches = phase_classify_predict(dev, cls_data, cls_run, root, smi)
        phase_classify_times(dev, smi)
        zoo_launches, zoo_times = phase_zoo(dev, root, train_data, smi)
        export_launches, export_numbers = phase_export(dev, root, data, weights, trained,
                                                       smi)
        bench_launches, bench_numbers = phase_bench(dev, root, data, weights, trained, smi,
                                                    stem_ms=times["stem_conv"]["ms"])
    per_call = launches  # one Detector call of the slice
    launches = {k: n + val_launches[k] + train_launches[k] + host_launches[k]
                + detect_launches[k] + serve_launches[k] + segment_launches[k]
                + seg_train_launches[k] + seg_val_launches[k] + cls_train_launches[k]
                + cls_val_launches[k] + cls_predict_launches[k] + zoo_launches[k]
                + export_launches[k] + bench_launches[k] for k, n in launches.items()}
    kernels = [
        {"name": "greedy_nms", "route": "cuda", "source": "yolov5_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "yolov5_tpu/ops/nms_pallas.py:106", "launches": launches["greedy_nms"],
         "launches_per_call": per_call["greedy_nms"], "max_abs_err": nms_err,
         **times["greedy_nms"], "zoo": zoo_times["greedy_nms"], "export": export_numbers,
         "bench": bench_numbers.pop("greedy_nms")},
        {"name": "stem_conv", "route": "cuda", "source": "yolov5_tpu_torch/csrc/stem_conv.cu",
         "replaces": "yolov5_tpu/ops/stem_pallas.py:180",
         "also_replaces": "yolov5_tpu/ops/stem_pallas.py:151 (K2b, the same function in the "
                          "MXU-transposed layout)", "launches": launches["stem_conv"],
         "launches_per_call": per_call["stem_conv"], "max_abs_err": stem_err,
         **times["stem_conv"], "zoo": zoo_times["stem_conv"],
         "bench": bench_numbers.pop("stem_conv")},
    ]
    print(json.dumps({"kernels": kernels, "bench": bench_numbers}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
