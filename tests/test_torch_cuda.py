"""The CUDA kernels of yolov5_tpu_torch against their plain PyTorch versions
on the card. These need a CUDA device and nvcc; elsewhere they skip.

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import csv
import json

import numpy as np
import pytest
import torch

from yolov5_tpu_torch.data.imageio import imwrite
from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain

pytestmark = pytest.mark.cuda


def random_sorted_boxes(rng, k, span):
    """k xyxy boxes and descending scores in (0.01, 1), as tests/test_nms.py."""
    xy = rng.uniform(0, span, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    return boxes, np.sort(rng.uniform(0.01, 1.0, k).astype(np.float32))[::-1].copy()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain stem is an f32 reference
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("c2", [16, 32, 48, 64, 80])
@pytest.mark.parametrize("hw", [(64, 96), (160, 32)])
def test_stem_kernel_f32(dev, c2, hw):
    """f32: the tolerance of tests/test_stem_pallas.py (atol 1e-5, rtol 1e-4)."""
    gen = torch.Generator(device=dev).manual_seed(c2)
    x = torch.rand((2, 3, *hw), generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last)
    w = (torch.rand((c2, 3, 6, 6), generator=gen, device=dev) - 0.5) * 0.4
    b = torch.rand((c2,), generator=gen, device=dev) - 0.5
    n = stem_conv.launches
    got = stem_conv(x, w, b)
    assert stem_conv.launches == n + 1
    torch.testing.assert_close(got, stem_conv_plain(x, w, b), atol=1e-5, rtol=1e-4)
    assert got.is_contiguous(memory_format=torch.channels_last)


def test_stem_kernel_bf16(dev):
    """bf16: within one bf16 ulp of the f32-accumulated plain version."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((2, 3, 128, 64), generator=gen, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.rand((32, 3, 6, 6), generator=gen, device=dev) - 0.5) * 0.4
    b = torch.rand((32,), generator=gen, device=dev) - 0.5
    got, ref = stem_conv(x, w, b).float(), stem_conv_plain(x, w, b).float()
    _, e = torch.frexp(ref.abs().clamp(min=2.0 ** -126))
    assert ((got - ref).abs() <= torch.ldexp(torch.ones_like(ref), e - 8) + 1e-5).all()


def _bf16_ulp(ref):
    _, e = torch.frexp(ref.abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(ref), e - 8)


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c2", [16, 32, 48, 64, 80])
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 2, 258), (3, 36, 142), (2, 130, 6)])
def test_stem_kernel_edges(dev, shape, c2, xdt, wdt):
    """B = 1, H = 2, and output widths that are not a multiple of the
    kernel's 64-pixel tile (1, 129, 71, 3), for every c2, f32 and bf16
    inputs and weights: f32 within atol 1e-5, rtol 1e-4; bf16 within one
    ulp of the f32-accumulated plain version."""
    B, H, W = shape
    gen = torch.Generator(device=dev).manual_seed(B * H * W + c2)
    x = torch.rand((B, 3, H, W), generator=gen, device=dev).to(xdt).contiguous(
        memory_format=torch.channels_last)
    w = ((torch.rand((c2, 3, 6, 6), generator=gen, device=dev) - 0.5) * 0.4).to(wdt)
    b = (torch.rand((c2,), generator=gen, device=dev) - 0.5).to(wdt)
    got, ref = stem_conv(x, w, b), stem_conv_plain(x, w, b)
    assert got.dtype == xdt and got.is_contiguous(memory_format=torch.channels_last)
    got, ref = got.float(), ref.float()
    if xdt == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-4)
    else:
        assert ((got - ref).abs() <= _bf16_ulp(ref) + 1e-5).all()


def test_stem_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros((1, 3, 64, 64), device=dev)  # NCHW, not channels_last
    w, b = torch.zeros((32, 3, 6, 6), device=dev), torch.zeros((32,), device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        stem_conv(x, w, b)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="c2 in"):
        stem_conv(x, torch.zeros((24, 3, 6, 6), device=dev), torch.zeros((24,), device=dev))


@pytest.mark.parametrize("k", [300, 2048, 5000])
@pytest.mark.parametrize("max_det", [1, 300, 1000])
@pytest.mark.parametrize("thres", [0.45, 0.6])
def test_greedy_nms_kernel_equals_plain(dev, k, max_det, thres):
    rng = np.random.default_rng(k + max_det)
    pairs = [random_sorted_boxes(rng, k, span=400.0) for _ in range(3)]
    boxes = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    scores = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    scores[:, int(0.9 * k):] = 0.0
    n = greedy_nms.launches
    got = greedy_nms(boxes, scores, thres, max_det)
    assert greedy_nms.launches == n + 1
    assert torch.equal(got, greedy_nms_plain(boxes, scores, thres, max_det))


def test_greedy_nms_kernel_threshold_ties(dev):
    """An IoU exactly at the threshold keeps both boxes (strict >), one ulp
    below suppresses: the kernel rounds every IoU step as the plain version."""
    boxes = torch.tensor([[[200, 0, 210, 10], [205, 0, 215, 10]]], dtype=torch.float32,
                         device=dev)
    scores = torch.tensor([[0.3, 0.3]], device=dev)
    f = np.float32
    tie = f(50) / (f(f(100) + f(100)) - f(50) + f(1e-7))
    for thres, want in ((float(tie), [True, True]),
                        (float(np.nextafter(tie, f(0))), [True, False])):
        got = greedy_nms(boxes, scores, thres, 10)
        assert got[0].tolist() == want
        assert torch.equal(got, greedy_nms_plain(boxes, scores, thres, 10))


def _edge_candidates(rng, k, span, pad_from=None):
    boxes, scores = random_sorted_boxes(rng, k, span)
    if pad_from is not None:
        scores[pad_from:] = 0.0
    return boxes, scores


@pytest.mark.parametrize("k", [1, 63, 64, 65, 255, 256, 257, 511, 512, 513, 1023, 1025, 2049])
def test_greedy_nms_kernel_chunk_edges(dev, k):
    """K on both sides of the kernel's 512-candidate chunks (and of 32-bit
    words), with and without class offsets."""
    rng = np.random.default_rng(k)
    pairs = [_edge_candidates(rng, k, 30.0 * np.sqrt(k) + 60, int(0.95 * k)) for _ in range(4)]
    boxes = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    scores = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    offset = torch.from_numpy(rng.integers(0, 3, (4, k, 1)).astype(np.float32) * 7680).to(dev)
    for bx in (boxes, (boxes + offset).contiguous()):
        assert torch.equal(greedy_nms(bx, scores, 0.45, 4096),
                           greedy_nms_plain(bx, scores, 0.45, 4096))


@pytest.mark.parametrize("max_det", [1, 37, 300, 513, 700])
def test_greedy_nms_kernel_max_det_mid_chunk(dev, max_det):
    rng = np.random.default_rng(max_det)
    pairs = [_edge_candidates(rng, 3000, 1500.0) for _ in range(3)]
    boxes = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    scores = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    got = greedy_nms(boxes, scores, 0.5, max_det)
    assert torch.equal(got, greedy_nms_plain(boxes, scores, 0.5, max_det))
    assert (got.sum(1) == max_det).all()


@pytest.mark.parametrize("pad_from", [0, 1, 40, 511, 512, 700])
def test_greedy_nms_kernel_stops_at_the_first_padding_score(dev, pad_from):
    """A score <= 0 inside a chunk ends the walk, even where later scores are
    positive again."""
    rng = np.random.default_rng(pad_from)
    boxes, scores = _edge_candidates(rng, 1200, 1500.0, pad_from)
    scores[pad_from + 5:] = 0.5
    boxes, scores = torch.from_numpy(boxes)[None].to(dev), torch.from_numpy(scores)[None].to(dev)
    got = greedy_nms(boxes, scores, 0.45, 1000)
    assert torch.equal(got, greedy_nms_plain(boxes, scores, 0.45, 1000))
    assert not got[0, pad_from:].any()


@pytest.mark.parametrize("thres", [-0.5, 0.0, 0.45])
def test_greedy_nms_kernel_identical_boxes_and_negative_thresholds(dev, thres):
    """All boxes identical: one keep. Apart boxes at thres < 0 suppress each
    other (IoU 0 > thres), so the kernel's early reject must stay off there."""
    same = torch.tensor([[10.0, 20.0, 50.0, 80.0]], device=dev).repeat(1500, 1)[None]
    scores = torch.linspace(1.0, 0.1, 1500, device=dev)[None]
    got = greedy_nms(same.contiguous(), scores, thres, 1000)
    assert torch.equal(got, greedy_nms_plain(same, scores, thres, 1000))
    assert got.sum() == 1
    rng = np.random.default_rng(7)
    boxes, sc = _edge_candidates(rng, 900, 3000.0)
    boxes, sc = torch.from_numpy(boxes)[None].to(dev), torch.from_numpy(sc)[None].to(dev)
    got = greedy_nms(boxes, sc, thres, 1000)
    assert torch.equal(got, greedy_nms_plain(boxes, sc, thres, 1000))
    assert (got.sum() == 1) == (thres < 0)


def test_greedy_nms_kernel_threshold_tie_across_a_chunk(dev):
    """The tied pair of test_greedy_nms_kernel_threshold_ties as candidates
    511 and 512, so the later one meets the earlier through the kept list."""
    far = torch.tensor([[1000.0 * i, 5000.0, 1000.0 * i + 3, 5003.0] for i in range(511)])
    pair = torch.tensor([[200.0, 0.0, 210.0, 10.0], [205.0, 0.0, 215.0, 10.0]])
    boxes = torch.cat([far, pair])[None].to(dev)
    scores = torch.linspace(1.0, 0.5, 513, device=dev)[None]
    f = np.float32
    tie = f(50) / (f(f(100) + f(100)) - f(50) + f(1e-7))
    for thres, kept in ((float(tie), True), (float(np.nextafter(tie, f(0))), False)):
        got = greedy_nms(boxes, scores, thres, 1000)
        assert torch.equal(got, greedy_nms_plain(boxes, scores, thres, 1000))
        assert bool(got[0, 512]) == kept


def test_greedy_nms_kernel_rejects_what_it_cannot_take(dev):
    boxes = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(ValueError, match="float32"):
        greedy_nms(boxes.half(), torch.zeros((1, 8), device=dev), 0.45, 10)
    with pytest.raises(ValueError, match="max_det"):
        greedy_nms(boxes, torch.zeros((1, 8), device=dev), 0.45, 5000)


def test_evaluate_kernels_equal_plain(dev, tmp_path, monkeypatch):
    """eval.evaluator.evaluate on the card (yolov5n, 160 px, bf16): the same
    detections and mAP with the kernels as through K1's plain version; and
    through both plain versions, equal counts per image and >= 99% of the
    detections matched (same class, box within 1 px). K2 sums on the tensor
    cores in another order than the plain f32 convolution, so a bf16 score
    may move by one ulp and the fully plain run is compared as a set."""
    from chip_smoke import match_detections

    import yolov5_tpu_torch.models.layers as layers_mod
    import yolov5_tpu_torch.ops.nms as nms_mod
    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.eval import evaluator
    from yolov5_tpu_torch.infer import Detector
    from yolov5_tpu_torch.models.yolo import DetectionModel

    rng = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i, (h, w) in enumerate([(120, 160), (160, 120), (160, 160), (90, 160)] * 2):
        im = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        im[h // 4:h // 2, w // 4:w // 2] = 200
        imwrite(tmp_path / "images" / f"{i}.bmp", im)
        (tmp_path / "labels" / f"{i}.txt").write_text("0 0.375 0.375 0.25 0.25\n")
    sd = DetectionModel("yolov5n").state_dict()
    gen = torch.Generator().manual_seed(0)
    for k, v in sd.items():  # random BN statistics, Detect biases near 0
        if k.endswith("bn.weight") or k.endswith("running_var"):
            v.uniform_(0.5, 1.5, generator=gen)
        elif k.endswith("running_mean"):
            v.normal_(0.0, 0.2, generator=gen)
        elif k.startswith("model.24.m.") and k.endswith("bias"):
            v.normal_(-1.0, 0.5, generator=gen)
    det = Detector(sd, cfg="yolov5n", imgsz=160, half=True, device=dev)
    _, loader = create_loader(str(tmp_path / "images"), img_size=160, batch_size=4,
                              rect=True, stride=32)
    runs = []
    to_numpy = evaluator.detections_to_numpy
    for plain in ((), ("nms",), ("nms", "stem")):
        if "nms" in plain:
            monkeypatch.setattr(nms_mod, "greedy_nms", greedy_nms_plain)
        if "stem" in plain:
            monkeypatch.setattr(layers_mod, "stem_conv", stem_conv_plain)
        seen = []
        monkeypatch.setattr(evaluator, "detections_to_numpy",
                            lambda d, seen=seen: seen.append(to_numpy(d)) or seen[-1])
        n = (stem_conv.launches, greedy_nms.launches)
        res = evaluator.evaluate(det.forward, loader, dev)
        launched = (stem_conv.launches - n[0], greedy_nms.launches - n[1])
        assert (launched[0] > 0, launched[1] > 0) == ("stem" not in plain, "nms" not in plain)
        runs.append((res, [r for batch in seen for r in batch]))
    (a, da), (b, db), (_, dp) = runs
    assert sum(len(r) for r in da) > 0
    assert len(da) == len(db) and all(np.array_equal(p, q) for p, q in zip(da, db))
    for k in ("mp", "mr", "map50", "map"):
        assert a[k] == b[k]
    assert [len(r) for r in da] == [len(r) for r in dp]
    hit, total, _, _ = match_detections(da, dp)
    assert hit >= 0.99 * total, (hit, total)


def test_device_augmentation_cuda_equals_cpu(dev):
    """The augmentation cores on the card against the CPU on equal draws:
    HSV exact, warps within 1 level, labels within 1e-4, keep masks equal."""
    from yolov5_tpu_torch.data import device_aug as aug

    rng = np.random.default_rng(1)
    ims = torch.from_numpy(rng.integers(0, 256, (4, 96, 128, 3), dtype=np.uint8))
    r = torch.from_numpy((rng.uniform(-1, 1, (4, 3)) * [0.015, 0.7, 0.4] + 1).astype(np.float32))
    assert torch.equal(aug.hsv_jitter_lut(ims.to(dev), r.to(dev)).cpu(),
                       aug.hsv_jitter_lut(ims, r))

    draws = aug.draw_affine(torch.Generator().manual_seed(2), 4, 10.0, 0.1, 0.5, 3.0, 5e-4,
                            "cpu")
    M, s = aug.affine_from_draws(draws, 96, 128, 64, 64)
    t = torch.from_numpy(np.concatenate([rng.integers(0, 3, (4, 5, 1)),
                                         rng.uniform(0.2, 0.8, (4, 5, 2)),
                                         rng.uniform(0.05, 0.4, (4, 5, 2))], -1)
                         .astype(np.float32))
    v = torch.ones((4, 5), dtype=torch.bool)
    cpu = aug.warp_perspective(ims, t, v, M, s, (64, 64))
    gpu = [x.cpu() for x in aug.warp_perspective(ims.to(dev), t.to(dev), v.to(dev), M.to(dev),
                                                 s.to(dev), (64, 64))]
    assert (gpu[0].int() - cpu[0].int()).abs().max() <= 1
    torch.testing.assert_close(gpu[1], cpu[1], atol=1e-4, rtol=0)
    assert torch.equal(gpu[2], cpu[2])

    pool = torch.from_numpy(rng.integers(0, 256, (6, 64, 64, 3), dtype=np.uint8))
    idx = torch.tensor([[0, 1, 2, 3], [4, 5, 0, 1]])
    hw4 = torch.tensor([[[48, 64], [64, 40], [64, 64], [32, 64]]] * 2, dtype=torch.float32)
    t4 = t[:2, None, :4].expand(2, 4, 4, 5).contiguous()
    v4 = torch.ones((2, 4, 4), dtype=torch.bool)
    xc, yc = torch.tensor([60.0, 70.0]), torch.tensor([66.0, 50.0])
    Mm, sm = aug.affine_from_draws({k: x[:2] for k, x in draws.items()}, 128, 128, 64, 64)
    args = (pool, t4, v4, idx, hw4, xc, yc, Mm, sm)
    cpu = aug.mosaic_warp(*args)
    gpu = [x.cpu() for x in aug.mosaic_warp(*(a.to(dev) for a in args))]
    assert (gpu[0].int() - cpu[0].int()).abs().max() <= 1
    torch.testing.assert_close(gpu[1], cpu[1], atol=1e-4, rtol=0)
    assert torch.equal(gpu[2], cpu[2])


def _shapes_set(root, n_train=8, n_val=4, s=160):
    """A BMP train/val set of bright rectangles on dark noise, and its YAML."""
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            h, w = ((120, 160), (160, 120), (160, 160), (90, 160))[i % 4]
            im = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
            im[h // 4:h // 2, w // 4:w // 2] = 200
            imwrite(root / "images" / split / f"{i}.bmp", im)
            (root / "labels" / split / f"{i}.txt").write_text("0 0.375 0.375 0.25 0.25\n")
    data = root / "shapes.yaml"
    data.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnc: 2\n"
                    "names: [a, b]\n")
    return data


def test_bf16_train_step_on_cuda(dev, tmp_path):
    """One train step of yolov5n at 160 px, b4, bf16 autocast, device
    augmentation from the device cache: finite loss and gradient norm,
    float32 master weights that moved, an EMA tick."""
    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.data.device_cache import build_cache_arrays, to_device
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.loss import ComputeLoss
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
    from yolov5_tpu_torch.utils.hyp import SCRATCH_LOW

    data = _shapes_set(tmp_path)
    ds, loader = create_loader(str(data.parent / "images" / "train"), img_size=160,
                               batch_size=4, augment=True, device_aug=True)
    cache = to_device(build_cache_arrays(ds, loader.max_labels), dev)
    model = DetectionModel("yolov5n", nc=2).to(dev).to(memory_format=torch.channels_last)
    hyp = scale_hyp(SCRATCH_LOW, nl=3, nc=2, imgsz=160)
    opt = Optimizer(dict(model.named_parameters()), hyp, 3, 2, 64)
    state = init_train_state(model, opt)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(ComputeLoss(model.anchors_per_stride, 2, hyp), SCRATCH_LOW,
                           dtype=torch.bfloat16)
    state, metrics = step(state, {"idx": torch.tensor([0, 3, 5, 7], device=dev)}, cache)
    for k, v in metrics.items():
        assert torch.isfinite(v).item(), k
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(before[k], v) for k, v in model.named_parameters())
    assert state.ema.updates == 1 and state.step == 1


def test_host_batches_through_the_prefetcher_on_cuda(dev, tmp_path):
    """Host-augmented batches from two worker processes, copied by the
    prefetcher (pinned memory, side stream): on the card they equal the
    host's arrays, and a bf16 train step on them is finite."""
    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.loss import ComputeLoss
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.prefetch import prefetch
    from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
    from yolov5_tpu_torch.utils.hyp import SCRATCH_LOW

    data = _shapes_set(tmp_path)
    kw = dict(img_size=160, batch_size=4, augment=True, hyp=SCRATCH_LOW, cache=False)
    _, pooled = create_loader(str(data.parent / "images" / "train"), workers=2, **kw)
    _, inline = create_loader(str(data.parent / "images" / "train"), workers=1, **kw)
    model = DetectionModel("yolov5n", nc=2).to(dev).to(memory_format=torch.channels_last)
    hyp = scale_hyp(SCRATCH_LOW, nl=3, nc=2, imgsz=160)
    state = init_train_state(model, Optimizer(dict(model.named_parameters()), hyp, 3, 2, 64))
    step = make_train_step(ComputeLoss(model.anchors_per_stride, 2, hyp), None,
                           dtype=torch.bfloat16)
    keys = ("images", "targets", "valid")
    try:
        fed = prefetch(iter(pooled), dev, transform=lambda b: {k: b[k] for k in keys})
        for got, ref in zip(fed, inline):
            assert all(got[k].device.type == "cuda" for k in keys)
            for k in keys:
                np.testing.assert_array_equal(got[k].cpu().numpy(), ref[k])
            state, metrics = step(state, got)
            assert all(torch.isfinite(v).item() for v in metrics.values())
    finally:
        pooled.close()
    assert state.step == len(inline) == 2


def test_train_run_validates_with_the_kernels(dev, tmp_path):
    """train.run on the card: every epoch's EMA validation launches K2 and K1,
    and best.ckpt re-validates to the same metrics."""
    from yolov5_tpu_torch.eval import evaluator
    from yolov5_tpu_torch.train.run import run
    from yolov5_tpu_torch.utils.callbacks import Callbacks

    data = _shapes_set(tmp_path)
    counts = []
    cb = Callbacks()
    cb.register_action("on_train_epoch_end",
                       callback=lambda epoch: counts.append((stem_conv.launches,
                                                             greedy_nms.launches)))
    cb.register_action("on_fit_epoch_end", callback=lambda epoch, fitness: counts.append(
        (stem_conv.launches, greedy_nms.launches)))
    _, res, save_dir = run(str(data), cfg="yolov5n", epochs=2, batch_size=4, imgsz=160,
                           device_aug=True, device=dev, project=str(tmp_path / "runs"),
                           name="r", callbacks=cb, workers=1)
    for (s0, n0), (s1, n1) in zip(counts[0::2], counts[1::2]):
        assert s1 > s0 and n1 > n0
    again = evaluator.run(str(data), weights=str(save_dir / "best.ckpt"), imgsz=160,
                          batch_size=4, half=True, rect=False, device=dev, verbose=False)
    with open(save_dir / "results.csv") as f:
        rows = list(csv.DictReader(f))
    best_epoch = json.loads((save_dir / "best.ckpt.json").read_text())["epoch"]
    for k in ("mp", "mr", "map50", "map"):
        assert abs(again[k] - float(rows[best_epoch][f"val/{k}"])) <= 1e-6, k


def test_segment_forward_through_k2(dev, monkeypatch):
    """yolov5s-seg (BN folded, f32) at 320 px on the card: its stem (c2 = 32)
    runs K2, and the maps and prototypes agree with the run through K2's
    plain version within 1e-3 of each tensor's largest value (K2 sums in
    another order than the f32 convolution)."""
    import yolov5_tpu_torch.models.layers as layers_mod
    from yolov5_tpu_torch.infer_segment import Segmenter

    seg = Segmenter(None, cfg="yolov5s-seg", device=dev)
    assert seg.model.model[0].stem and seg.model.model[0].conv.weight.shape[0] == 32
    ims = np.random.default_rng(0).integers(0, 256, (2, 320, 320, 3), dtype=np.uint8)
    n = stem_conv.launches
    preds, proto = seg.forward(ims)
    assert stem_conv.launches == n + 1
    monkeypatch.setattr(layers_mod, "stem_conv", stem_conv_plain)
    ref_preds, ref_proto = seg.forward(ims)
    for got, ref in ((preds, ref_preds), (proto, ref_proto)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1e-3 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("iou", [0.45, 0.6])
def test_greedy_nms_kernel_at_the_segment_shape(dev, monkeypatch, iou):
    """K1 at b1 x 25 200 candidates carrying 32 mask coefficients (segment
    predict at 640 px): the NMS tail with K1 equals its run through K1's
    plain version, coefficient columns included."""
    import yolov5_tpu_torch.ops.nms as nms_mod

    gen = torch.Generator(device=dev).manual_seed(5)
    n, nc, nm = 25200, 80, 32
    xy = torch.rand((1, n, 2), generator=gen, device=dev) * 640
    wh = 4 + torch.rand((1, n, 2), generator=gen, device=dev) * 120
    scores = torch.rand((1, n, 1 + nc), generator=gen, device=dev) ** 3
    coeffs = torch.randn((1, n, nm), generator=gen, device=dev)
    preds = torch.cat([xy, wh, scores, coeffs], -1)
    n0 = greedy_nms.launches
    got = nms_mod.non_max_suppression(preds, conf_thres=0.25, iou_thres=iou, max_det=300, nc=nc)
    assert greedy_nms.launches == n0 + 1
    monkeypatch.setattr(nms_mod, "greedy_nms", greedy_nms_plain)
    ref = nms_mod.non_max_suppression(preds, conf_thres=0.25, iou_thres=iou, max_det=300, nc=nc)
    assert int(got.valid.sum()) > 0 and got.masks.shape == (1, 300, nm)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_detect_run_on_the_card(dev, tmp_path, monkeypatch):
    """infer.run on the card (yolov5n, 160 px, b4, BMP in and out): both
    kernels launch, and the txt rows equal Detector.__call__'s on the same
    letterboxed batch with the boxes scaled back."""
    from pathlib import Path

    from yolov5_tpu_torch.data.imageio import imread
    from yolov5_tpu_torch.data.letterbox import letterbox, scale_boxes_np
    from yolov5_tpu_torch.infer import Detector, run
    from yolov5_tpu_torch.ops.nms import detections_to_numpy

    rng = np.random.default_rng(1)
    src = tmp_path / "src"
    src.mkdir()
    shapes = [(120, 160), (160, 120), (160, 160), (90, 160)]
    for i, (h, w) in enumerate(shapes):
        imwrite(src / f"{i}.bmp", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    n = (stem_conv.launches, greedy_nms.launches)
    results, save_dir = run(weights=None, cfg="yolov5n", source=str(src), imgsz=160,
                            conf_thres=0.001, batch_size=4, save_txt=True, device=dev,
                            project=str(tmp_path), name="r", verbose=False)
    assert stem_conv.launches > n[0] and greedy_nms.launches > n[1]
    det = Detector(None, cfg="yolov5n", imgsz=160, device=dev)
    im0s = [imread(src / f"{i}.bmp") for i in range(4)]
    batch = np.stack([letterbox(im, 160)[0][..., ::-1] for im in im0s])
    rows = detections_to_numpy(det(batch, conf_thres=0.001))
    for (path, r), want, im0 in zip(results, rows, im0s):
        want[:, :4] = scale_boxes_np((160, 160), want[:, :4], im0.shape[:2])
        np.testing.assert_array_equal(r, want)
        assert imread(save_dir / Path(path).name).shape == im0.shape


# ---------------------------------------------------------------------------
# segmentation training and validation
# ---------------------------------------------------------------------------

def _star_polygons(rng, shape, v, span):
    c = rng.uniform(-0.1 * span, 1.1 * span, shape + (1, 2))
    r = rng.uniform(2, 0.4 * span, shape + (1, 1))
    ang = np.sort(rng.uniform(0, 2 * np.pi, shape + (v,)), -1)
    rad = r[..., 0] * rng.uniform(0.4, 1.0, shape + (v,))
    p = np.stack([c[..., 0] + rad * np.cos(ang), c[..., 1] + rad * np.sin(ang)], -1)
    return np.floor(p).astype(np.float32)


@pytest.mark.parametrize("overlap", [True, False])
def test_rasterize_cuda_equals_cpu(dev, overlap):
    """The rasterizer's searchsorted, uint8 scatter-add and cumulative sum
    on the card: the CPU's pixels, at the training path's shape."""
    from yolov5_tpu_torch.ops.rasterize import rasterize, rasterize_overlap

    rng = np.random.default_rng(1)
    poly = torch.from_numpy(_star_polygons(rng, (4, 64), 32, 160))
    nv = torch.from_numpy(np.where(rng.random((4, 64)) < 0.5, 32, 0))
    fn = rasterize_overlap if overlap else rasterize
    got = fn(poly.to(dev), nv.to(dev), 160, 160).cpu()
    assert torch.equal(got, fn(poly, nv, 160, 160))
    assert got.any()


def test_segment_loss_cuda_matches_cpu(dev):
    """ComputeSegmentLoss on the card against the CPU on the same inputs,
    within 1e-5 relative (f32 products on the card, TF32 off)."""
    from yolov5_tpu_torch.train.loss import ComputeSegmentLoss

    g = torch.Generator().manual_seed(2)
    maps = [torch.randn((2, n, n, 3, 40), generator=g) for n in (16, 8, 4)]
    proto = torch.randn((2, 32, 32, 32), generator=g)
    t = torch.rand((2, 6, 5), generator=g) * 0.5 + 0.2
    t[..., 0] = torch.randint(0, 3, (2, 6), generator=g).float()
    valid = torch.rand((2, 6), generator=g) < 0.8
    masks = torch.randint(0, 7, (2, 32, 32), generator=g, dtype=torch.int32)
    anchors = (((1.25, 1.625), (2.0, 3.75), (4.125, 2.875)),) * 3
    fn = ComputeSegmentLoss(anchors, 3, {"box": 0.05, "obj": 1.0, "cls": 0.5}, seg_k=9)
    ref_total, ref = fn((maps, proto), t, valid, masks)
    total, got = fn(([m.to(dev) for m in maps], proto.to(dev)), t.to(dev), valid.to(dev),
                    masks.to(dev))
    torch.testing.assert_close(total.cpu(), ref_total, rtol=1e-5, atol=0)
    for k in ref:
        torch.testing.assert_close(got[k].cpu(), ref[k], rtol=1e-5, atol=0)
    assert ref["seg_overflow"] > 0


def test_segment_train_and_val_on_the_card(dev, tmp_path, monkeypatch):
    """``segment train`` with --device-aug (yolov5n-seg, 128 px, bf16) then
    ``segment val`` on best.ckpt: K1 and K2 in both, finite losses, and val
    reproducing the epoch's EMA validation; in f32 the validation through
    K1's plain version gives the same metrics."""
    from yolov5_tpu_torch.infer_segment import Segmenter
    from yolov5_tpu_torch.data.cv import fill_poly
    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.ops import nms as nms_mod
    from yolov5_tpu_torch.segment import main
    from yolov5_tpu_torch.train.run_segment import evaluate_segment

    rng = np.random.default_rng(3)
    for split, n in (("train", 8), ("val", 4)):
        (tmp_path / "images" / split).mkdir(parents=True)
        (tmp_path / "labels" / split).mkdir(parents=True)
        for i in range(n):
            im = rng.integers(0, 80, (96, 128, 3)).astype(np.uint8)
            rows = []
            for _ in range(2):
                c = rng.uniform([20, 20], [108, 76])
                ang = np.arange(7) * 2 * np.pi / 7
                poly = np.stack([c[0] + 15 * np.cos(ang), c[1] + 12 * np.sin(ang)], 1)
                fill_poly(im, np.round(poly).astype(np.int32), (200, 60, 40))
                rows.append("0 " + " ".join(f"{x / 128:.6f} {y / 96:.6f}" for x, y in poly))
            imwrite(tmp_path / "images" / split / f"{i:03d}.bmp", im)
            (tmp_path / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    data = tmp_path / "seg.yaml"
    data.write_text(f"path: {tmp_path}\ntrain: images/train\nval: images/val\nnc: 1\n"
                    "names: [blob]\n")
    n_stem, n_nms = stem_conv.launches, greedy_nms.launches
    tr = main(["train", "--data", str(data), "--cfg", "yolov5n-seg", "--imgsz", "128",
               "--batch-size", "4", "--epochs", "1", "--device-aug", "--workers", "1",
               "--project", str(tmp_path / "runs"), "--name", "a"])
    assert stem_conv.launches > n_stem and greedy_nms.launches > n_nms
    with open(f"{tr['save_dir']}/results.csv") as f:
        row = list(csv.DictReader(f))[0]
    assert all(np.isfinite(float(row[f"train/{k}"])) for k in ("box", "obj", "cls", "seg"))
    best = f"{tr['save_dir']}/best.ckpt"
    va = main(["val", "--data", str(data), "--weights", best, "--imgsz", "128", "--half",
               "--batch-size", "4", "--workers", "1"])
    for part in ("box", "mask"):
        assert abs(va[part]["map"] - float(row[f"val/{part}_map"])) <= 1e-6
    seg = Segmenter(best, device=dev)
    _, loader = create_loader(str(tmp_path / "images" / "val"), img_size=128, batch_size=4,
                              workers=1, masks=True)
    a = evaluate_segment(seg.forward, loader, dev, seg.nc)
    monkeypatch.setattr(nms_mod, "greedy_nms", greedy_nms_plain)
    b = evaluate_segment(seg.forward, loader, dev, seg.nc)
    assert {k: a[k] for k in ("box", "mask")} == {k: b[k] for k in ("box", "mask")}


@pytest.mark.parametrize("shape", [(64, 224, 224), (1, 224, 192), (1, 160, 224)])
def test_stem_kernel_at_the_classify_shapes(dev, shape):
    """yolov5s-cls's stem (c2 = 32) in f32: b64 at 224² (classify val and
    the EMA validation) and b1 at letterboxed shapes, within the f32
    tolerance (atol 1e-5, rtol 1e-4)."""
    gen = torch.Generator(device=dev).manual_seed(shape[1])
    x = torch.rand((shape[0], 3, *shape[1:]), generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last)
    w = (torch.rand((32, 3, 6, 6), generator=gen, device=dev) - 0.5) * 0.4
    b = torch.rand((32,), generator=gen, device=dev) - 0.5
    n = stem_conv.launches
    got = stem_conv(x, w, b)
    assert stem_conv.launches == n + 1
    torch.testing.assert_close(got, stem_conv_plain(x, w, b), atol=1e-5, rtol=1e-4)


def test_validate_classify_through_k2(dev, tmp_path, monkeypatch):
    """validate_classify of a yolov5s classifier (BN folded, f32, 224 px)
    on a few BMPs: its stem runs K2 once a batch, and against the run
    through K2's plain version the logits agree within 1e-3 of each row's
    largest and the metrics are equal."""
    import yolov5_tpu_torch.models.layers as layers_mod
    from yolov5_tpu_torch.train import run_classify
    from yolov5_tpu_torch.utils.checkpoint import save_checkpoint
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.trainer import init_train_state
    from yolov5_tpu_torch.models.yolo import ClassificationModel

    rng = np.random.default_rng(0)
    for c in range(3):
        (tmp_path / "val" / f"c{c}").mkdir(parents=True)
        for i in range(4):
            im = rng.integers(0, 256, (256, 288, 3)).astype(np.uint8)
            im[..., c] = 230
            imwrite(tmp_path / "val" / f"c{c}" / f"{i}.bmp", im)
    model = ClassificationModel("yolov5s", nc=3).to(dev)
    model.names = {0: "c0", 1: "c1", 2: "c2"}
    state = init_train_state(model, Optimizer(dict(model.named_parameters()), {}, 1, 1, 64))
    ckpt = tmp_path / "best.ckpt"
    save_checkpoint(ckpt, state, 0, 0.0, extra={"imgsz": 224})
    logits = []
    saved = run_classify.classify_logits

    def capture(m, images):
        logits.append(saved(m, images))
        return logits[-1]

    monkeypatch.setattr(run_classify, "classify_logits", capture)
    n = stem_conv.launches
    a = run_classify.validate_classify(str(ckpt), str(tmp_path), batch_size=8, device=dev)
    assert stem_conv.launches == n + 2
    monkeypatch.setattr(layers_mod, "stem_conv", stem_conv_plain)
    b = run_classify.validate_classify(str(ckpt), str(tmp_path), batch_size=8, device=dev)
    for got, ref in zip(logits[:2], logits[2:]):
        err = (got - ref).abs().max(1).values
        assert (err <= 1e-3 * ref.abs().max(1).values).all(), err
    assert (a["top1"], a["top5"], a["per_class"]) == (b["top1"], b["top5"], b["per_class"])


def test_bench_on_the_card(dev, capsys):
    """bench.main at yolov5n 64 px on the card: its last line names the card
    (nvidia-smi's name and power limit), a positive rate, and both kernels
    launched."""
    from yolov5_tpu_torch import bench

    res = bench.main(cfg="yolov5n", imgsz=64, batch=2, k=2, dtype="bfloat16")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert line["metric"] == "yolov5n_64_bf16_images_per_sec_per_chip_b2" and line["value"] > 0
    ex = line["extras"]
    assert ex["device"]["platform"] == "gpu" and ex["device"]["power_limit_w"] > 0
    assert ex["device"]["count"] == torch.cuda.device_count()
    assert (ex["mfu_pct"] is not None) == ("H100" in ex["device"]["name"])
    assert ex["kernels"]["greedy_nms"] > 0 and ex["kernels"]["stem_conv"] > 0
