"""The CUDA kernels of yolov5_tpu_torch against their plain PyTorch versions
on the card. These need a CUDA device and nvcc; elsewhere they skip.

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

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


def test_greedy_nms_kernel_rejects_what_it_cannot_take(dev):
    boxes = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(ValueError, match="float32"):
        greedy_nms(boxes.half(), torch.zeros((1, 8), device=dev), 0.45, 10)
    with pytest.raises(ValueError, match="max_det"):
        greedy_nms(boxes, torch.zeros((1, 8), device=dev), 0.45, 5000)


def _write_bmp(path, bgr):
    """A (h, w, 3) uint8 BGR image as an uncompressed 24-bit bottom-up BMP."""
    import struct

    h, w, _ = bgr.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = bgr[::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    path.write_bytes(head + info + rows.tobytes())


def test_evaluate_kernels_equal_plain(dev, tmp_path, monkeypatch):
    """eval.evaluator.evaluate on the card: the same detections and mAP
    with K1/K2 as through their plain versions (yolov5n, 160 px, bf16)."""
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
        _write_bmp(tmp_path / "images" / f"{i}.bmp", im)
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
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(layers_mod, "stem_conv", stem_conv_plain)
            monkeypatch.setattr(nms_mod, "greedy_nms", greedy_nms_plain)
        seen = []
        monkeypatch.setattr(evaluator, "detections_to_numpy",
                            lambda d, seen=seen: seen.append(to_numpy(d)) or seen[-1])
        n = (stem_conv.launches, greedy_nms.launches)
        res = evaluator.evaluate(det.forward, loader, dev)
        launched = (stem_conv.launches - n[0], greedy_nms.launches - n[1])
        assert (min(launched) > 0) != plain
        runs.append((res, seen))
    (a, da), (b, db) = runs
    assert sum(len(r) for batch in da for r in batch) > 0
    for x, y in zip(da, db):
        for p, q in zip(x, y):
            assert np.array_equal(p, q)
    for k in ("mp", "mr", "map50", "map"):
        assert a[k] == b[k]
