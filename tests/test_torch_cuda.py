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
