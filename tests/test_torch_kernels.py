"""The plain versions of kernels K1 (greedy NMS) and K2 (fused stem) against
the JAX package's Pallas kernels (interpret mode) and jnp references, on the
CPU. The CUDA kernels themselves are held against these plain versions in
tests/test_torch_cuda.py, which needs a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import random_sorted_boxes, truncate_after
from yolov5_tpu.models import layers as JL
from yolov5_tpu.ops.nms import _greedy_nms_tiled
from yolov5_tpu.ops.nms_pallas import greedy_nms_pallas
from yolov5_tpu.ops.stem_pallas import stem_conv_mxuT
from yolov5_tpu_torch.models import layers as L
from yolov5_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
from yolov5_tpu_torch.ops.stem import stem_conv, stem_conv_plain


def _stem_inputs(rng, shape, c2):
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.uniform(-0.2, 0.2, (6, 6, 3, c2)).astype(np.float32)  # HWIO
    b = rng.uniform(-0.5, 0.5, (c2,)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()  # OIHW
    return x, w, b, xt, wt, torch.from_numpy(b)


def test_stem_plain_matches_pallas_mxuT(rng):
    """The TPU kernel's own contract at its only shape: tolerance of
    tests/test_stem_pallas.py (f32, atol 1e-5, rtol 1e-4)."""
    x, w, b, xt, wt, bt = _stem_inputs(rng, (1, 640, 640, 3), 32)
    ref = np.asarray(stem_conv_mxuT(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    interpret=True, groups=2))
    got = stem_conv(xt, wt, bt)  # a CPU tensor: the plain version
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("c2", [16, 48])
def test_stem_plain_matches_jax_fused_conv(rng, c2):
    """Widths and sizes the Pallas kernel cannot take, against the JAX fused
    stem Conv (same tolerance), through the port's Conv routing."""
    x, w, b, xt, wt, bt = _stem_inputs(rng, (2, 160, 96, 3), c2)
    variables = {"params": {"conv": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}}
    ref = np.asarray(JL.Conv(c2, 6, 2, p=2, fused=True).apply(variables, jnp.asarray(x)))
    conv = L.Conv(3, c2, 6, 2, 2, fused=True)
    assert conv.stem  # the fused stem routes to K2
    conv.load_state_dict({"conv.weight": wt, "conv.bias": bt})
    with torch.no_grad():
        got = conv(xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-4)


def test_stem_plain_rounds_once_in_bf16(rng):
    """bf16 in, bf16 out: the f32 result rounded once (no bf16 accumulation)."""
    _, _, _, xt, wt, bt = _stem_inputs(rng, (1, 64, 32, 3), 32)
    xb = xt.to(torch.bfloat16)
    got = stem_conv_plain(xb, wt, bt)
    ref = torch.nn.functional.conv2d(xb.float(), wt, bt, stride=2, padding=2)
    ref = torch.nn.functional.silu(ref).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("thres", [0.45, 0.6])
def test_greedy_plain_matches_pallas(rng, thres):
    """As tests/test_nms.py:144: bs 3, K=300 with padding tails; the mask must
    be equal (with max_det = K the early exit never cuts)."""
    bs, k = 3, 300
    boxes = np.stack([random_sorted_boxes(rng, k)[0] for _ in range(bs)])
    scores = np.stack([random_sorted_boxes(rng, k)[1] for _ in range(bs)])
    scores[:, 280:] = 0.0
    ref = np.asarray(greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thres,
                                       interpret=True))
    got = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thres, max_det=k)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("max_det", [1, 7, 50, 300])
@pytest.mark.parametrize("k", [40, 300, 700])
def test_greedy_plain_matches_tiled(rng, max_det, k):
    """Against _greedy_nms_tiled(max_det=...): equal up to the max_det-th
    keep, False after it (the tiled version finishes its last tile)."""
    boxes, scores = random_sorted_boxes(rng, k, span=120.0)
    scores[int(k * 0.9):] = 0.0
    ref = np.asarray(_greedy_nms_tiled(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                                       max_det=max_det))
    got = greedy_nms_plain(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                           0.45, max_det=max_det, tile=64)[0].numpy()
    np.testing.assert_array_equal(got, truncate_after(ref, max_det))


def test_greedy_plain_suppression_chain_and_ties():
    """A chain where greedy revives every other box, duplicated boxes with
    equal scores (the lower index wins), and an IoU exactly at the threshold
    (strict > keeps both)."""
    n = 12
    chain = np.stack([np.arange(n) * 5.0, np.zeros(n), np.arange(n) * 5.0 + 10,
                      np.full(n, 10.0)], 1)
    dup = np.array([[100, 100, 120, 120]] * 3, float)
    half = np.array([[200, 0, 210, 10], [205, 0, 215, 10]], float)  # IoU 1/3
    boxes = np.concatenate([chain, dup, half]).astype(np.float32)
    scores = np.concatenate([np.linspace(1.0, 0.5, n), [0.4, 0.4, 0.4], [0.3, 0.3]])
    scores = scores.astype(np.float32)
    keep = greedy_nms_plain(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                            0.3, max_det=100, tile=4)[0].numpy()
    assert keep[:n].tolist() == [i % 2 == 0 for i in range(n)]
    assert keep[n:n + 3].tolist() == [True, False, False]
    f = np.float32  # the f32 IoU of the `half` pair, rounded step by step
    thres = float(f(50) / (f(f(100) + f(100)) - f(50) + f(1e-7)))
    keep = greedy_nms_plain(torch.from_numpy(half.astype(np.float32))[None],
                            torch.tensor([[0.3, 0.3]]), thres, max_det=10)[0]
    assert keep.tolist() == [True, True]


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is neither on the CPU nor on a card gets no plain-version
    fallback: the wrappers raise."""
    boxes = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        greedy_nms(boxes, torch.empty((1, 8), device="meta"), 0.45, 10)
    x = torch.empty((1, 3, 64, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stem_conv(x, torch.empty((32, 3, 6, 6), device="meta"),
                  torch.empty((32,), device="meta"))
