"""Kernel K3, the conv epilogue act(y + b) (+ residual), on the CPU: its plain
version against the conv-with-bias path it replaces, its one rounding in
bf16, and the rule by which the model's layers engage it. The CUDA kernel is
held against the plain version in tests/test_torch_cuda.py, which needs a
card."""

import pytest
import torch
import torch.nn.functional as F

from yolov5_tpu_torch.models import layers
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain

FORMATS = {"nhwc": torch.channels_last, "nchw": torch.contiguous_format}


def _conv_inputs(c2, fmt, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 8, 5, 7), generator=gen).contiguous(memory_format=fmt)
    w = torch.randn((c2, 8, 3, 3), generator=gen) * 0.3
    b = torch.randn((c2,), generator=gen)
    r = torch.randn((2, c2, 5, 7), generator=gen).contiguous(memory_format=fmt)
    return x.to(dtype), w.to(dtype), b.to(dtype), r.to(dtype)


@pytest.mark.parametrize("c2", [16, 255, 351])
@pytest.mark.parametrize("layout", sorted(FORMATS))
@pytest.mark.parametrize("act", ["silu", "identity"])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_equals_conv_with_bias(c2, layout, act, residual):
    """f32: the epilogue on the bias-free conv equals the conv with its bias,
    then SiLU (or nothing), then + residual; the memory format is kept."""
    x, w, b, r = _conv_inputs(c2, FORMATS[layout])
    ref = layers.ACTIVATIONS[act](F.conv2d(x, w, b, padding=1))
    if residual:
        ref = r + ref
    got = conv_epilogue(F.conv2d(x, w, None, padding=1), b, act, r if residual else None)
    assert got.is_contiguous(memory_format=FORMATS[layout])
    torch.testing.assert_close(got, ref)


@pytest.mark.parametrize("residual", [False, True])
def test_plain_rounds_once_in_bf16(residual):
    """bf16 in, bf16 out: bias, SiLU and residual in f32, rounded once; the
    path it replaces rounds after each of them and differs somewhere."""
    x, w, b, r = _conv_inputs(255, torch.channels_last, torch.bfloat16)
    y = F.conv2d(x, w, None, padding=1)
    got = conv_epilogue_plain(y, b, "silu", r if residual else None)
    ref = F.silu(y.float() + b.float().view(1, -1, 1, 1))
    if residual:
        ref = ref + r.float()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref.to(torch.bfloat16), atol=0, rtol=0)
    stepwise = F.silu(y + b.view(1, -1, 1, 1))
    if residual:
        stepwise = r + stepwise
    assert not torch.equal(got, stepwise)


def test_plain_rejects_other_activations():
    y = torch.zeros((1, 4, 2, 2))
    with pytest.raises(ValueError, match="act"):
        conv_epilogue_plain(y, torch.zeros(4), "leaky_relu")


@pytest.fixture
def recorded(monkeypatch):
    """The calls the layers make to the epilogue: (act, with a residual),
    with the rule taking CPU tensors as it takes the card's (``on_card``
    patched), so the plain version stands in for the kernel."""
    calls = []

    def record(y, b, act, residual=None):
        calls.append((act, residual is not None))
        return conv_epilogue(y, b, act, residual)

    monkeypatch.setattr(layers, "conv_epilogue", record)
    monkeypatch.setattr(layers, "on_card", lambda x: True)
    return calls


def _image(s=64):
    return torch.rand((1, 3, s, s), generator=torch.Generator().manual_seed(1)).contiguous(
        memory_format=torch.channels_last)


def test_fused_inference_engages_every_conv_but_the_stem(recorded):
    """A fused yolov5n under inference_mode: 56 Convs (7 ending a residual
    Bottleneck) and 3 Detect levels, the K2 stem apart; the maps equal the
    run with gradients on, which keeps the conv-with-bias path."""
    model = DetectionModel("yolov5n", fused=True).eval()
    recorded.clear()  # the constructor's stride probe runs under no_grad
    x = _image()
    with torch.inference_mode():
        got = model(x)
    assert len(recorded) == 59
    assert sum(res for _, res in recorded) == 7
    assert sum(act == "identity" for act, _ in recorded) == 3
    recorded.clear()
    ref = model(x)
    assert recorded == []
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r.detach())


@pytest.mark.parametrize("case", ["unfused", "train_with_grad", "leaky_relu", "export"])
def test_engagement_rule_leaves_the_rest(recorded, case):
    """No epilogue for an unfused model's Convs (its 3 Detect convs, which
    have their bias either way, take it), for a forward whose gradients
    autograd needs, for an activation the kernel does not compute, or in a
    graph that torch.export traces (which keeps each conv's bias)."""
    if case == "export":
        conv = layers.Conv(8, 16, 3, fused=True).eval()
        with torch.no_grad():
            program = torch.export.export(conv, (torch.randn(1, 8, 8, 8),))
        assert sum(n.target == torch.ops.aten.add.Tensor for n in program.graph.nodes) == 0
    elif case == "leaky_relu":
        conv = layers.Conv(8, 16, 3, act="leaky_relu", fused=True).eval()
        with torch.inference_mode():
            conv(torch.randn(1, 8, 8, 8))
        assert conv.epilogue is None
    else:
        model = DetectionModel("yolov5n", fused=case != "unfused")
        recorded.clear()
        if case == "unfused":
            with torch.inference_mode():
                model.eval()(_image())
        else:
            model.train()(_image())[0].sum().backward()
    assert recorded == ([("identity", False)] * 3 if case == "unfused" else [])


def test_cpu_forward_keeps_conv_with_bias(monkeypatch):
    """Off the card nothing engages: a fused yolov5n under inference_mode on
    the CPU runs each conv with its bias and gives the same maps, bit for
    bit, as with the epilogue's call taken away."""
    calls = []
    monkeypatch.setattr(layers, "conv_epilogue", lambda *a, **k: calls.append(a))
    model = DetectionModel("yolov5n", fused=True).eval()
    x = _image()
    with torch.inference_mode():
        got = model(x)
    assert calls == []
    monkeypatch.setattr(layers, "eager_inference", lambda x, conv: False)
    with torch.inference_mode():
        ref = model(x)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_frozen_parameters_engage_with_grad_enabled(recorded):
    """Grad mode alone does not keep the epilogue off: with no input or
    parameter requiring a gradient it engages."""
    conv = layers.Conv(8, 16, 3, fused=True).eval().requires_grad_(False)
    x = torch.randn(1, 8, 8, 8)
    got = conv(x)
    assert recorded == [("silu", False)]
    torch.testing.assert_close(got, F.silu(conv.conv(x)))
