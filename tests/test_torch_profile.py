"""The port's profiling and autobatch utilities against the JAX package's:
model_info's layers and parameters, model_flops against the analytic count
of the convolutions and matrix products, the profiler's op table, and the
autobatch fit on given (batch, bytes) pairs. On the CPU."""

import numpy as np
import pytest
import torch

from torch_port_helpers import small_cfg
from yolov5_tpu_torch.models.yolo import (ClassificationModel, DetectionModel,
                                          SegmentationModel)
from yolov5_tpu_torch.utils import autobatch as ab
from yolov5_tpu_torch.utils import profile as prof


@pytest.mark.parametrize("kind", ["detect", "seg", "cls"])
def test_model_info_matches_jax(kind):
    """The same layers and parameters as the JAX model_info for yolov5n,
    yolov5n-seg and yolov5n-cls; the port's keys are the JAX version's."""
    from yolov5_tpu.models import ClassificationModel as JCls
    from yolov5_tpu.models import DetectionModel as JDet
    from yolov5_tpu.models import SegmentationModel as JSeg
    from yolov5_tpu.utils.profile import model_info as jax_model_info

    port, jm = {"detect": (lambda: DetectionModel("yolov5n"), lambda: JDet("yolov5n")),
                "seg": (lambda: SegmentationModel("yolov5n-seg"), lambda: JSeg("yolov5n-seg")),
                "cls": (lambda: ClassificationModel("yolov5n", nc=10),
                        lambda: JCls("yolov5n", nc=10))}[kind]
    got = prof.model_info(port(), imgsz=64, verbose=False)
    ref = jax_model_info(jm(), imgsz=64, verbose=False)
    assert got.keys() == ref.keys()
    for k in ("layers", "parameters", "imgsz", "stride"):
        assert got[k] == ref[k], k
    assert got["gflops_per_img"] > 0


def _analytic_flops(model, imgsz):
    """2·k²·(c1/g)·c2·H·W per convolution, 2·in·out per Linear token, and
    4·n²·c per attention layer (q·kᵀ and attn·v over all heads), summed from
    forward hooks on a host forward."""
    total = [0]

    def conv(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        b, c2, h, w = out.shape
        total[0] += 2 * k * (m.in_channels // m.groups) * c2 * h * w * b

    def linear(m, inp, out):
        total[0] += 2 * m.in_features * m.out_features * (inp[0].numel() // m.in_features)

    def attention(m, inp, out):
        b, n, c = inp[0].shape
        total[0] += 4 * b * n * n * c

    from yolov5_tpu_torch.models.layers import TransformerLayer

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(linear)
        elif isinstance(m, TransformerLayer):
            m.register_forward_hook(attention)
    with torch.no_grad():
        model.eval()(torch.zeros(1, 3, imgsz, imgsz).contiguous(memory_format=torch.channels_last))
    return total[0]


@pytest.mark.parametrize("cfg", ["yolov5n", "yolov5s-transformer"])
def test_model_flops_is_the_analytic_count(cfg):
    """model_flops counts the convolutions and the matrix products, nothing
    else: equal to the analytic sum (the JAX version's XLA cost analysis also
    counts the elementwise work)."""
    model = DetectionModel(cfg if cfg == "yolov5n" else small_cfg(cfg))
    want = _analytic_flops(model, 64)
    assert want > 0
    assert prof.model_flops(model, imgsz=64) == want
    assert prof.model_flops(model, imgsz=64, batch=2) == want


def test_trace_op_table_and_profile_model(tmp_path):
    """A traced forward gives non-empty (name, calls, ms) rows (the host's
    ops on the CPU), and profile_model prints and returns them."""
    model = DetectionModel("yolov5n").eval()
    x = torch.zeros(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), prof.trace(tmp_path):
        model(x)
    rows = prof.trace_op_table(tmp_path, top=5)
    assert 0 < len(rows) <= 5
    assert all(isinstance(n, str) and c >= 1 and ms >= 0 for n, c, ms in rows)
    assert any("conv" in n for n, _, _ in rows)
    assert prof.profile_model(model, imgsz=64, log_dir=tmp_path / "p", top=3)
    with pytest.raises(FileNotFoundError):
        prof.trace_op_table(tmp_path / "none")


def test_timers():
    with prof.recording() as spans, prof.span("sum"):
        sum(range(1000))
    assert len(spans) == 1 and spans[0].host_ms == spans[0].device_ms > 0
    assert prof.chain_time(lambda x: x * 2, (torch.ones(8),), k=3, reps=2) > 0


@pytest.mark.parametrize("pairs", [((2, 8), (3.1e9, 4.9e9), 80e9),
                                   ((2, 8), (1.0e9, 1.0e9 + 6 * 1.7e8), 16e9),
                                   ((4, 16), (9e9, 30e9), 64e9),
                                   ((2, 8), (1e8, 1e8 + 6), 1e12)])
def test_fit_batch_matches_jax(monkeypatch, pairs):
    """The pure fit picks the batch the JAX autobatch picks from the same
    (batch, bytes) pairs and memory (its memory readings replaced by them)."""
    import yolov5_tpu.utils.autobatch as jab

    xs, ys, mem = pairs
    memory = dict(zip(xs, ys))
    monkeypatch.setattr(jab, "device_memory_bytes", lambda device=None: mem)
    monkeypatch.setattr(jab, "compiled_memory_bytes", lambda fn, bs: memory[bs])
    ref = jab.autobatch(lambda bs: (None, bs), fraction=0.8, probes=xs, verbose=False)
    got, a, b = ab.fit_batch(xs, ys, 0.8 * mem)
    assert got == ref
    assert np.isclose(a + b * xs[1], ys[1])


def test_autobatch_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert ab.autobatch(lambda bs: (lambda: None,), verbose=False) is None
