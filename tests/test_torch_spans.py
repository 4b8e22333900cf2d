"""The port's spans (``utils/profile.span``): off without a recorder, the
phases of ``Detector.__call__`` and ``evaluate`` with their parents and
counts, host ranges in ``torch.profiler``'s own events,
``evaluate``'s ``speed_ms`` read from its spans, and the benchmark's readers
of the stored spans (yolov5n, nc 3, 64 px, f32 on the CPU)."""

import contextlib
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from perfbench.core import spec
from tests.torch_port_helpers import write_shapes_dataset, yolov5n_cfg
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.data.imageio import imwrite
from yolov5_tpu_torch.eval import evaluator
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.ops.nms import detections_to_numpy
from yolov5_tpu_torch.utils import profile as prof

CPU = torch.device("cpu")
DETECT_SPANS = ["detect", "detect.input", "detect.model", "nms", "nms.fetch"]


@pytest.fixture(scope="module")
def det():
    return Detector(None, cfg=yolov5n_cfg(3), imgsz=64, device="cpu")


@pytest.fixture
def store():
    prof.store.clear()
    yield prof.store
    prof.store.clear()


def test_span_without_recorder_is_the_shared_null_context(store):
    a = prof.span("val.forward", images=2)
    b = prof.span("nms", device=CPU)
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass
    assert store.spans() == []


def test_detector_spans_under_the_profiler(det, store):
    batch = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(2):
            detections_to_numpy(det(batch, conf_thres=0.001))
    spans = store.spans()
    assert [s.name for s in spans] == DETECT_SPANS * 2
    first, second = spans[:5], spans[5:]
    assert [s.parent for s in first] == [None, "detect", "detect", "detect", None]
    assert [s.parent for s in second] == [s.parent for s in first]
    assert first[4].start_ns >= first[0].end_ns  # the fetch follows the call
    assert second[0].start_ns >= first[4].end_ns
    for s in first:
        assert s.end_ns >= s.start_ns and s.device_ms == s.host_ms  # no events on the CPU
    cpu_events = {e.name() for e in p.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU}
    assert set(DETECT_SPANS) <= cpu_events


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    write_shapes_dataset(root, [(48, 64), (64, 48), (64, 64), (40, 64), (64, 56)],
                         ext=".bmp", write=imwrite)
    return root / "images" / "val"


def test_evaluate_spans_and_speed(det, val_set):
    _, loader = create_loader(str(val_set), img_size=64, batch_size=2, rect=True, stride=32)
    with prof.recording() as spans:
        res = evaluator.evaluate(det.forward, loader, "cpu")
    n = len(loader)
    assert n == 3
    by = {name: [s for s in spans if s.name == name]
          for name in ("val.load", "val.forward", "val.nms", "val.match", "val.ap")}
    # a load a batch, and the last one that finds the loader's end
    assert [len(v) for v in by.values()] == [n + 1, n, n, n, 1]
    for b in range(n):  # each batch's phases in order
        assert (by["val.load"][b].end_ns <= by["val.forward"][b].start_ns
                and by["val.forward"][b].end_ns <= by["val.nms"][b].start_ns
                and by["val.nms"][b].end_ns <= by["val.match"][b].start_ns
                <= by["val.match"][b].end_ns <= by["val.load"][b + 1].start_ns)
    assert by["val.ap"][0].start_ns >= by["val.load"][n].end_ns
    assert sum(s.counts["images"] for s in by["val.forward"]) == res["images"] == 5
    assert {s.parent for s in spans if s.name in ("detect.model", "nms")} == {
        "val.forward", "val.nms"}
    timed = sum(s.counts["images"] for s in by["val.forward"][1:])  # the first left out
    expect = {k: sum(getattr(s, clock) for s in by[name][1:]) / timed
              for k, name, clock in (("forward", "val.forward", "device_ms"),
                                     ("nms", "val.nms", "device_ms"),
                                     ("host", "val.match", "host_ms"))}
    assert res["speed_ms"] == pytest.approx(expect, rel=1e-12)
    assert all(v > 0 for v in res["speed_ms"].values())


class _Unsized:
    """A loader with no ``__len__`` that records whether it was run to its end."""

    def __init__(self, loader):
        self.ds, self._loader, self.ended = loader.ds, loader, False

    def __iter__(self):
        yield from self._loader
        self.ended = True


def test_evaluate_takes_a_loader_without_len(det, val_set):
    _, loader = create_loader(str(val_set), img_size=64, batch_size=2, rect=True, stride=32)
    unsized = _Unsized(loader)
    got = evaluator.evaluate(det.forward, unsized, "cpu")
    want = evaluator.evaluate(det.forward, loader, "cpu")
    assert unsized.ended and got["images"] == want["images"] == 5
    assert (got["map"], got["map50"], got["per_class"]) == (want["map"], want["map50"],
                                                            want["per_class"])


def test_store_is_bounded():
    s = prof.SpanStore(limit=3)
    for i in range(5):
        s.append(i)
    assert s.spans() == [2, 3, 4]
    s.clear()
    assert s.spans() == []


def test_spans_in_threads_keep_their_own_parents():
    """Each thread's spans nest under that thread's own open span."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(t):
        try:
            for _ in range(200):
                with prof.span(f"outer{t}"), prof.span(f"inner{t}"):
                    pass
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    try:
        with prof.recording() as spans:
            threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(spans) == 16 * 200 * 2
    for s in spans:
        if s.name.startswith("inner"):
            assert s.parent == "outer" + s.name[5:]


def _fake(name, parent=None, host=0.0, device=0.0):
    return SimpleNamespace(name=name, parent=parent, host_ms=host, device_ms=device)


READERS = [  # (metric, its expected mean over the hand-made store below)
    ("input_ms.detect", (1.0 + 3.0) / 2),
    ("model_ms.detect", (6.0 + 8.0) / 2),
    ("nms_ms.detect", (0.5 + 1.5) / 2),
    ("enqueue_ms.detect", (2.0 + 4.0) / 2),
    ("forward_ms.val", (20.0 + 30.0) / 2),
    ("nms_ms.val", (4.0 + 6.0) / 2),
    ("match_ms.val", (25.0 + 35.0 + 10.0) / 2),
]


@pytest.mark.parametrize("metric,expected", READERS)
def test_span_readers(monkeypatch, metric, expected):
    hand_made = prof.SpanStore()
    for k in range(2):
        for s in (_fake("detect", host=2.0 + 2 * k, device=99.0),
                  _fake("detect.input", "detect", device=1.0 + 2 * k),
                  _fake("detect.model", "detect", device=6.0 + 2 * k),
                  _fake("nms", "detect", device=0.5 + k),
                  _fake("nms.fetch", host=50.0, device=50.0),
                  _fake("val.load", host=100.0),
                  _fake("val.forward", device=20.0 + 10 * k),
                  _fake("detect.model", "val.forward", device=99.0),
                  _fake("val.nms", device=4.0 + 2 * k),
                  _fake("nms", "val.nms", device=99.0),
                  _fake("val.match", host=25.0 + 10 * k, device=99.0)):
            hand_made.append(s)
    hand_made.append(_fake("val.ap", host=10.0))
    reader = spec.metric_reader(metric)
    monkeypatch.setattr(prof, "store", hand_made)
    assert reader.read({}) == pytest.approx(expected)
    monkeypatch.setattr(prof, "store", prof.SpanStore())
    assert reader.read({}) is None
    monkeypatch.delattr(prof, "store")  # a program that keeps no store
    assert reader.read({}) is None
