"""Profiling and model summary, the port of ``yolov5_tpu/utils/profile.py``.

Spans: ``span(name, **counts)`` times a named phase of the program's work
(``Detector.__call__`` and its input, model and NMS; ``evaluate``'s load,
forward, NMS, matching and AP). It records only while a recorder is active,
and otherwise returns one shared null context after reading two flags.
Recorders are a running ``torch.profiler`` session, whose spans go to the
bounded module ``store`` (the benchmark's readers fetch them with
``store.spans()``), and a ``with recording() as spans:`` block, which
collects its own. A recorded ``Span`` holds its name, its parent (the
innermost open span), its counts, its host start and end
(``time.perf_counter_ns``) and, on a CUDA device, two timing events on the
current stream, resolved into ``device_ms`` only when read; no span
synchronizes. While the profiler runs, each span is also a host range in it
(a CPU op, which adds no device event), so traces show spans beside the
card's kernels.

``chain_time`` (steady-state seconds per call: CUDA events on the card),
``model_flops`` / ``model_info`` (parameters, layers, GFLOPs), ``trace`` /
``trace_op_table`` / ``profile_model`` (``torch.profiler``: time by kernel
on the card, by op on the host).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

# a CPU-op range (RecordScope FUNCTION): unlike record_function's user scope,
# kineto derives no device-side annotation event from it
_RANGE = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_recorders: tuple = ()  # the active recording() lists, replaced whole on each change
_recorders_lock = threading.Lock()
_local = threading.local()  # per thread: the open spans


class SpanStore:
    """The spans recorded while a ``torch.profiler`` session ran: the last
    ``limit`` of them."""

    def __init__(self, limit=100_000):
        self._spans = collections.deque(maxlen=limit)
        self._lock = threading.Lock()

    def append(self, span):
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()


store = SpanStore()


class Span:
    """One recorded phase; ``host_ms`` from the host clock, ``device_ms``
    from its events on the card (the host clock where it has none)."""

    __slots__ = ("name", "parent", "counts", "start_ns", "end_ns", "_device", "_sinks",
                 "_events", "_range")

    def __init__(self, name, device, counts, sinks):
        self.name, self.counts, self._device, self._sinks = name, counts, device, sinks
        self.parent = self.start_ns = self.end_ns = self._events = self._range = None

    def __enter__(self):
        open_spans = _local.__dict__.setdefault("open", [])
        if open_spans:
            self.parent = open_spans[-1].name
        for sink in self._sinks:
            sink.append(self)
        open_spans.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = _RANGE(self.name)
            self._range.__enter__()
        if self._device is not None and self._device.type == "cuda":
            stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _local.open.pop()
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float:
        if self._events is None:
            return self.host_ms
        start, end = self._events
        end.synchronize()  # done already where the caller synchronized after the span
        return start.elapsed_time(end)


def span(name, *, device=None, **counts):
    """A context that records the phase ``name`` with ``counts`` (e.g.
    ``images=32``) while a recorder is active, else the shared null context.
    ``device``: the ``torch.device`` its work runs on (a CUDA device gives
    it timing events)."""
    profiling = _autograd_profiler._is_profiler_enabled
    if not (profiling or _recorders):
        return _NULL
    sinks = (*_recorders, store) if profiling else _recorders
    return Span(name, device, counts, sinks)


@contextlib.contextmanager
def recording():
    """``with recording() as spans:`` collects, in order of entry, every
    span opened in the block (by any thread)."""
    global _recorders
    spans = []
    with _recorders_lock:
        _recorders = (*_recorders, spans)
    try:
        yield spans
    finally:
        with _recorders_lock:
            _recorders = tuple(r for r in _recorders if r is not spans)


def _on_card(tree):
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, (list, tuple)):
        return any(_on_card(t) for t in tree)
    if isinstance(tree, dict):
        return any(_on_card(t) for t in tree.values())
    return False


def chain_time(fn, args, k=10, reps=3):
    """Steady-state seconds per call of ``fn(*args)``: the median over
    ``reps`` runs of ``k`` back-to-back calls, after one warm call. Timed by
    CUDA events when an argument lies on the card, else by the host clock."""
    fn(*args)
    if _on_card(args):
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(k):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / k)
        return float(np.median(times))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        times.append((time.perf_counter() - t0) / k)
    return float(np.median(times))


def _host_copy(model):
    """An f32 eval copy of ``model`` on the host (its fused stem then runs
    the plain conv, which the counter sees)."""
    return copy.deepcopy(model).cpu().float().eval()


def _example(model, imgsz, batch):
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    return torch.zeros((batch, 3, imgsz, imgsz), dtype=dtype, device=dev).contiguous(
        memory_format=torch.channels_last)


def model_flops(model, imgsz=640, batch=1):
    """Floating-point operations per image of one inference forward at
    ``imgsz``: ``torch.utils.flop_counter.FlopCounterMode`` over a forward
    of a host copy, which counts the convolutions (2·k²·(c1/g)·c2·H·W each)
    and the matrix products (2·m·n·k). The JAX version takes XLA's cost
    analysis of the compiled forward, which also counts the elementwise work
    (activations, adds, the upsample), so it reads a few percent higher."""
    from torch.utils.flop_counter import FlopCounterMode

    m = _host_copy(model)
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            m(_example(m, imgsz, batch))
        return float(counter.get_total_flops()) / batch
    except Exception:
        return 0.0


def model_info(model, imgsz=640, verbose=True):
    """Layers, parameters and GFLOPs per image (reference model_info,
    models/yolo.py:197-199), with the JAX version's keys."""
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = len(model.specs)
    gflops = model_flops(model, imgsz) / 1e9
    info = {"layers": n_layers, "parameters": n_params, "gflops_per_img": round(gflops, 2),
            "imgsz": imgsz, "stride": list(getattr(model, "stride", ()))}
    if verbose:
        print(f"model summary: {n_layers} graph nodes, {n_params / 1e6:.2f}M params, "
              f"{gflops:.1f} GFLOPs @ {imgsz}px")
    return info


TRACE_FILE = "torch_trace.json"


@contextlib.contextmanager
def trace(log_dir="runs/profile"):
    """``torch.profiler`` over the block (the host's ops, and the card's
    kernels where there is one), written as a Chrome trace to
    ``<log_dir>/torch_trace.json`` (view in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


# the trace's device event categories (kernels, copies, fills)
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def trace_op_table(log_dir="runs/profile", top=30, device_only=True):
    """The trace that ``trace()`` wrote as [(name, calls, total_ms)], sorted
    by total time: the card's kernels with ``device_only`` (the truthful unit
    on the card is the kernel, not the module), the host's ops where the
    trace holds no kernel (a CPU run) or without it."""
    path = Path(log_dir) / TRACE_FILE
    if not path.exists():
        raise FileNotFoundError(f"no trace under {log_dir} - run trace() first")
    events = [e for e in json.loads(path.read_text()).get("traceEvents", [])
              if e.get("ph") == "X"]
    keep = events
    if device_only:
        keep = ([e for e in events if e.get("cat") in _DEVICE_CATS]
                or [e for e in events if e.get("cat") == "cpu_op"])
    dur, cnt = collections.Counter(), collections.Counter()
    for e in keep:
        dur[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
    return [(n, cnt[n], d / 1e3) for n, d in dur.most_common(top)]


def profile_model(model, imgsz=640, batch=1, log_dir="runs/profile", top=25):
    """Trace one inference forward (after a warm one) and print the time
    table; returns its rows."""
    x = _example(model, imgsz, batch)
    with torch.no_grad():
        model(x)
        with trace(log_dir):
            model(x)
    rows = trace_op_table(log_dir, top=top)
    print(f"{'op':60s} {'calls':>6s} {'ms':>9s}")
    for n, c, ms in rows:
        print(f"{n[:60]:60s} {c:6d} {ms:9.3f}")
    return rows
