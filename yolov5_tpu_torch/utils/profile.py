"""Profiling and model summary, the port of ``yolov5_tpu/utils/profile.py``.

``Profile`` (an accumulating timer), ``chain_time`` (steady-state seconds
per call: CUDA events on the card), ``model_flops`` / ``model_info``
(parameters, layers, GFLOPs), ``trace`` / ``trace_op_table`` /
``profile_model`` (``torch.profiler``: time by kernel on the card, by op on
the host).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import time
from pathlib import Path

import numpy as np
import torch


class Profile(contextlib.ContextDecorator):
    """Accumulating timer: ``with Profile() as dt: ...; dt.t`` seconds. With
    ``sync`` it waits on exit for the work queued on the card."""

    def __init__(self, t=0.0, sync=False):
        self.t = t
        self.sync = sync

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.dt = time.perf_counter() - self.start
        self.t += self.dt
        return False


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
