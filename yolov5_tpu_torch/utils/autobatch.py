"""AutoBatch: the largest batch that fits the card's memory, the port of
``yolov5_tpu/utils/autobatch.py``.

The reference profiles CUDA memory over a few batch sizes and fits a line
(utils/autobatch.py:19-71); the JAX package reads XLA's memory analysis of
the step compiled at two batch sizes. Torch has no such analysis, so this
runs the step once at each of two probe sizes and takes the peak of
``torch.cuda.max_memory_allocated``, fits memory = a + b·batch, and solves
for a ``fraction`` of the card's memory (``torch.cuda.mem_get_info``),
rounded down to a power of two. Like the JAX package's, nothing calls it by
default.
"""

from __future__ import annotations

import numpy as np
import torch


def device_memory_bytes(device=None) -> int:
    """The card's total memory."""
    return int(torch.cuda.mem_get_info(device)[1])


def peak_memory_bytes(fn, *args, device=None) -> int:
    """The peak of allocated card memory over one call of ``fn(*args)``
    (what was resident before the call included)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn(*args)
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def fit_batch(xs, ys, limit, max_batch=1024):
    """The batch for memory ``limit`` from (batch, bytes) at two probes:
    the line a + b·batch through them, the largest batch under the limit,
    rounded down to a power of two and clamped to [1, max_batch] (the JAX
    function's arithmetic). Returns (batch, a, b)."""
    b = (ys[1] - ys[0]) / (xs[1] - xs[0])
    a = ys[0] - b * xs[0]
    bs = int((limit - a) / max(b, 1))
    bs = int(2 ** np.floor(np.log2(max(bs, 1))))  # round down to a power of two
    return max(1, min(bs, max_batch)), a, b


def autobatch(make_fn_and_args, fraction=0.8, probes=(2, 8), max_batch=1024,
              verbose=True, device=None):
    """make_fn_and_args(bs) -> (fn, args...). Runs fn once at each probe
    batch, fits memory = a + b·bs and returns the largest power-of-two bs
    whose memory stays under ``fraction`` of the card's; None without a
    card (no memory to measure)."""
    if not torch.cuda.is_available():
        if verbose:
            print("autobatch: no CUDA device to measure, keeping default")
        return None
    limit = device_memory_bytes(device) * fraction
    xs, ys = [], []
    for bs in probes:
        fn, *args = make_fn_and_args(bs)
        ys.append(peak_memory_bytes(fn, *args, device=device))
        xs.append(bs)
        del fn, args
        torch.cuda.empty_cache()
    bs, a, b = fit_batch(xs, ys, limit, max_batch)
    if verbose:
        print(f"autobatch: fit {a / 1e9:.2f}GB + {b / 1e6:.1f}MB/img, "
              f"limit {limit / 1e9:.1f}GB -> batch {bs}")
    return bs
