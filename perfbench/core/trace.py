"""A traced stretch of a cell's work: ``torch.profiler`` over the CPU and
the card, reduced to the seconds the card was busy (the union of its
kernels, copies and sets), the stretch's length, kernel time by name, and
the longest idle gaps with what the host was doing in each.
"""

from __future__ import annotations


def _ns(e, which):
    f = getattr(e, f"{which}_ns", None)
    return f() if f is not None else getattr(e, f"{which}_us")() * 1000


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn) -> dict:
    """Run ``fn()`` under the profiler, ending in a synchronize. Returns
    busy_s, window_s, kernels {name: [seconds, launches]} and breakdown."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = _ns(e, "start")
        d = e.duration_ns()
        (dev if e.device_type() == DeviceType.CUDA else host).append((s, s + d, e.name()))
    return summarize(dev, host)


def summarize(dev, host) -> dict:
    """The reduction of device and host events (start_ns, end_ns, name)."""
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "breakdown": {}}
    t0 = min(s for s, _, _ in dev + host)
    t1 = max(e for _, e, _ in dev + host)
    busy = _merge([(s, e) for s, e, _ in dev])
    kernels = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-9
        k[1] += 1
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
    gaps.sort(reverse=True)
    labelled = []
    for length, s, e in gaps[:10]:
        mid = (s + e) / 2
        cover = [(he - hs, name) for hs, he, name in host if hs <= mid <= he]
        if cover:
            what = "in " + min(cover)[1]
        else:
            before = [(he, name) for hs, he, name in host if he <= mid]
            what = "after " + max(before)[1] if before else "before any host event"
        labelled.append([f"idle {what[:80]}", length * 1e-9])
    ops = sorted(([n[:100], v[0]] for n, v in kernels.items()), key=lambda r: -r[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "window_s": (t1 - t0) * 1e-9,
        "kernels": kernels,
        "breakdown": {"device_ops": ops, "idle_gaps": labelled},
    }


def kernel_time(kernels: dict, fragment: str):
    """(seconds, launches) of the kernels whose name holds ``fragment``."""
    hits = [v for n, v in kernels.items() if fragment in n]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)
