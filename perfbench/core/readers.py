"""The arithmetic of the per-layer metrics, over what a runner returns: its
traced stretch (``trace``), and the counts and bounds it worked out from
shapes (``layer``). A metric's own reader in ``metrics/`` calls one of
these; each returns None where it finds nothing to read, and a share is
never clipped."""

from __future__ import annotations

from perfbench.core import flops, trace


def idle_pct(result):
    """The share of the traced stretch in which no kernel, copy or set ran."""
    t = result.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(result):
    """The window's FLOPs (from the configuration's shapes) over its time,
    as a share of the card's bf16 peak."""
    layer = result.get("layer") or {}
    if not layer.get("flops_per_s"):
        return None
    return 100.0 * layer["flops_per_s"] / flops.PEAK_BF16


def roofline_pct(result, fragment: str, bound_key: str):
    """A kernel's least time (``layer[bound_key]``, per launch, or a list of
    the traced launches' bounds) over its traced time per launch."""
    t = result.get("trace")
    bound = (result.get("layer") or {}).get(bound_key)
    if not t or bound is None:
        return None
    secs, launches = trace.kernel_time(t["kernels"], fragment)
    if not launches or secs <= 0:
        return None
    total = sum(bound) if isinstance(bound, (list, tuple)) else bound * launches
    return 100.0 * total / secs


def span_ms(result, name: str):
    """The mean of a span the runner timed around its calls, in ms."""
    spans = (result.get("layer") or {}).get("spans", {}).get(name)
    if not spans:
        return None
    return 1000.0 * sum(spans) / len(spans)
