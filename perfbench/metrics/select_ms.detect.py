"""Device ms a batch of the from-maps NMS selection: per-level scoring, sort,
gather and decode, and the global re-sort, before K1 (span ``nms.select``
inside ``nms``). A program without the span reads None."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("nms.select", "device_ms", parent="nms")
