"""K1, the greedy suppression kernel, on 117-wide rows: the least time of
the reference's own candidates and walk over its traced time."""

from perfbench.core.readers import roofline_pct


def read(result):
    return roofline_pct(result, "greedy_nms_kernel", "nms_bounds_s")
