"""K2, the fused stem kernel: its least time from shapes over its traced time."""

from perfbench.core.readers import roofline_pct


def read(result):
    return roofline_pct(result, "stem_conv_kernel", "stem_bound_s")
