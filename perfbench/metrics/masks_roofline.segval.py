"""The mask stage: the least time of the traced pass's mask IoUs (from the
images' detection and GT counts, core/segment_flops.py) over the device
time of its ``segval.masks`` spans."""

from perfbench.core.segment_flops import span_roofline_pct


def read(result):
    return span_roofline_pct(result, "segval.masks", "mask_bounds_s")
