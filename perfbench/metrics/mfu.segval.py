"""The window's model FLOPs per second (the frozen YAML's convs with the
Proto and the Segment head) over the bf16 peak."""

from perfbench.core.readers import mfu_pct


def read(result):
    return mfu_pct(result)
