"""The window's model FLOPs per second over the bf16 peak."""

from perfbench.core.readers import mfu_pct


def read(result):
    return mfu_pct(result)
