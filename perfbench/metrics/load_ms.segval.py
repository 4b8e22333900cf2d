"""Host ms a batch that segmentation validation waited on the square mask
loader (span ``segval.load`` in ``evaluate_segment``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("segval.load", "host_ms")
