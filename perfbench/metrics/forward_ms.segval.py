"""Device ms a batch of the segmentation forward with its decode (span
``segval.forward`` in ``evaluate_segment``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("segval.forward", "device_ms")
