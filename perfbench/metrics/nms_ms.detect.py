"""Device ms a batch of the NMS tail from the raw maps: selection, decode of
the survivors, K1 and compaction (span ``nms`` in ``Detector.__call__``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("nms", "device_ms", parent="detect")
