"""Device ms a batch of the detector's model forward (span ``detect.model``
in ``Detector.__call__``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("detect.model", "device_ms", parent="detect")
