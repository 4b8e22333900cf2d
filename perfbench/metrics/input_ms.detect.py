"""Device ms a batch of the detector's input: the copy to the card, the
layout and the cast (span ``detect.input`` in ``Detector.__call__``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("detect.input", "device_ms", parent="detect")
