"""Device ms a batch of the validation NMS, from its entry to the end of
the detections' copy to the host (span ``val.nms`` in ``evaluate``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("val.nms", "device_ms")
