"""Device ms a batch of the segmentation validation's NMS, coefficients
carried, from its entry to the end of the detections' copy to the host
(span ``segval.nms`` in ``evaluate_segment``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("segval.nms", "device_ms")
