"""Device ms a batch of the mask stage: mask assembly, GT resize and mask
IoUs (span ``segval.masks`` around ``_mask_ious``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("segval.masks", "device_ms")
