"""Host ms a batch of segmentation validation's box and mask matching and
AP: the pass's ``segval.match`` and ``segval.ap`` spans over its batches."""

from perfbench.core.program_spans import per_batch_ms


def read(result):
    return per_batch_ms(("segval.match", "segval.ap"), "segval.match", "host_ms")
