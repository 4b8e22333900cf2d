"""Host ms a batch of the validation's matching and AP: the pass's
``val.match`` and ``val.ap`` spans over its batches."""

from perfbench.core.program_spans import per_batch_ms


def read(result):
    return per_batch_ms(("val.match", "val.ap"), "val.match", "host_ms")
