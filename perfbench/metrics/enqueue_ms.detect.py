"""Host ms of one ``Detector.__call__`` (span ``detect``): the call returns
before the card finishes, so this is what the host takes to launch a batch."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("detect", "host_ms")
