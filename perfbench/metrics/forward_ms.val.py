"""Device ms a batch of the validation forward, decode included (span
``val.forward`` in ``evaluate``)."""

from perfbench.core.program_spans import mean_ms


def read(result):
    return mean_ms("val.forward", "device_ms")
