"""Milliseconds the evaluation waited on each batch of the loader."""

from perfbench.core.readers import span_ms


def read(result):
    return span_ms(result, "load")
