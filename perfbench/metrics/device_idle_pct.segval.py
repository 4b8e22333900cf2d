"""Share of the traced segmentation validation pass in which the card ran
nothing."""

from perfbench.core.readers import idle_pct


def read(result):
    return idle_pct(result)
