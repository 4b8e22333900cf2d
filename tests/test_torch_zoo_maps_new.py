"""The configs whose layers the port gained with the model zoo (repeated
Bottleneck, SPP, MaxPool, ZeroPad, GhostConv, C3Ghost, C3TR), port against
the JAX package: raw maps of the unfused model, the BN-folded model and
train mode on the same seeded variables, at width 0.125 and depth 0.33 (64
px, b2). The checks and their tolerances are
``torch_port_helpers.check_zoo_maps``'s."""

import pytest

from tests.torch_port_helpers import check_zoo_maps

CONFIGS = ["yolov3", "yolov3-spp", "yolov3-tiny", "yolov5s-ghost", "yolov5s-transformer"]


@pytest.mark.parametrize("mode", ["eval", "fused", "train"])
@pytest.mark.parametrize("name", CONFIGS)
def test_zoo_raw_maps(name, mode):
    check_zoo_maps(name, mode)
