"""The configs of 4 and 5 detection levels (P2 at stride 4, P6 at 64, P7 at
128), port against the JAX package: raw maps of the unfused model, the
BN-folded model and train mode on the same seeded variables, at width 0.125
and depth 0.33 (64 px, 128 px for P7, b2). The checks and their tolerances
are ``torch_port_helpers.check_zoo_maps``'s."""

import pytest

from tests.torch_port_helpers import check_zoo_maps

CONFIGS = ["yolov5-p2", "yolov5-p6", "yolov5-p7"]


@pytest.mark.parametrize("mode", ["eval", "fused", "train"])
@pytest.mark.parametrize("name", CONFIGS)
def test_zoo_raw_maps(name, mode):
    check_zoo_maps(name, mode)
