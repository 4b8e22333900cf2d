"""The odd-numbered half of the bundled configs (``hub.list_models()[1::2]``;
the other half in test_torch_zoo_layout_a.py) at full width: the port's
parameter and BN layout against the JAX model's, and its BN fold against
its fused model (``torch_port_helpers.check_full_width_layout``). The
parsed specs are held equal to the JAX package's in
tests/test_torch_boxes.py."""

import pytest

from tests.torch_port_helpers import check_full_width_layout
from yolov5_tpu_torch.hub import list_models


@pytest.mark.parametrize("name", list_models()[1::2])
def test_layout_matches_jax_full_width(name):
    check_full_width_layout(name)
