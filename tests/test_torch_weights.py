"""Weight conversion between the packages: from_jax_variables inverts
import_torch_weights, fuse_conv_bn gives the JAX package's folded weights,
and the .pt loader reads what torch.save wrote."""

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import random_state_dict
from yolov5_tpu.models import DetectionModel as JaxDetectionModel
from yolov5_tpu.models.weights import fuse_conv_bn as jax_fuse_conv_bn
from yolov5_tpu.models.weights import import_torch_weights
from yolov5_tpu_torch.models.weights import (fuse_conv_bn, from_jax_variables,
                                             load_torch_state_dict, load_weights)
from yolov5_tpu_torch.models.yolo import DetectionModel


@pytest.fixture(scope="module")
def models():
    """The yolov5n graph in both packages and one random unfused state_dict."""
    port = DetectionModel("yolov5n")
    sd = random_state_dict(port, np.random.default_rng(3))
    return port, JaxDetectionModel("yolov5n"), sd


def test_state_dict_layouts_agree(models):
    """Every key the port's model has, the JAX model's variables convert to,
    with the same shape, fused and unfused."""
    port, jm, _ = models
    for fused in (False, True):
        p = DetectionModel("yolov5n", fused=fused) if fused else port
        v = jax_fuse_conv_bn(jm.variables) if fused else jm.variables
        conv = from_jax_variables(v)
        own = {k: tuple(t.shape) for k, t in p.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        assert own == {k: tuple(t.shape) for k, t in conv.items()}


def test_from_jax_variables_round_trip(models):
    """state_dict -> import_torch_weights -> from_jax_variables is the identity."""
    _, jm, sd = models
    variables, missed = import_torch_weights(jm, sd)
    assert not missed, missed[:5]
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_fuse_conv_bn_matches_jax(models):
    """The same folding math in both packages; f32 elementwise ops in the same
    order, so the results agree to the last ulp."""
    _, jm, sd = models
    variables, _ = import_torch_weights(jm, sd)
    ref = from_jax_variables(jax_fuse_conv_bn(variables))
    got = fuse_conv_bn(sd)
    assert set(got) == set(ref)
    assert not any(".bn." in k for k in got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert fuse_conv_bn(got).keys() == got.keys()  # already folded: unchanged


def test_pt_loader_and_load_weights(models, tmp_path):
    port, _, sd = models
    path = tmp_path / "w.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded = load_torch_state_dict(path)
    assert set(loaded) == set(sd)
    m = DetectionModel("yolov5n", nc=3)  # a head of another width
    missed = load_weights(m, loaded)
    assert missed and all("model.24.m." in s and "shape mismatch" in s for s in missed)
    np.testing.assert_array_equal(m.state_dict()["model.0.conv.weight"].numpy(),
                                  sd["model.0.conv.weight"])
