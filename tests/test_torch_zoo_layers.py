"""The YAML modules no bundled config uses, and the layers no YAML names,
port against the JAX package on the same seeded variables.

``ZOO_CFG`` is a small detection model that holds Focus, C3x, CrossConv
(with its shortcut), BottleneckCSP, Contract and Expand, MixConv2d (an
uneven three-way split), a sequential repeat of GhostBottleneck (the first
repeat changing the channels), a stride-2 GhostBottleneck, C3SPP with its
own pool sizes, a grouped DWConv and a two-layer TransformerBlock with its
input conv; it is checked as the bundled configs are
(``torch_port_helpers.check_zoo_maps``: unfused and BN-folded maps within
1e-4 of the largest value in f32, train mode within 1e-6 in float64).
DWConvTranspose2d, FReLU and AconC are checked alone, in f32 within 1e-4
of the largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (assert_maps_close, check_zoo_maps, nchw,
                                      random_jax_variables)
from yolov5_tpu.models import layers as JL
from yolov5_tpu_torch.models import layers as L
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.models.yolo import DetectionModel, parse_graph

ZOO_CFG = {
    "nc": 3, "depth_multiple": 1.0, "width_multiple": 0.25,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
    "backbone": [
        [-1, 1, "Focus", [32, 3]],  # 0 /2
        [-1, 1, "Conv", [64, 3, 2]],  # 1 /4
        [-1, 1, "C3x", [64]],  # 2
        [-1, 1, "CrossConv", [64, 3, 1, 1, 1.0, True]],  # 3
        [-1, 1, "BottleneckCSP", [64]],  # 4
        [-1, 1, "Contract", [2]],  # 5 /8
        [-1, 1, "MixConv2d", [128, [1, 3, 5]]],  # 6
        [-1, 2, "GhostBottleneck", [192, 3, 1]],  # 7
        [-1, 1, "GhostBottleneck", [256, 3, 2]],  # 8 /16
        [-1, 1, "C3SPP", [256, [3, 5]]],  # 9
        [-1, 1, "DWConv", [96, 3, 1]],  # 10
    ],
    "head": [
        [-1, 1, "Expand", [2]],  # 11 /8
        [[-1, 6], 1, "Concat", [1]],  # 12
        [-1, 2, "TransformerBlock", [64, 4]],  # 13
        [[13, 10], 1, "Detect", ["nc", "anchors"]],  # 14
    ],
}


def test_zoo_cfg_holds_every_unused_module():
    specs, _, _ = parse_graph(ZOO_CFG)
    mods = {s.module for s in specs}
    assert {"Focus", "C3x", "CrossConv", "BottleneckCSP", "Contract", "Expand", "MixConv2d",
            "GhostBottleneck", "C3SPP", "DWConv", "TransformerBlock"} <= mods
    ghost = specs[7]
    assert ghost.n == 2 and specs[13].n == 1 and dict(specs[13].kwargs)["n"] == 2
    model = DetectionModel(ZOO_CFG)
    assert isinstance(model.model[7], torch.nn.Sequential) and len(model.model[7]) == 2
    assert model.model[7][0].sc_pw is not None and model.model[7][1].sc_pw is None
    assert [m.out_channels for m in model.model[6].m] == [11, 11, 10]
    assert model.model[10].conv.groups == 8 and model.model[13].conv is not None
    assert model.stride == (8, 16)


@pytest.mark.parametrize("mode", ["eval", "fused", "train"])
def test_zoo_cfg_raw_maps(mode):
    check_zoo_maps("zoo-layers", mode, cfg=ZOO_CFG)


def _flax_pair(flax_mod, port_mod, x, seed=0, train=False):
    """Seeded variables for flax_mod on x, loaded into port_mod; returns both
    outputs (and the JAX model's moved batch statistics in train mode)."""
    v = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = random_jax_variables(jax.tree_util.tree_map(np.asarray, dict(v)),
                             np.random.default_rng(seed))
    port_mod.load_state_dict(from_jax_variables(v))
    if train:
        ref, upd = flax_mod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        got = port_mod.train()(nchw(x))
        return got, ref, upd
    with torch.no_grad():
        got = port_mod.eval()(nchw(x))
    return got, flax_mod.apply(v, jnp.asarray(x)), None


@pytest.mark.parametrize("c1,c2,k,s,p1", [(8, 8, 4, 2, 1), (8, 12, 3, 2, 0), (6, 6, 2, 1, 0)])
def test_dwconv_transpose2d(c1, c2, k, s, p1):
    """The port's conv_transpose2d on the flipped, regrouped weight against
    the JAX layer's input-dilated conv: depthwise (c1 = c2) and grouped
    (gcd(8, 12) = 4)."""
    x = np.random.default_rng(1).standard_normal((2, 7, 5, c1)).astype(np.float32)
    got, ref, _ = _flax_pair(JL.DWConvTranspose2d(c2, k, s, p1),
                             L.DWConvTranspose2d(c1, c2, k, s, p1), x)
    assert tuple(got.shape) == (2, c2, s * 6 + k - 2 * p1, s * 4 + k - 2 * p1)
    assert_maps_close([got.permute(0, 2, 3, 1)], [ref], 1e-4, "DWConvTranspose2d")


@pytest.mark.parametrize("train", [False, True])
def test_frelu(train):
    x = np.random.default_rng(2).standard_normal((2, 6, 6, 8)).astype(np.float32)
    port = L.FReLU(8)
    got, ref, upd = _flax_pair(JL.FReLU(), port, x, train=train)
    assert_maps_close([got.detach().permute(0, 2, 3, 1)], [ref], 1e-4, "FReLU")
    if train:
        moved = from_jax_variables({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                          upd["batch_stats"])})
        own = port.state_dict()
        assert_maps_close([own[k] for k in moved], [moved[k].numpy() for k in moved], 1e-6,
                          "FReLU running statistics")


def test_aconc():
    x = np.random.default_rng(3).standard_normal((2, 5, 5, 8)).astype(np.float32)
    port = L.AconC(8)
    got, ref, _ = _flax_pair(JL.AconC(), port, x)
    assert tuple(port.p1.shape) == (1, 8, 1, 1)
    assert_maps_close([got.permute(0, 2, 3, 1)], [ref], 1e-4, "AconC")
