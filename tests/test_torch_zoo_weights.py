"""Weights of the model zoo between the packages: the conversions invert each
other on every new parameter layout, the port's BN folds (CrossConv's
named pairs, MixConv2d's split BN, BottleneckCSP's BN that stays), the
optimizer groups, and the JAX package's gaps that ROADMAP.md lists under
"Know these gaps", each shown as it stands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo_layers import ZOO_CFG
from tests.torch_port_helpers import assert_maps_close, nchw, random_jax_variables, zoo_pair
from yolov5_tpu.models import layers as JL
from yolov5_tpu.models.weights import fuse_conv_bn as jax_fuse_conv_bn
from yolov5_tpu.models.weights import import_torch_weights
from yolov5_tpu.models.weights import torch_key_to_flax as jax_torch_key_to_flax
from yolov5_tpu.train.optim import group_labels
from yolov5_tpu_torch.models import layers as L
from yolov5_tpu_torch.models.weights import (from_jax_variables, fuse_conv_bn, load_weights,
                                             to_jax_variables, torch_key_to_flax)
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.train.optim import group_of

NEW_MODELS = ["yolov3", "yolov3-spp", "yolov3-tiny", "yolov5s-ghost", "yolov5s-transformer",
              "zoo-layers"]


def _pair(name):
    return zoo_pair(name, ZOO_CFG if name == "zoo-layers" else None)


def _layer_variables(flax_mod, c1, seed=0):
    v = flax_mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, c1)))
    return random_jax_variables(jax.tree_util.tree_map(np.asarray, dict(v)),
                                np.random.default_rng(seed))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb), set(la) ^ set(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))


@pytest.mark.parametrize("name,fused", [(n, False) for n in NEW_MODELS]
                         + [(n, True) for n in NEW_MODELS if n != "zoo-layers"])
def test_round_trip_models(name, fused):
    """to_jax_variables(from_jax_variables(v)) == v, unfused and fused (by
    the JAX package's fold, which covers every layer of the bundled models;
    the zoo-layers model's CrossConv, MixConv2d and BottleneckCSP it leaves
    unfolded: test_jax_fold_gap); the port's keys are its model's own."""
    cfg, jm, v, _ = _pair(name)
    if fused:
        v = jax.tree_util.tree_map(np.asarray, jax_fuse_conv_bn(v))
    sd = from_jax_variables(v)
    own = {k for k in DetectionModel(cfg, fused=fused).state_dict()
           if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    _assert_same_tree(to_jax_variables(sd), v)


@pytest.mark.parametrize("layer", ["DWConvTranspose2d", "FReLU", "AconC"])
def test_round_trip_layers(layer):
    flax_mod, port = {"DWConvTranspose2d": (JL.DWConvTranspose2d(12, 4, 2, 1),
                                            L.DWConvTranspose2d(8, 12, 4, 2, 1)),
                      "FReLU": (JL.FReLU(), L.FReLU(8)), "AconC": (JL.AconC(), L.AconC(8))}[layer]
    v = _layer_variables(flax_mod, 8)
    sd = from_jax_variables(v)
    port.load_state_dict(sd)  # every key and shape the port's layer has
    _assert_same_tree(to_jax_variables(sd), v)


@pytest.mark.parametrize("name", NEW_MODELS + ["layers"])
def test_group_of_matches_jax_group_labels(name):
    """The port's optimizer group of every parameter key equals the JAX
    package's label of the same leaf: biases, BN scales (``bn`` and
    CrossConv's ``cv1_bn``/``cv2_bn``), and the rest, Dense kernels and
    AconC's p1, p2, beta among them."""
    if name == "layers":
        v = {"params": {"layers_0": _layer_variables(JL.AconC(), 8)["params"],
                        "layers_1": _layer_variables(JL.FReLU(), 8)["params"]}}
    else:
        v = _pair(name)[2]
    labels = group_labels(v["params"])
    keys = from_jax_variables({"params": v["params"]})
    seen = set()
    for key in keys:
        coll, path = torch_key_to_flax(key)
        node = labels
        for p in path:
            node = node[p]
        assert group_of(key) == node, key
        seen.add(node)
    assert seen == {"weight", "bias", "bn"}


@pytest.mark.parametrize("layer", ["CrossConv", "MixConv2d", "BottleneckCSP"])
def test_port_fold(layer):
    """The port's fused layer on its fuse_conv_bn(state_dict) equals the JAX
    layer unfused: CrossConv's cv1_bn/cv2_bn fold into cv1_conv/cv2_conv,
    MixConv2d's one BN into its three convs slice by slice, and
    BottleneckCSP's BN after the concat stays, statistics and all."""
    c1 = 16
    flax_mod, port, fused = {
        "CrossConv": (JL.CrossConv(16, 3, 1, 1, 1.0, True), L.CrossConv(c1, 16, 3, 1, 1, 1.0, True),
                      L.CrossConv(c1, 16, 3, 1, 1, 1.0, True, fused=True)),
        "MixConv2d": (JL.MixConv2d(16, (1, 3, 5)), L.MixConv2d(c1, 16, (1, 3, 5)),
                      L.MixConv2d(c1, 16, (1, 3, 5), fused=True)),
        "BottleneckCSP": (JL.BottleneckCSP(16, n=2), L.BottleneckCSP(c1, 16, n=2),
                          L.BottleneckCSP(c1, 16, n=2, fused=True)),
    }[layer]
    v = _layer_variables(flax_mod, c1)
    sd = from_jax_variables(v)
    folded = fuse_conv_bn(sd)
    fused.load_state_dict(folded)  # strict: the fused layer's keys exactly
    assert fuse_conv_bn(folded).keys() == folded.keys()  # folded already: unchanged
    kept = {k for k in folded if k.rsplit(".", 2)[-2].endswith("bn")}
    assert kept == ({f"bn.{leaf}" for leaf in ("weight", "bias", "running_mean", "running_var")}
                    if layer == "BottleneckCSP" else set())
    x = np.random.default_rng(4).standard_normal((2, 8, 8, c1)).astype(np.float32)
    ref = flax_mod.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = fused.eval()(nchw(x)).permute(0, 2, 3, 1)
    assert_maps_close([got], [ref], 1e-4, layer)


@pytest.mark.parametrize("layer", ["CrossConv", "MixConv2d", "BottleneckCSP"])
def test_jax_fold_gap(layer):
    """Gap: the JAX package's fuse_conv_bn folds only {conv, bn} sibling
    pairs, so its fused CrossConv and MixConv2d find no conv bias, and its
    fused BottleneckCSP finds no BN statistics (the fold keeps params only):
    applying the fused JAX layer to its own folded variables fails."""
    mods = {"CrossConv": lambda f: JL.CrossConv(16, 3, 1, 1, 1.0, True, fused=f),
            "MixConv2d": lambda f: JL.MixConv2d(16, (1, 3, 5), fused=f),
            "BottleneckCSP": lambda f: JL.BottleneckCSP(16, n=1, fused=f)}[layer]
    v = _layer_variables(mods(False), 16)
    with pytest.raises(Exception):
        mods(True).apply(jax_fuse_conv_bn(v), jnp.zeros((1, 8, 8, 16)))


def test_jax_sequential_repeat_import_gap():
    """Gap: the JAX ``torch_key_to_flax`` maps a sequential repeat's
    ``model.{i}.{r}.…`` to ``layers_{i}/seq_{r}/…``, while its model names
    the repeat ``layers_{i}_{r}``: a reference-layout yolov3 state_dict
    misses every repeated layer in the JAX model. The port maps both ways."""
    cfg, jm, v, _ = _pair("yolov3")
    sd = from_jax_variables(v)
    repeated = {k for k in sd if k.split(".")[2].isdigit()}
    assert "model.6.2.cv1.conv.weight" in repeated  # yolov3's 8 repeats, 3 at depth 0.33
    assert torch_key_to_flax("model.6.2.cv1.conv.weight") == (
        "params", ["layers_6_2", "cv1", "conv", "kernel"])
    assert jax_torch_key_to_flax("model.6.2.cv1.conv.weight")[1][:2] == ["layers_6", "seq_2"]
    _, missed = import_torch_weights(jm, {k: t.numpy() for k, t in sd.items()})
    assert missed and all(m.split("/")[1].count("_") == 2 for m in missed)
    assert len(missed) == len(repeated)


def test_reference_transformer_layout_maps_onto_neither_package():
    """Gap: the reference's TransformerLayer keeps an nn.MultiheadAttention
    (``ma.in_proj_weight``/``_bias``, ``ma.out_proj``) and fc1/fc2 without
    bias; both packages' layers have q/k/v, ``ma_out`` and biased fc1/fc2.
    A reference-layout yolov5s-transformer state_dict leaves every
    attention layer unloaded in the port and in the JAX model."""
    cfg, jm, v, _ = _pair("yolov5s-transformer")
    sd = {k: t.numpy() for k, t in from_jax_variables(v).items()}
    ref = {}
    for k, a in sd.items():
        if ".ma_out." in k:
            p = k.split(".ma_out.")[0]
            c = a.shape[0]
            ref[f"{p}.ma.out_proj.{k.rsplit('.', 1)[1]}"] = a
            ref[f"{p}.ma.in_proj_weight"] = np.zeros((3 * c, c), np.float32)
            ref[f"{p}.ma.in_proj_bias"] = np.zeros(3 * c, np.float32)
        elif not (".fc1.bias" in k or ".fc2.bias" in k):
            ref[k] = a
    missed = load_weights(DetectionModel(cfg), ref)
    assert missed and all(".ma_out." in m or ".fc1.bias" in m or ".fc2.bias" in m for m in missed)
    _, jmissed = import_torch_weights(jm, ref)
    assert jmissed and all("ma_out" in m or "fc1/bias" in m or "fc2/bias" in m for m in jmissed)


def test_jax_dwconv_transpose_and_aconc_gaps():
    """Gaps of the layers no YAML names: the JAX DWConvTranspose2d drops the
    output padding p2 (the port adds it, as the reference's
    nn.ConvTranspose2d does), the reference keeps that layer's weight at
    ``model.{i}.weight`` in the transposed (c1, c2/g, k, k) layout, which
    the JAX mapping sends to ``layers_{i}/kernel`` (its layer has
    ``conv/kernel``), and the JAX mapping drops AconC's p1, p2, beta."""
    x = np.zeros((1, 5, 5, 8), np.float32)
    j = JL.DWConvTranspose2d(8, 4, 2, 1, p2=1)
    y = j.apply(j.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    assert y.shape[1:3] == (10, 10)
    assert tuple(L.DWConvTranspose2d(8, 8, 4, 2, 1, p2=1)(nchw(x)).shape[2:]) == (11, 11)
    assert jax_torch_key_to_flax("model.3.weight")[1] == ["layers_3", "kernel"]
    assert jax_torch_key_to_flax("model.3.p1") is None
    assert torch_key_to_flax("model.3.p1") == ("params", ["layers_3", "p1"])



def test_jax_fused_segment_gap():
    """Gap: the JAX Segment head builds its Proto without ``fused``
    (``layers.py:987``), so a fused JAX segmentation model looks for the
    Proto's BN statistics that its own fold removed, and does not apply. The
    port's fused Segment folds the Proto too; its maps equal the JAX model's
    unfused ones (test_torch_zoo_maps_seg.py)."""
    from yolov5_tpu.models import SegmentationModel as JaxSegmentationModel

    cfg, jm, v, x = _pair("yolov5n-seg")
    fused = JaxSegmentationModel(cfg, fused=True, packed_stem=False)
    with pytest.raises(Exception, match="batch_stats"):
        fused.apply(jax_fuse_conv_bn(v), jnp.asarray(x, jnp.float32))
