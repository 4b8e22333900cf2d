"""yolov5_tpu_torch layers against the flax modules of yolov5_tpu on the same
parameters, fp32 on the CPU. Tolerances are those of tests/test_model.py
(blocks: atol 2e-5, rtol 1e-4; BN-folded: atol 5e-5) — two conv libraries
summing the same products in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import load_numpy_state_dict, random_state_dict
from yolov5_tpu.models import layers as JL
from yolov5_tpu.models.weights import fuse_conv_bn as jax_fuse_conv_bn
from yolov5_tpu.models.weights import import_torch_weights
from yolov5_tpu_torch.models import layers as L
from yolov5_tpu_torch.models.weights import fuse_conv_bn


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _parity(port_mod, flax_mod, c1, hw=16, atol=2e-5, seed=0):
    rng = np.random.default_rng(seed)
    sd = random_state_dict(port_mod, rng)
    load_numpy_state_dict(port_mod, sd)
    port_mod.eval()
    x = rng.standard_normal((2, hw, hw, c1)).astype(np.float32)
    with torch.no_grad():
        y_p = _nhwc(port_mod(_nchw(x)))
    variables = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables, missed = import_torch_weights(variables, sd)
    assert not missed, missed
    y_j = np.asarray(flax_mod.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(y_p, y_j, atol=atol, rtol=1e-4)
    return sd, x, variables, y_j


@pytest.mark.parametrize("k,s", [(1, 1), (3, 1), (3, 2)])
def test_conv(k, s):
    _parity(L.Conv(8, 16, k, s), JL.Conv(16, k, s), c1=8)


def test_conv_fused():
    """Conv(fused=True) on folded weights == the flax Conv with its BN."""
    port = L.Conv(8, 16, 3, 2)
    sd, x, _, y_j = _parity(port, JL.Conv(16, 3, 2), c1=8)
    fused = L.Conv(8, 16, 3, 2, fused=True)
    fused.load_state_dict(fuse_conv_bn(sd))
    with torch.no_grad():
        y_p = _nhwc(fused(_nchw(x)))
    np.testing.assert_allclose(y_p, y_j, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("shortcut", [True, False])
def test_c3(shortcut):
    _parity(L.C3(16, 32, n=2, shortcut=shortcut), JL.C3(32, n=2, shortcut=shortcut), c1=16)


def test_c3_fused():
    """C3(fused=True) on folded weights == the flax C3 on its folded weights."""
    port = L.C3(16, 32, n=1)
    sd, x, variables, _ = _parity(port, JL.C3(32, n=1), c1=16)
    fused = L.C3(16, 32, n=1, fused=True)
    fused.load_state_dict(fuse_conv_bn(sd))
    with torch.no_grad():
        y_p = _nhwc(fused(_nchw(x)))
    y_j = np.asarray(JL.C3(32, n=1, fused=True).apply(
        jax_fuse_conv_bn(variables), jnp.asarray(x), train=False))
    np.testing.assert_allclose(y_p, y_j, atol=5e-5, rtol=1e-4)


def test_sppf():
    _parity(L.SPPF(16, 32), JL.SPPF(32), c1=16)


def test_concat_and_upsample(rng):
    a = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    b = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    got = _nhwc(L.Concat()([_nchw(a), _nchw(b)]))
    ref = np.asarray(JL.Concat().apply({}, [jnp.asarray(a), jnp.asarray(b)]))
    np.testing.assert_array_equal(got, ref)
    got = _nhwc(L.Upsample(2)(_nchw(a)))
    ref = np.asarray(JL.Upsample(2).apply({}, jnp.asarray(a)))
    np.testing.assert_array_equal(got, ref)


ANCHORS = ((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119))


def test_detect_raw_maps(rng):
    """Detect's (bs, ny, nx, na, no) maps, a view of the channels_last conv
    output, equal the flax head's (same channel order a*no + o)."""
    nc, ch = 3, (8, 16)
    port = L.Detect(nc, ANCHORS, ch)
    sd = random_state_dict(port, rng)
    load_numpy_state_dict(port, sd)
    xs = [rng.standard_normal((2, 8, 6, ch[0])).astype(np.float32),
          rng.standard_normal((2, 4, 3, ch[1])).astype(np.float32)]
    with torch.no_grad():
        got = port([_nchw(x) for x in xs])
    flax_mod = JL.Detect(nc=nc, anchors=ANCHORS)
    variables = flax_mod.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs])
    variables, missed = import_torch_weights(variables, sd)
    assert not missed, missed
    ref = flax_mod.apply(variables, [jnp.asarray(x) for x in xs])
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("nc", [None, 3])
def test_decode(rng, nc):
    """decode on the same raw maps; boxes are up to ~150 px, so a 1-ulp
    difference of the two sigmoids moves them by ~1e-5."""
    no = 5 + 3 + 2
    maps = [rng.normal(0, 2, (2, 4, 5, 3, no)).astype(np.float32),
            rng.normal(0, 2, (2, 2, 3, 3, no)).astype(np.float32)]
    strides = (8, 16)
    got = L.decode([torch.from_numpy(m) for m in maps], ANCHORS, strides, nc=nc).numpy()
    ref = np.asarray(JL.decode([jnp.asarray(m) for m in maps], ANCHORS, strides, nc=nc))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-6)
