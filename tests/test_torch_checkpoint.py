"""Reading the JAX package's .ckpt without flax or msgpack: the port's
msgpack decoder against flax.serialization.msgpack_restore and against
msgpack.unpackb, and Detector(".ckpt") of both packages on the same file."""

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.torch_port_helpers import (assert_same_detection_sets, save_jax_checkpoint,
                                      yolov5n_cfg)
from yolov5_tpu.infer import Detector as JaxDetector
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.utils import checkpoint as ckpt

CFG = yolov5n_cfg(3)
# anchors an autoanchor run could have left: not the cfg's
EVOLVED = [[12, 14, 18, 33, 35, 25], [33, 60, 66, 47, 61, 122], [120, 95, 160, 190, 380, 330]]


def _same_tree(got, ref):
    """Equal trees; bfloat16 leaves (torch on the port's side) by value."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys()
        for k in ref:
            _same_tree(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for x, y in zip(got, ref):
            _same_tree(x, y)
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert type(got) is type(ref) and got == ref


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_restore_equals_flax(tmp_path, dtype):
    path = save_jax_checkpoint(CFG, tmp_path / "w.ckpt", dtype=dtype)
    data = path.read_bytes()
    _same_tree(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))
    payload, meta = ckpt.load_checkpoint(path)
    assert meta["epoch"] == 3 and meta["format"] == "yolov5_tpu-ckpt-v1"
    assert ckpt.variables_from_checkpoint(payload)["params"] is payload["ema_params"]
    assert ckpt.variables_from_checkpoint(payload, prefer_ema=False)["params"] is payload["params"]


def test_restore_scalars_and_arrays_of_every_dtype():
    tree = {"s": {n: np.asarray(1.5 if "float" in n else 3).astype(n)[()]
                  for n in ("float16", "float32", "float64", "int8", "int32", "int64",
                            "uint8", "uint64", "bool")},
            "a": {n: (np.arange(6).reshape(2, 3) % 2).astype(n)
                  for n in ("float16", "float32", "float64", "int16", "uint32", "bool")},
            "bf16": jnp.asarray([[1.5, -2.25], [3.0, 1e-3]], jnp.bfloat16),
            "scalar_bf16": np.asarray(2.5, jnp.bfloat16)[()],
            "empty": np.zeros((0, 4), np.float32), "n": 7, "f": 0.5, "t": "x", "none": None,
            "list": [1, 2.5, "a", [True, False]]}
    data = serialization.msgpack_serialize(tree)
    _same_tree(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))


_leaves = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
_trees = st.recursive(_leaves, lambda c: st.lists(c, max_size=20)
                      | st.dictionaries(st.text(max_size=8), c, max_size=20), max_leaves=60)


@settings(max_examples=200, deadline=None, database=None)
@given(tree=_trees, single=st.booleans())
def test_unpackb_equals_msgpack_on_random_trees(tree, single):
    data = msgpack.packb(tree, use_bin_type=True, use_single_float=single)
    assert ckpt.unpackb(data) == msgpack.unpackb(data, raw=False)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_unpackb_sized_forms(n):
    """fix, 8, 16 and 32 forms of str, bin, array and map at their edges."""
    for obj in ("é" * (n // 2) + "a" * (n % 2), bytes(range(256)) * (n // 256) + bytes(n % 256),
                list(range(n)), {str(i): i for i in range(n)}):
        data = msgpack.packb(obj, use_bin_type=True)
        assert ckpt.unpackb(data) == msgpack.unpackb(data, raw=False)


def test_unpackb_ints_and_floats_of_every_width():
    for v in (0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32,
              -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -1e300):
        for single in (False, True):
            data = msgpack.packb(v, use_single_float=single)
            got = ckpt.unpackb(data)
            assert got == msgpack.unpackb(data) and type(got) is type(v)


@pytest.mark.parametrize("data", [
    msgpack.packb(msgpack.ExtType(5, b"abcd")),  # an ext type flax does not write
    serialization.msgpack_serialize({"c": 1 + 2j}),  # flax's complex scalar (ext 2)
    msgpack.packb(msgpack.Timestamp(1)),  # ext -1
    b"\xc1",  # never used
    msgpack.packb([1, 2, 3])[:-1],  # truncated
    msgpack.packb(1) + b"\x00",  # trailing bytes
    b"\x81\x01\x02",  # {1: 2}: a non-string key
], ids=["ext5", "complex", "timestamp", "c1", "truncated", "trailing", "int-key"])
def test_unpackb_rejects_what_flax_does_not_write(data):
    with pytest.raises(ValueError):
        ckpt.msgpack_restore(data)


@pytest.mark.parametrize("anchors", [None, EVOLVED])
def test_detector_ckpt_matches_jax(tmp_path, anchors):
    """Detector("x.ckpt") of both packages: EMA weights, cfg and names from
    the meta, anchors from the meta where they differ from the cfg's; raw
    maps within 2e-3 and detections matched within 1e-3, the tolerances of
    tests/test_torch_detector.py."""
    path = save_jax_checkpoint(CFG, tmp_path / "best.ckpt", anchors=anchors)
    jdet = JaxDetector(str(path), cfg="yolov5s", imgsz=64)
    det = Detector(str(path), cfg="yolov5s", imgsz=64)
    assert det.nc == 3 and det.names == jdet.names == {0: "class0", 1: "class1", 2: "class2"}
    want = np.asarray(anchors or CFG["anchors"], np.float32).reshape(3, 3, 2)
    for got, ref, w in zip(det.anchors, jdet.model.anchors, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.float32))
        np.testing.assert_array_equal(got.numpy(), w)
    # the EMA weights, not the raw ones
    ema = Detector(from_jax_variables(jdet.variables), cfg=CFG, imgsz=64)
    ims = np.random.default_rng(2).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    ref_maps = jdet._forward_maps(jdet._flat_params, jdet._prep_images(ims))
    for m, e, r in zip(det.forward_maps(ims), ema.forward_maps(ims), ref_maps):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=2e-3)
        # BN folded by each package from the same EMA weights: f32 rounding
        np.testing.assert_allclose(m.numpy(), e.numpy(), atol=1e-4)
    np.testing.assert_allclose(det.forward(ims).numpy(),
                               np.asarray(jdet._forward(jdet.variables, jnp.asarray(ims))),
                               atol=2e-3)
    kw = dict(conf_thres=0.01, max_nms=256, max_det=100)  # cap below the 252*3 candidates
    got = det(ims, **kw)
    assert int(got.valid.sum()) > 0
    assert_same_detection_sets(got, jdet(ims, **kw), atol=1e-3)


def test_detector_ckpt_without_ema_and_weights_errors(tmp_path):
    """Without EMA weights the raw ones load."""
    path = save_jax_checkpoint(CFG, tmp_path / "last.ckpt", ema=False)
    raw = serialization.msgpack_restore(path.read_bytes())
    det = Detector(str(path), imgsz=64)
    ref = Detector(from_jax_variables({"params": raw["params"],
                                       "batch_stats": raw["batch_stats"]}), cfg=CFG, imgsz=64)
    ims = np.random.default_rng(3).integers(0, 255, (1, 64, 64, 3)).astype(np.uint8)
    for m, r in zip(det.forward_maps(ims), ref.forward_maps(ims)):
        np.testing.assert_array_equal(m.numpy(), r.numpy())
    with pytest.raises(ValueError, match=r"\.pt or \.ckpt"):
        Detector(str(tmp_path / "weights.onnx"))
    with pytest.raises(ValueError, match="ensemble"):
        Detector([str(path), str(path)])
