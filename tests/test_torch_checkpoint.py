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
    det = Detector(str(path), cfg="yolov5s", imgsz=64, device="cpu")
    assert det.nc == 3 and det.names == jdet.names == {0: "class0", 1: "class1", 2: "class2"}
    want = np.asarray(anchors or CFG["anchors"], np.float32).reshape(3, 3, 2)
    for got, ref, w in zip(det.anchors, jdet.model.anchors, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.float32))
        np.testing.assert_array_equal(got.numpy(), w)
    # the EMA weights, not the raw ones
    ema = Detector(from_jax_variables(jdet.variables), cfg=CFG, imgsz=64, device="cpu")
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
    det = Detector(str(path), imgsz=64, device="cpu")
    ref = Detector(from_jax_variables({"params": raw["params"],
                                       "batch_stats": raw["batch_stats"]}), cfg=CFG,
                   imgsz=64, device="cpu")
    ims = np.random.default_rng(3).integers(0, 255, (1, 64, 64, 3)).astype(np.uint8)
    for m, r in zip(det.forward_maps(ims), ref.forward_maps(ims)):
        np.testing.assert_array_equal(m.numpy(), r.numpy())
    with pytest.raises(ValueError, match=r"\.pt or \.ckpt"):
        Detector(str(tmp_path / "weights.bin"), device="cpu")
    with pytest.raises(FileNotFoundError):  # an exported model: the ONNX backend reads it
        Detector(str(tmp_path / "weights.onnx"), device="cpu")
    with pytest.raises(ValueError, match="ensemble"):
        Detector([str(path), str(path)], device="cpu")


# ---------------------------------------------------------------------------
# writing: the port's encoder, save_checkpoint and restore_train_state
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None, database=None)
@given(tree=_trees)
def test_packb_equals_msgpack_on_random_trees(tree):
    """Byte for byte the encoding of msgpack.packb(use_bin_type=True)."""
    assert ckpt.packb(tree) == msgpack.packb(tree, use_bin_type=True)
    assert ckpt.unpackb(ckpt.packb(tree)) == tree


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_packb_sized_forms(n):
    for obj in ("é" * (n // 2) + "a" * (n % 2), bytes(range(256)) * (n // 256) + bytes(n % 256),
                list(range(n)), {str(i): i for i in range(n)}):
        assert ckpt.packb(obj) == msgpack.packb(obj, use_bin_type=True)


def test_msgpack_serialize_equals_flax():
    """Arrays of every dtype, numpy scalars and bfloat16 (a torch tensor on
    the port's side, a jnp array on flax's) give flax's bytes, maps in
    flax's sorted key order."""
    tree = {"a": {n: (np.arange(6).reshape(2, 3) % 2).astype(n)
                  for n in ("float16", "float32", "float64", "int16", "uint32", "bool")},
            "s": np.float32(2.5), "i": np.int64(-3), "empty": np.zeros((0, 4), np.float32),
            "n": 7, "f": 0.5, "t": "x", "none": None, "list": [1, 2.5, "a", [True, False]]}
    bf = np.asarray([[1.5, -2.25], [3.0, 1e-3]], np.float32)
    ours = ckpt.msgpack_serialize({**tree, "bf16": torch.from_numpy(bf).bfloat16()})
    theirs = serialization.msgpack_serialize({**tree, "bf16": jnp.asarray(bf, jnp.bfloat16)})
    assert ours == theirs
    _same_tree(ckpt.msgpack_restore(ours), serialization.msgpack_restore(theirs))


def _trained_state(seed):
    """A port TrainState of random weights, BN statistics and EMA, with a
    stepped optimizer."""
    from tests.torch_port_helpers import random_detector_weights
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.trainer import init_train_state

    model = DetectionModel(CFG, anchors=EVOLVED)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in random_detector_weights(CFG, seed).items()}, strict=False)
    opt = Optimizer(dict(model.named_parameters()), {"warmup_epochs": 0.0}, 3, 4, 32)
    state = init_train_state(model, opt)
    ema = {k: torch.from_numpy(v) for k, v in random_detector_weights(CFG, seed + 1).items()}
    for t in (state.ema.params, state.ema.batch_stats):
        for k in t:
            t[k].copy_(ema[k])
    g = torch.Generator().manual_seed(seed)
    for _ in range(3):
        opt.step([torch.randn(p.shape, generator=g) * 0.01 for p in opt.params])
    state.step = 3
    state.ema = state.ema._replace(updates=2)
    return state


def test_port_checkpoint_loads_in_jax(tmp_path):
    """save_checkpoint's best.ckpt through yolov5_tpu's load_checkpoint: the
    EMA weights, meta and anchors; JAX Detector and the port's Detector on
    the file give the same raw maps (CPU, f32, within 1e-4)."""
    from yolov5_tpu.utils.checkpoint import load_checkpoint as jax_load
    from yolov5_tpu.utils.checkpoint import variables_from_checkpoint as jax_vars

    state = _trained_state(4)
    path = tmp_path / "best.ckpt"
    ckpt.save_checkpoint(path, state, epoch=2, best_fitness=0.125)
    payload, meta = jax_load(path)
    assert meta == {**meta, "epoch": 2, "best_fitness": 0.125, "nc": 3,
                    "format": "yolov5_tpu-ckpt-v1", "anchors": EVOLVED}
    assert int(payload["step"]) == 3 and int(payload["ema_updates"]) == 2
    assert "opt_state" not in payload and "torch_opt_state" not in payload
    got = from_jax_variables(jax_vars(payload))
    for k, v in {**state.ema.params, **state.ema.batch_stats}.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())

    jdet = JaxDetector(str(path), imgsz=64)
    det = Detector(str(path), imgsz=64, device="cpu")
    ims = np.random.default_rng(5).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    ref = jdet._forward_maps(jdet._flat_params, jdet._prep_images(ims))
    for m, r in zip(det.forward_maps(ims), ref):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=1e-4)


def test_restore_train_state_round_trip(tmp_path):
    """last.ckpt with the optimizer restores every tensor and counter."""
    from yolov5_tpu_torch.train.trainer import batch_stats

    state = _trained_state(6)
    ckpt.save_checkpoint(tmp_path / "last.ckpt", state, epoch=1, include_opt=True)
    payload, _ = ckpt.load_checkpoint(tmp_path / "last.ckpt")
    fresh = _trained_state(9)
    ckpt.restore_train_state(fresh, payload)
    assert fresh.step == 3 and fresh.ema.updates == 2
    for a, b in ((dict(state.model.named_parameters()), dict(fresh.model.named_parameters())),
                 (batch_stats(state.model), batch_stats(fresh.model)),
                 (state.ema.params, fresh.ema.params)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # 3 micro-batches at accumulate 2: updates after the first and the third
    assert fresh.opt.gradient_step == state.opt.gradient_step == 2
    assert fresh.opt.mini_step == state.opt.mini_step == 0
    for x, y in zip(state.opt.buffers["trace"], fresh.opt.buffers["trace"]):
        assert torch.equal(x, y)

    out = ckpt.strip_optimizer(tmp_path / "last.ckpt", tmp_path / "stripped.ckpt")
    stripped, meta = ckpt.load_checkpoint(out)
    assert "torch_opt_state" not in stripped and meta["epoch"] == -1


def test_jax_checkpoint_restores_into_port(tmp_path):
    """A JAX-written .ckpt (no optimizer state) restores params, BN
    statistics, EMA and counters; one with optax state raises."""
    from yolov5_tpu_torch.train.trainer import batch_stats

    path = save_jax_checkpoint(CFG, tmp_path / "jax.ckpt", anchors=EVOLVED)
    raw = serialization.msgpack_restore(path.read_bytes())
    state = _trained_state(7)
    ckpt.restore_train_state(state, ckpt.load_checkpoint(path)[0])
    live = from_jax_variables({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    ema = from_jax_variables({"params": raw["ema_params"], "batch_stats": raw["ema_stats"]})
    for k, v in {**dict(state.model.named_parameters()), **batch_stats(state.model)}.items():
        np.testing.assert_array_equal(v.detach().numpy(), live[k].numpy())
    for k, v in {**state.ema.params, **state.ema.batch_stats}.items():
        np.testing.assert_array_equal(v.numpy(), ema[k].numpy())
    assert state.step == 17 and state.ema.updates == 9

    payload = ckpt.load_checkpoint(path)[0]
    payload["opt_state"] = {"0": {"count": np.int32(4)}}
    with pytest.raises(ValueError, match="optax"):
        ckpt.restore_train_state(state, payload)
