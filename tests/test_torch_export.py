"""The port's export path against the JAX package's: the ONNX wire codec (a
copy, byte for byte), the torch.export -> ONNX converter (its files parse
with the JAX codec, run in both packages' runtimes and match the JAX
forward on the same weights), the JAX package's files in the port's
runtime, the zoo's layer families, the fused .ckpt both ways, the .pt2
program and the format table. yolov5n at <= 160 px, narrow zoo models at
64 px."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (assert_same_detection_sets, random_detector_weights,
                                random_state_dict, seg_cfg, small_cfg, yolov5n_cfg)
from yolov5_tpu_torch import export as export_t
from yolov5_tpu_torch.models import weights as W
from yolov5_tpu_torch.models.yolo import (ClassificationModel, DetectionModel,
                                          SegmentationModel)
from yolov5_tpu_torch.onnx import proto as proto_t
from yolov5_tpu_torch.onnx.convert import UnsupportedOp, to_onnx
from yolov5_tpu_torch.onnx.runtime import Runtime

NC = 3


def _leaky_cfg():
    """yolov5s-LeakyReLU (a global LeakyReLU(0.1)) at yolov5n's depth and width."""
    import yaml

    from yolov5_tpu_torch.models.yolo import CONFIG_DIR

    with open(CONFIG_DIR / "yolov5s-LeakyReLU.yaml") as f:
        cfg = yaml.safe_load(f)
    return {**cfg, "nc": NC, "depth_multiple": 0.33, "width_multiple": 0.25}


def _fused(model_cls, cfg, sd, **kw):
    """The port's BN-folded model of ``cfg`` with the numpy state_dict sd."""
    model = model_cls(cfg, fused=True, **kw)
    assert not W.load_weights(model, W.fuse_conv_bn({k: torch.from_numpy(v)
                                                      for k, v in sd.items()}))
    return model.eval()


def _jax_forward(kind, cfg, sd, images):
    """The JAX package's outputs on uint8 NHWC images for the same weights:
    decoded predictions (and prototypes), or logits; BN folded as the JAX
    export folds it, but for the segmenter, whose fused Proto the JAX package
    cannot build (ROADMAP §3), which runs with its BN."""
    from yolov5_tpu.models import ClassificationModel as JCls
    from yolov5_tpu.models import DetectionModel as JDet
    from yolov5_tpu.models.weights import fuse_conv_bn, import_torch_weights

    x = jnp.asarray(images, jnp.float32) / 255.0
    if kind == "cls":
        m = JCls(cfg, nc=NC)
        v, missed = import_torch_weights(m, sd)
        assert not missed
        return [np.asarray(jax.jit(lambda v, x: m.apply(v, x, train=False))(v, x))]
    m = JDet(cfg)
    v, missed = import_torch_weights(m, sd)
    assert not missed
    if kind != "seg":
        m, v = JDet(cfg, fused=True), fuse_conv_bn(v)

    @jax.jit
    def fwd(v, x):
        out = m.apply(v, x, train=False)
        if kind == "seg":
            return m.decode(out[0]), out[1]
        return (m.decode(out),)

    return [np.asarray(o) for o in fwd(v, x)]


def _variant(kind):
    """(cfg, numpy state_dict, port fused model, image size) of a variant."""
    if kind == "seg":
        cfg, imgsz = seg_cfg(NC), 160
        sd = random_state_dict(SegmentationModel(cfg), np.random.default_rng(3))
        return cfg, sd, _fused(SegmentationModel, cfg, sd), imgsz
    if kind == "cls":
        sd = random_state_dict(ClassificationModel("yolov5n", nc=NC), np.random.default_rng(4))
        return "yolov5n", sd, _fused(ClassificationModel, "yolov5n", sd, nc=NC), 128
    cfg = yolov5n_cfg(NC) if kind == "detect" else _leaky_cfg()
    sd = random_detector_weights(cfg, 5)
    return cfg, sd, _fused(DetectionModel, cfg, sd), 160 if kind == "detect" else 128


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _ops(data):
    from yolov5_tpu.onnx import proto

    return [n.op_type for n in proto.parse_model(data).graph.nodes]


# ---------------------------------------------------------------------------
# the wire codec


def test_proto_copy_matches_original():
    """The copy serialises a model to the bytes of the original, and each
    parses the other's (and a converted model's) file to the same fields."""
    from yolov5_tpu.onnx import proto as proto_j

    def build(p):
        w = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
        nodes = [p.node("Conv", ["x", "w"], ["y"], name="c0",
                        attrs={"strides": [1, 1], "pads": [0, 0, 0, 0], "group": 1,
                               "alpha": 0.5, "mode": "nearest", "axis": -1}),
                 p.node("Sigmoid", ["y"], ["out"], name="s0")]
        g = p.graph(nodes, "tiny", [p.value_info("x", p.UINT8, [1, 3, 4, 4])],
                    [p.value_info("out", p.FLOAT, [1, 2, 3, 3])],
                    [p.tensor("w", w), p.tensor("i", np.array([3, -1], np.int64))])
        return p.model(g, opset=13, doc="d", metadata={"stride": "32"})

    a, b = build(proto_t), build(proto_j)
    assert a == b
    for data in (a, b):
        mt, mj = proto_t.parse_model(data), proto_j.parse_model(data)
        assert (mt.opset, mt.ir_version, mt.producer, mt.metadata) == \
            (mj.opset, mj.ir_version, mj.producer, mj.metadata)
        assert [(n.op_type, n.inputs, n.outputs, n.attrs) for n in mt.graph.nodes] == \
            [(n.op_type, n.inputs, n.outputs, n.attrs) for n in mj.graph.nodes]
        for k, v in mj.graph.initializers.items():
            np.testing.assert_array_equal(mt.graph.initializers[k], v)


# ---------------------------------------------------------------------------
# the converter against the JAX package


@pytest.mark.parametrize("kind", ["detect", "seg", "cls", "leaky"])
def test_onnx_matches_jax(kind):
    """The port's .onnx parses with the JAX codec, runs in both runtimes
    within 1e-4 of each output's largest value, and matches the JAX forward
    on the same weights within atol/rtol 2e-3 (tests/test_onnx.py's)."""
    from yolov5_tpu.onnx import proto as proto_j
    from yolov5_tpu.onnx.runtime import Runtime as JaxRuntime

    cfg, sd, model, imgsz = _variant(kind)
    data = to_onnx(export_t.ExportForward(model).eval(),
                   torch.zeros((1, imgsz, imgsz, 3), dtype=torch.uint8), input_names=["images"])
    m = proto_j.parse_model(data)
    assert m.opset == 13 and [n for n, _, _ in m.graph.inputs] == ["images"]
    images = np.random.default_rng(0).integers(0, 256, (1, imgsz, imgsz, 3), dtype=np.uint8)
    port = [o.numpy() for o in Runtime(data, device="cpu")(images)]
    jaxrt = JaxRuntime(data)(images)
    ref = _jax_forward(kind, cfg, sd, images)
    assert len(port) == len(jaxrt) == len(ref) == (2 if kind == "seg" else 1)
    for p, j, r in zip(port, jaxrt, ref):
        _close(j, p, 1e-4)
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, atol=2e-3, rtol=2e-3)
    ops = _ops(data)
    if kind == "detect":
        assert ops.count("Conv") == 60 and ops.count("Resize") == 2
        assert "Expand" not in ops and ops.count("Transpose") <= 4
        # the decode's grids, anchors and strides are folded into initializers:
        # no arange/expand chain is left, only the decode's elementwise ops
        assert set(ops) == {"Cast", "Div", "Transpose", "Conv", "Sigmoid", "Mul", "Add",
                            "Concat", "MaxPool", "Resize", "Reshape", "Slice", "Sub",
                            "Identity"}
    if kind == "leaky":
        assert "GreaterOrEqual" in ops and "Where" in ops


def test_jax_onnx_runs_in_port_runtime():
    """The JAX package's .onnx of the same weights runs in the port's runtime
    within 1e-4 of the JAX runtime's output."""
    from yolov5_tpu.models import DetectionModel as JDet
    from yolov5_tpu.models.weights import fuse_conv_bn, import_torch_weights
    from yolov5_tpu.onnx import to_onnx as jax_to_onnx
    from yolov5_tpu.onnx.runtime import Runtime as JaxRuntime

    cfg = yolov5n_cfg(NC)
    m = JDet(cfg)
    v, _ = import_torch_weights(m, random_detector_weights(cfg, 5))
    fm, fv = JDet(cfg, fused=True), fuse_conv_bn(v)
    data = jax_to_onnx(lambda im: fm.decode(fm.apply(fv, im.astype(jnp.float32) / 255.0,
                                                     train=False)),
                       jnp.zeros((1, 160, 160, 3), jnp.uint8), input_names=["images"])
    images = np.random.default_rng(1).integers(0, 256, (1, 160, 160, 3), dtype=np.uint8)
    _close(Runtime(data, device="cpu")(images)[0].numpy(), JaxRuntime(data)(images)[0], 1e-4)


@pytest.mark.parametrize("name", ["yolov5s-transformer", "yolov5s-ghost", "yolov3-tiny"])
def test_zoo_families_export(name):
    """The attention (addmm, bmm, softmax), ghost (grouped convs) and
    yolov3-tiny (ZeroPad, MaxPool s1) graphs at narrow width through the
    port's runtime match the port's forward within 1e-4 of its largest."""
    cfg = small_cfg(name, nc=NC)
    sd = random_state_dict(DetectionModel(cfg), np.random.default_rng(6))
    fwd = export_t.ExportForward(_fused(DetectionModel, cfg, sd)).eval()
    data = to_onnx(fwd, torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    images = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
    with torch.no_grad():
        ref = fwd(images).numpy()
    _close(Runtime(data, device="cpu")(images)[0].numpy(), ref, 1e-4)
    if name == "yolov5s-transformer":
        assert {"Gemm", "MatMul", "Softmax"} <= set(_ops(data))


class _PoolOfNegatives(torch.nn.Module):
    """A conv whose output is all negative, then SPPF's 5x5 s1 p2 max pool:
    the padding must never win the max (torch pads with -inf)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 1)
        with torch.no_grad():
            self.conv.weight.fill_(0.1)
            self.conv.bias.fill_(-100.0)
        self.pool = torch.nn.MaxPool2d(5, 1, 2)

    def forward(self, x):
        y = self.conv(x.to(torch.float32).permute(0, 3, 1, 2)
                      .contiguous(memory_format=torch.channels_last))
        return torch.cat([y, self.pool(y).clone()], 1)


def test_maxpool_padding_and_clones():
    """A padded max pool over negative values equals torch's in both
    runtimes; ``clone`` and a memory-format copy emit no node."""
    from yolov5_tpu.onnx.runtime import Runtime as JaxRuntime

    m = _PoolOfNegatives().eval()
    data = to_onnx(m, torch.zeros((1, 8, 8, 3), dtype=torch.uint8))
    images = np.random.default_rng(3).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
    with torch.no_grad():
        ref = m(torch.from_numpy(images)).numpy()
    assert ref.max() < 0
    np.testing.assert_allclose(Runtime(data, device="cpu")(images)[0].numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(JaxRuntime(data)(images)[0], ref, atol=1e-6)
    ops = _ops(data)
    assert ops.count("Identity") == 1 and ops[-1] == "Identity"  # the graph output only
    assert sorted(ops) == sorted(["Cast", "Transpose", "Conv", "MaxPool", "Concat", "Identity"])


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x.to(torch.float32) / 64.0 - 2.0)


_SMALL = {
    "relu_hardswish_mish": lambda x: torch.cat([torch.relu(x), torch.nn.functional.hardswish(x),
                                                torch.nn.functional.mish(x)], 1),
    "clamp_where_compare": lambda x: torch.where(x > 0.5, x.clamp(-1.0, 1.5), -x) * (x != 0),
    "split_select": lambda x: torch.cat(list(x.split([1, 2], 3)), 3)[:, :, 1] + x[:, 0],
    "reductions": lambda x: torch.cat([x.mean((1, 2)), x.sum(1).amax(1), x.sum()[None, None]
                                       .expand(x.shape[0], 3)], 1),
    "matmul_softmax": lambda x: torch.softmax(x.flatten(1, 2) @ x.flatten(1, 2).transpose(1, 2),
                                              -1).sum(1),
    "pad_rsqrt_exp": lambda x: torch.nn.functional.pad(torch.rsqrt(x.abs() + 1) * torch.exp(
        -x.abs()), (1, 2, 0, 1), value=0.25),
}


@pytest.mark.parametrize("name", sorted(_SMALL))
def test_small_functions_export(name):
    """The handlers no bundled config reaches (the activations a YAML may
    name, comparisons, splits, reductions, products, padding) through both
    runtimes equal torch's result (tests/test_onnx.py's small-function
    check)."""
    from yolov5_tpu.onnx.runtime import Runtime as JaxRuntime

    m = _Fn(_SMALL[name]).eval()
    data = to_onnx(m, torch.zeros((2, 8, 8, 3), dtype=torch.uint8))
    images = np.random.default_rng(7).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    with torch.no_grad():
        ref = m(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(Runtime(data, device="cpu")(images)[0].numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(JaxRuntime(data)(images)[0], ref, rtol=1e-5, atol=1e-5)


def test_unsupported_op_raises_by_name():
    class Cumsum(torch.nn.Module):
        def forward(self, x):
            return x.float().cumsum(1)

    with pytest.raises(UnsupportedOp, match="cumsum"):
        to_onnx(Cumsum(), torch.zeros((1, 4), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# the export run


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """export.run of the port (ckpt, pt2, onnx) from a JAX .ckpt of yolov5n,
    at 64 px, b2, on the CPU."""
    from torch_port_helpers import save_jax_checkpoint

    root = tmp_path_factory.mktemp("export")
    w = save_jax_checkpoint(yolov5n_cfg(NC), root / "w.ckpt")
    arts = export_t.run(weights=str(w), imgsz=64, batch_size=2,
                        include=("ckpt", "pt2", "onnx"), output_dir=str(root), device="cpu")
    return w, arts


def test_export_run_writes_formats(exported):
    w, arts = exported
    assert set(arts) == {"ckpt", "pt2", "onnx"} and all(arts.values())
    assert arts["ckpt"].name == "w.fused.ckpt" and arts["pt2"].name == "w.pt2"
    meta = json.loads((arts["pt2"].parent / "w.pt2.json").read_text())
    assert meta["imgsz"] == 64 and meta["nc"] == NC and meta["format"] == "yolov5_tpu-export"
    from yolov5_tpu.onnx import proto

    m = proto.parse_model(arts["onnx"].read_bytes())
    assert json.loads(m.metadata["names"]) == {str(i): f"class{i}" for i in range(NC)}
    assert m.graph.inputs[0][1:] == (proto.UINT8, [2, 64, 64, 3])


def test_pt2_loads_with_torch_export(exported):
    """The .pt2 loads with torch.export.load alone; its module gives the
    traced forward's output exactly."""
    _, arts = exported
    fwd, example, _, _ = export_t._build_forward(str(exported[0]), "yolov5s", 64, 2)
    images = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    with torch.no_grad():
        ref = fwd(images)
        got = torch.export.load(str(arts["pt2"])).module()(images)
    assert torch.equal(got, ref)


def test_fused_ckpt_cross_package(exported, tmp_path):
    """The port's fused .ckpt loads in both packages' Detector, and so does
    the JAX export's of the same weights; each gives the port forward's
    predictions within 1e-5 of their largest value."""
    from yolov5_tpu.export import run as jax_export
    from yolov5_tpu.infer import Detector as JaxDetector
    from yolov5_tpu_torch.infer import Detector

    w, arts = exported
    jax_arts = jax_export(weights=str(w), imgsz=64, include=("ckpt",), output_dir=str(tmp_path))
    images = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    fwd, _, _, _ = export_t._build_forward(str(w), "yolov5s", 64, 2)
    with torch.no_grad():
        ref = fwd(torch.from_numpy(images)).numpy()
    jds = [JaxDetector(str(ckpt), imgsz=64) for ckpt in (arts["ckpt"], jax_arts["ckpt"])]
    model = jds[0].model  # one compiled forward for both files' variables
    jfwd = jax.jit(lambda v, x: model.decode(model.module.apply(
        v, x.astype(jnp.float32) / 255.0, train=False)))
    for ckpt, jd in zip((arts["ckpt"], jax_arts["ckpt"]), jds):
        got = Detector(str(ckpt), imgsz=64, device="cpu").forward(images).numpy()
        _close(got, ref, 1e-5)
        _close(np.asarray(jfwd(jd.variables, jnp.asarray(images))), ref, 1e-5)


def test_export_formats_and_nms(tmp_path, capsys):
    """The format table (the TensorFlow formats where TensorFlow is
    installed); --nms fails for onnx in the port (named ROADMAP) as the JAX
    package's onnx --nms fails (no sort lowering), the pt2 and TF graphs
    hold it (as the JAX stablehlo and TF graphs do), and the other formats
    go on."""
    import importlib.util

    from yolov5_tpu.export import run as jax_export

    has_tf = importlib.util.find_spec("tensorflow") is not None
    table = {n: (suffix, ok) for n, suffix, ok, _ in export_t.export_formats()}
    tf_formats = {"saved_model", "pb", "tflite"}
    assert {n for n, (_, ok) in table.items() if ok} == (
        {"ckpt", "pt2", "onnx"} | (tf_formats if has_tf else set()))
    assert table["pt2"][0] == ".pt2" and "stablehlo" not in table
    arts = export_t.run(cfg="yolov5n", imgsz=64, include=("ckpt", "pt2", "onnx", "tflite"),
                        with_nms=True, output_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert arts["ckpt"] and arts["pt2"] and arts["onnx"] is None
    assert "ROADMAP" in out  # the onnx --nms
    if has_tf:  # the tflite file holds the NMS
        assert arts["tflite"] == tmp_path / "yolov5n.tflite" and arts["tflite"].exists()
    else:
        assert "skipping tflite: tensorflow not installed" in out
    jax_arts = jax_export(cfg="yolov5n", imgsz=64, include=("onnx",), with_nms=True,
                          output_dir=str(tmp_path / "jax"))
    assert jax_arts["onnx"] is None


def test_export_cli(tmp_path, capsys):
    """The CLI writes the .onnx; --int8 without tflite in --include changes
    nothing and prints no skip, and the f32 formats go on (int8 TFLite
    itself: tests/test_torch_tf_export.py)."""
    arts = export_t.main(["--cfg", "yolov5n", "--imgsz", "64", "--include", "onnx", "--int8",
                          "--output-dir", str(tmp_path), "--device", "cpu"])
    assert arts["onnx"] == tmp_path / "yolov5n.onnx" and arts["onnx"].exists()
    assert set(arts) == {"onnx"} and "skipping" not in capsys.readouterr().out
    if not torch.cuda.is_available():  # the check runs on the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_t.main(["--cfg", "yolov5n", "--imgsz", "64", "--include", "onnx",
                           "--output-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the NMS that an --nms graph holds


def _nms_predictions(rng, bs=2, n=3000, nc=NC):
    """Decoded predictions whose boxes crowd around 60 centres, with most
    scores above the export's conf 0.25: the 1024 cap and max_det 100 both
    cut, and suppression has work to do."""
    centres = rng.uniform(40, 600, (60, 2))
    xy = centres[rng.integers(0, 60, (bs, n))] + rng.normal(0, 6, (bs, n, 2))
    wh = rng.uniform(10, 60, (bs, n, 2))
    obj = rng.uniform(0.3, 1.0, (bs, n, 1))
    cls = rng.uniform(0.0, 1.0, (bs, n, nc))
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_traceable_nms_matches_port_and_jax(seed):
    """non_max_suppression(traceable=True) at the export's settings equals
    the port's NMS (greedy through K1's plain version) exactly, and the JAX
    non_max_suppression(max_nms=1024) in valid counts and in boxes within
    1e-4."""
    from yolov5_tpu.ops.nms import non_max_suppression as jax_nms
    from yolov5_tpu_torch.ops.nms import non_max_suppression

    pred = _nms_predictions(np.random.default_rng(seed))
    got = non_max_suppression(torch.from_numpy(pred), **export_t.EXPORT_NMS, traceable=True)
    ref = non_max_suppression(torch.from_numpy(pred), **export_t.EXPORT_NMS)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert got.classes.dtype == torch.int32 and int(got.valid.sum()) == 200  # max_det cuts
    jref = jax_nms(jnp.asarray(pred), **export_t.EXPORT_NMS)
    assert_same_detection_sets(got, jref, atol=1e-4)


def test_pt2_with_nms_loads_and_matches(tmp_path):
    """export --include pt2 --nms: the graph, loaded with torch.export.load
    alone, gives (boxes f32 (bs, 100, 4), scores, classes int32, valid) equal
    to the port's NMS of the traced forward at the export's settings, and
    to the JAX non_max_suppression(max_nms=1024) in valid counts and boxes
    within 1e-4."""
    from yolov5_tpu.ops.nms import non_max_suppression as jax_nms
    from yolov5_tpu_torch.ops.nms import non_max_suppression

    rng = np.random.default_rng(11)
    sd = {k: torch.from_numpy(v) for k, v in random_detector_weights(yolov5n_cfg(NC), 3).items()}
    for i in range(3):  # scores above conf 0.25 in most cells
        sd[f"model.24.m.{i}.bias"] = torch.from_numpy(
            rng.normal(1.5, 0.5, sd[f"model.24.m.{i}.bias"].shape).astype(np.float32))
    arts = export_t.run(weights=sd, cfg=yolov5n_cfg(NC), imgsz=64, batch_size=2,
                        include=("pt2",), with_nms=True, output_dir=str(tmp_path), name="nms",
                        device="cpu")
    assert json.loads((tmp_path / "nms.pt2.json").read_text())["with_nms"] is True
    fwd, _, _, _ = export_t._build_forward(sd, yolov5n_cfg(NC), 64, 2)
    images = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    with torch.no_grad():
        pred = fwd(images)
        got = torch.export.load(str(arts["pt2"])).module()(images)
    ref = non_max_suppression(pred, **export_t.EXPORT_NMS)
    assert [tuple(g.shape) for g in got] == [(2, 100, 4), (2, 100), (2, 100), (2, 100)]
    assert [g.dtype for g in got] == [torch.float32, torch.float32, torch.int32, torch.bool]
    for g, r in zip(got, (ref.boxes, ref.scores, ref.classes, ref.valid)):
        assert torch.equal(g, r)
    assert int(got[3].sum()) > 0
    jref = jax_nms(jnp.asarray(pred.numpy()), **export_t.EXPORT_NMS)
    assert_same_detection_sets(ref, jref, atol=1e-4)
