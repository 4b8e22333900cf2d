"""The port's TensorFlow exports (saved_model, pb, tflite, int8 tflite,
--nms) and their converter ``onnx/to_tf.py``, against the port's own forward
and ONNX runtime and against the JAX package's TF exports of the same
checkpoint. yolov5n at 64 px, 3 classes, b1, on the CPU; every export is
made once, in the module fixture."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (assert_same_rows, random_detector_weights,
                                      save_jax_checkpoint, seg_cfg, small_cfg, yolov5n_cfg)
from yolov5_tpu_torch import export as export_t
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.onnx import proto
from yolov5_tpu_torch.onnx.convert import UnsupportedOp, to_onnx
from yolov5_tpu_torch.onnx.runtime import Runtime
from yolov5_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression

tf = pytest.importorskip("tensorflow")
from yolov5_tpu_torch.onnx.to_tf import non_max_suppression_tf, to_tf  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
IMGSZ, NC, CONF = 64, 3, 0.25
FORMATS = ("saved_model", "pb", "tflite")


# ---------------------------------------------------------------------------
# each op of the runtime's table through to_tf


def _graph(nodes, inputs, outputs, inits):
    """ONNX bytes of a graph: nodes as (op, inputs, outputs, attrs), inputs
    {name: array} fed at call time, inits {name: array} as initializers."""
    g = proto.graph([proto.node(op, i, o, attrs=a) for op, i, o, a in nodes], "g",
                    [proto.value_info(k, proto.onnx_dtype(v.dtype), v.shape)
                     for k, v in inputs.items()],
                    [proto.value_info(o, proto.FLOAT, []) for o in outputs],
                    [proto.tensor(k, v) for k, v in inits.items()])
    return proto.model(g)


def _i64(*v):
    return np.array(v, np.int64)


_RNG = np.random.default_rng(0)
_X = _RNG.normal(size=(2, 4, 6, 6)).astype(np.float32)
_Y = _RNG.normal(size=(2, 4, 6, 6)).astype(np.float32)
_W = _RNG.normal(size=(4, 4, 1, 1)).astype(np.float32)
# op -> (nodes on "x" (and "y") giving "out", initializers)
OP_CASES = {
    **{op: ([(op, ["x", "y"], ["out"], {})], {}) for op in
       ("Add", "Sub", "Mul", "Div", "Max", "Min")},
    "Pow": ([("Abs", ["x"], ["a"], {}), ("Pow", ["a", "p"], ["out"], {})],
            {"p": np.float32(1.5).reshape(())}),
    **{op: ([(op, ["x", "y"], ["b"], {}), ("Cast", ["b"], ["out"], {"to": proto.FLOAT})], {})
       for op in ("Greater", "GreaterOrEqual", "Less", "LessOrEqual", "Equal")},
    **{op: ([("Greater", ["x", "z"], ["b1"], {}), ("Greater", ["y", "z"], ["b2"], {}),
             (op, ["b1", "b2"], ["b"], {}), ("Cast", ["b"], ["out"], {"to": proto.FLOAT})],
            {"z": np.zeros((), np.float32)}) for op in ("And", "Or", "Xor")},
    "Not": ([("Greater", ["x", "z"], ["b"], {}), ("Not", ["b"], ["n"], {}),
             ("Cast", ["n"], ["out"], {"to": proto.FLOAT})], {"z": np.zeros((), np.float32)}),
    **{op: ([(op, ["x"], ["out"], {})], {}) for op in
       ("Sigmoid", "Exp", "Tanh", "Neg", "Abs", "Floor", "Ceil", "Sign", "Identity")},
    **{op: ([("Abs", ["x"], ["a"], {}), ("Add", ["a", "one"], ["b"], {}),
             (op, ["b"], ["out"], {})], {"one": np.ones((), np.float32)})
       for op in ("Sqrt", "Reciprocal", "Log")},
    "Conv": ([("Conv", ["x", "w3", "b3"], ["out"],
               {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1], "strides": [2, 2]})],
             {"w3": _RNG.normal(size=(5, 4, 3, 3)).astype(np.float32),
              "b3": _RNG.normal(size=(5,)).astype(np.float32)}),
    "Conv-asym-pad": ([("Conv", ["x", "w3"], ["out"],
                        {"kernel_shape": [3, 3], "pads": [0, 1, 2, 1]})],
                      {"w3": _RNG.normal(size=(3, 4, 3, 3)).astype(np.float32)}),
    "Conv-depthwise": ([("Conv", ["x", "wd"], ["out"],
                         {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1], "group": 4})],
                       {"wd": _RNG.normal(size=(8, 1, 3, 3)).astype(np.float32)}),
    "Conv-groups": ([("Conv", ["x", "wg"], ["out"], {"kernel_shape": [1, 1], "group": 2})],
                    {"wg": _RNG.normal(size=(6, 2, 1, 1)).astype(np.float32)}),
    "MaxPool": ([("MaxPool", ["x"], ["out"],
                  {"kernel_shape": [5, 5], "strides": [1, 1], "pads": [2, 2, 2, 2]})], {}),
    "Resize": ([("Resize", ["x", "", "sc"], ["out"],
                 {"mode": "nearest", "coordinate_transformation_mode": "asymmetric",
                  "nearest_mode": "floor"})], {"sc": np.array([1, 1, 2, 2], np.float32)}),
    "Where": ([("Greater", ["x", "y"], ["c"], {}), ("Where", ["c", "x", "y"], ["out"], {})], {}),
    "Cast": ([("Cast", ["x"], ["i"], {"to": proto.INT32}),
              ("Cast", ["i"], ["out"], {"to": proto.FLOAT})], {}),
    "Concat": ([("Concat", ["x", "y", "x"], ["out"], {"axis": 1})], {}),
    "Reshape": ([("Reshape", ["x", "sh"], ["out"], {})], {"sh": _i64(0, 4, -1)}),
    "Transpose": ([("Transpose", ["x"], ["out"], {"perm": [0, 2, 3, 1]})], {}),
    "Transpose-other": ([("Transpose", ["x"], ["out"], {"perm": [3, 1, 0, 2]})], {}),
    "Slice": ([("Slice", ["x", "st", "en", "ax", "sp"], ["out"], {})],
              {"st": _i64(1, 1, -5), "en": _i64(np.iinfo(np.int64).max, 3, 6),
               "ax": _i64(1, 2, 3), "sp": _i64(1, 1, 2)}),
    "Pad": ([("Pad", ["x", "pd", "pv"], ["out"], {"mode": "constant"})],
            {"pd": _i64(0, 1, 2, 0, 0, 0, 1, 3), "pv": np.float32(0.5).reshape(())}),
    "Expand": ([("ReduceMax", ["x"], ["m"], {"axes": [2], "keepdims": 1}),
                ("Expand", ["m", "es"], ["out"], {})], {"es": _i64(2, 4, 5, 6)}),
    "MatMul": ([("Reshape", ["x", "s2"], ["a"], {}), ("Reshape", ["y", "s3"], ["b"], {}),
                ("MatMul", ["a", "b"], ["out"], {})], {"s2": _i64(8, 36), "s3": _i64(36, 8)}),
    "Gemm": ([("Reshape", ["x", "s2"], ["a"], {}), ("Reshape", ["y", "s2"], ["b"], {}),
              ("Gemm", ["a", "b", "gc"], ["out"], {"transB": 1, "alpha": 0.5, "beta": 2.0})],
             {"s2": _i64(8, 36), "gc": _RNG.normal(size=(8,)).astype(np.float32)}),
    "ReduceSum": ([("ReduceSum", ["x", "rx"], ["out"], {"keepdims": 1})], {"rx": _i64(2, 3)}),
    "ReduceSum-drop": ([("ReduceSum", ["x", "rx"], ["out"], {"keepdims": 0})],
                       {"rx": _i64(1)}),
    "ReduceMax": ([("ReduceMax", ["x"], ["out"], {"axes": [1], "keepdims": 1})], {}),
    "ReduceMin": ([("ReduceMin", ["x"], ["out"], {"axes": [-1], "keepdims": 0})], {}),
    "ReduceProd": ([("ReduceProd", ["x"], ["out"], {"axes": [1, 3], "keepdims": 1})], {}),
    "Softmax": ([("Softmax", ["x"], ["out"], {"axis": 1})], {}),
    "Clip": ([("Clip", ["x", "lo", "hi"], ["out"], {})],
             {"lo": np.float32(-0.5).reshape(()), "hi": np.float32(0.7).reshape(())}),
    "BatchNormalization": ([("BatchNormalization", ["x", "g", "b", "mu", "var"], ["out"],
                             {"epsilon": 1e-3})],
                           {"g": _RNG.normal(size=4).astype(np.float32),
                            "b": _RNG.normal(size=4).astype(np.float32),
                            "mu": _RNG.normal(size=4).astype(np.float32),
                            "var": _RNG.uniform(0.5, 2, 4).astype(np.float32)}),
}


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_runtime(case, layout):
    """One op (with the few ops that make its inputs) through to_tf and
    through onnx/runtime.py on the same inputs, within 1e-5. In the "nhwc"
    cases x and y first pass a 1x1 Conv, so the op sees values that to_tf
    carries NHWC."""
    nodes, inits = OP_CASES[case]
    inits = dict(inits)
    if layout == "nhwc":
        inits["w1"] = _W
        nodes = [("Conv", ["x0", "w1"], ["x"], {"kernel_shape": [1, 1]}),
                 ("Conv", ["y0", "w1"], ["y"], {"kernel_shape": [1, 1]})] + nodes
        feeds = {"x0": _X, "y0": _Y}
    else:
        feeds = {"x": _X, "y": _Y}
    data = _graph(nodes, feeds, ["out"], inits)
    ref = Runtime(data, device="cpu")(*[torch.from_numpy(v) for v in feeds.values()])[0]
    got = to_tf(data)(*[tf.constant(v) for v in feeds.values()]).numpy()
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, rtol=1e-5)


def test_unsupported_op_raises_by_name():
    data = _graph([("Einsum", ["x", "y"], ["out"], {"equation": "ij,jk->ik"})],
                  {"x": _X, "y": _Y}, ["out"], {})
    with pytest.raises(UnsupportedOp, match="'Einsum'"):
        to_tf(data)


# ---------------------------------------------------------------------------
# the exports of one checkpoint


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """A JAX .ckpt of yolov5n (3 classes) and its exports at 64 px b1: the
    port's and the JAX package's saved_model, pb and tflite, the port's int8
    tflite and both packages' --nms saved_models."""
    from yolov5_tpu.export import run as jax_export

    root = tmp_path_factory.mktemp("tf_exports")
    w = save_jax_checkpoint(yolov5n_cfg(NC), root / "w.ckpt", weights=random_detector_weights)
    kw = dict(weights=str(w), imgsz=IMGSZ, include=FORMATS)
    port = export_t.run(**kw, output_dir=str(root / "port"), device="cpu")
    jax = jax_export(**kw, output_dir=str(root / "jax"))
    int8 = export_t.run(weights=str(w), imgsz=IMGSZ, include=("tflite",), int8=True,
                        output_dir=str(root / "int8"), device="cpu")
    nms = export_t.run(weights=str(w), imgsz=IMGSZ, include=("saved_model",), with_nms=True,
                       output_dir=str(root / "nms"), device="cpu")
    jax_nms = jax_export(weights=str(w), imgsz=IMGSZ, include=("saved_model",), with_nms=True,
                         output_dir=str(root / "jax_nms"))
    return {"ckpt": w, "port": port, "jax": jax, "int8": int8["tflite"],
            "nms": nms["saved_model"], "jax_nms": jax_nms["saved_model"]}


def _images(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, IMGSZ, IMGSZ, 3), dtype=np.uint8)


def _rows(det, images):
    return detections_to_numpy(det(images, conf_thres=CONF))


def test_artifacts_and_meta(exports):
    """The JAX package's artifact names and meta files."""
    port, jax = exports["port"], exports["jax"]
    assert {k: Path(v).name for k, v in port.items()} == {k: Path(v).name for k, v in jax.items()}
    metas = {"saved_model": Path(port["saved_model"]) / "yolov5_tpu_meta.json",
             "pb": Path(str(port["pb"]) + ".json"), "tflite": Path(str(port["tflite"]) + ".json")}
    for fmt, path in metas.items():
        meta = json.loads(path.read_text())
        assert (meta["nc"], meta["imgsz"], meta["format"]) == (NC, IMGSZ, "yolov5_tpu-export")
    assert Path(exports["int8"]).name == "w-int8.tflite"
    assert json.loads(Path(str(exports["int8"]) + ".json").read_text())["normalized"] is True
    assert (Path(exports["int8"]).parent / "w_saved_model_int8").is_dir()
    sig = tf.saved_model.load(str(port["saved_model"])).f.concrete_functions[0]
    spec = sig.structured_input_signature[0][0]
    assert (spec.name, spec.dtype, tuple(spec.shape)) == ("images", tf.uint8, (1, IMGSZ, IMGSZ, 3))


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_export_matches_port_forward(exports, fmt):
    """The port's Detector on each export against its forward of the .ckpt,
    within 1e-3 (atol and rtol), and the same detection rows."""
    images = _images()
    ref_det = Detector(str(exports["ckpt"]), imgsz=IMGSZ, device="cpu")
    det = Detector(str(exports["port"][fmt]), device="cpu")
    assert (det.backend, det.imgsz, det.nc) == (fmt, IMGSZ, NC)
    got, ref = det.forward(images).numpy(), ref_det.forward(images).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    assert sum(map(len, _rows(ref_det, images))) > 0
    assert_same_rows(_rows(det, images), _rows(ref_det, images), atol=1e-3)


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_export_matches_jax_export(exports, fmt):
    """The port's and the JAX package's file of each format, each in its
    own package's Detector, and each package's Detector on the other's file:
    forwards within 1e-3, the same detection rows."""
    from yolov5_tpu.infer import Detector as JaxDetector
    from yolov5_tpu.ops.nms import detections_to_numpy as jax_to_numpy

    images = _images(1)
    port_file, jax_file = str(exports["port"][fmt]), str(exports["jax"][fmt])
    det, jdet = Detector(port_file, device="cpu"), JaxDetector(jax_file)
    ref = np.asarray(jdet._forward(None, images))
    np.testing.assert_allclose(det.forward(images).numpy(), ref, atol=1e-3, rtol=1e-3)
    ref_rows = jax_to_numpy(jdet(images, conf_thres=CONF))
    assert sum(map(len, ref_rows)) > 0
    assert_same_rows(_rows(det, images), ref_rows, atol=1e-3)
    # each package's Detector on the other's file
    jdet_port = JaxDetector(port_file)
    assert (jdet_port.backend, jdet_port.nc) == (fmt, NC)
    np.testing.assert_allclose(np.asarray(jdet_port._forward(None, images)), ref,
                               atol=1e-3, rtol=1e-3)
    det_jax = Detector(jax_file, device="cpu")
    np.testing.assert_allclose(det_jax.forward(images).numpy(), ref, atol=1e-3, rtol=1e-3)


def test_int8_tflite(exports):
    """int8: boxes back in pixels and the objectness correlated with the
    float forward (tests/test_api.py:319-345)."""
    images = _images()
    ref = Detector(str(exports["ckpt"]), imgsz=IMGSZ, device="cpu").forward(images).numpy()
    det = Detector(str(exports["int8"]), device="cpu")
    out = det.forward(images).numpy()
    assert out.shape == ref.shape
    assert float(out[..., :4].max()) > 2.0, "boxes still normalized: rescale lost"
    assert float(np.corrcoef(out[..., 4].ravel(), ref[..., 4].ravel())[0, 1]) > 0.9


def _nms_outputs(path, images):
    out = tf.saved_model.load(str(path)).f(tf.constant(images))
    return [np.asarray(o) for o in out]


def _assert_same_nms(got, ref, box_atol=1e-4):
    boxes, scores, classes, valid = got
    np.testing.assert_array_equal(valid, ref[3])
    np.testing.assert_array_equal(classes, ref[2])
    np.testing.assert_allclose(scores, ref[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(boxes, ref[0], atol=box_atol, rtol=1e-6)
    assert (boxes.dtype, classes.dtype, valid.dtype) == (np.float32, np.int32, np.bool_)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_saved_model(exports, seed):
    """--nms: the saved_model's four outputs against the port's traceable
    NMS on its fp32 saved_model's predictions (the same TF forward; boxes
    within 1e-4), and against the JAX package's --nms saved_model, whose
    forward is another graph: boxes within the forwards' 1e-3 there."""
    images = _images(seed)
    got = _nms_outputs(exports["nms"], images)
    assert got[3].sum() > 0
    pred = tf.saved_model.load(str(exports["port"]["saved_model"])).f(tf.constant(images))
    d = non_max_suppression(torch.from_numpy(np.array(pred)), **export_t.EXPORT_NMS,
                            traceable=True)
    _assert_same_nms(got, [t.numpy() for t in (d.boxes, d.scores, d.classes, d.valid)])
    _assert_same_nms(got, _nms_outputs(exports["jax_nms"], images), box_atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_tf_matches_traceable(seed):
    """non_max_suppression_tf alone on random predictions with ties and
    many overlaps, against the port's traceable NMS, at a cap below N."""
    rng = np.random.default_rng(seed)
    n = 600
    pred = np.concatenate([rng.uniform(0, 64, (2, n, 2)), rng.uniform(2, 30, (2, n, 2)),
                           rng.choice([0.3, 0.5, 0.9, 1.0], (2, n, 1)),
                           rng.choice([0.1, 0.6, 0.8], (2, n, NC))], -1).astype(np.float32)
    kw = dict(export_t.EXPORT_NMS, max_nms=512)
    got = [np.asarray(t) for t in non_max_suppression_tf(tf.constant(pred), **kw)]
    d = non_max_suppression(torch.from_numpy(pred), **kw, traceable=True)
    ref = [t.numpy() for t in (d.boxes, d.scores, d.classes, d.valid)]
    assert ref[3].sum() > 20
    _assert_same_nms(got, ref)


def _to_tf_vs_runtime(model, imgsz, seed=3):
    """A model's ExportForward as ONNX, through to_tf and the runtime."""
    data = to_onnx(export_t.ExportForward(model.float().eval()).eval(),
                   torch.zeros((1, imgsz, imgsz, 3), dtype=torch.uint8))
    images = np.random.default_rng(seed).integers(0, 256, (1, imgsz, imgsz, 3), dtype=np.uint8)
    ref = Runtime(data, device="cpu")(torch.from_numpy(images))
    got = to_tf(data)(tf.constant(images))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * max(1.0, np.abs(r).max()), rtol=0)
    return data


@pytest.mark.parametrize("kind", ["segment", "classify", "ghost"])
def test_other_models_through_to_tf(kind):
    """A segmentation model (predictions and prototypes), a classifier and
    yolov5s-ghost (depthwise convs) through to_tf, against the runtime."""
    from yolov5_tpu_torch.models.yolo import ClassificationModel, DetectionModel, SegmentationModel

    torch.manual_seed(0)
    if kind == "segment":
        model = SegmentationModel(small_cfg(seg_cfg(NC)), fused=True)
    elif kind == "classify":
        model = ClassificationModel(small_cfg("yolov5n"), nc=NC, fused=True)
    else:
        model = DetectionModel(small_cfg("yolov5s-ghost"), fused=True)
    _to_tf_vs_runtime(model, IMGSZ)


def test_yolov5n_graph_transposes(exports):
    """The port's yolov5n SavedModel holds at most one Transpose per Detect
    level beyond the input's (it holds none: both cancel against the NHWC
    layout that to_tf carries), one Conv2D per conv of the model."""
    from yolov5_tpu_torch.models.yolo import DetectionModel

    fn = tf.saved_model.load(str(exports["port"]["saved_model"])).f
    ops = [op.type for op in fn.concrete_functions[0].graph.get_operations()]
    model = DetectionModel(yolov5n_cfg(NC), fused=True)
    assert ops.count("Conv2D") == sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert ops.count("Transpose") <= len(model.stride)


_IMPORTS = """
import sys
from yolov5_tpu_torch import export
export.export_formats()
print(sorted(m for m in ("tensorflow", "jax") if m in sys.modules))
arts = export.run(cfg=sys.argv[1], imgsz=64, include=("saved_model",), output_dir=sys.argv[2],
                  name="m", device="cpu")
assert arts["saved_model"], arts
print(sorted(m for m in sys.modules if m.startswith("yolov5_tpu") and
             not m.startswith("yolov5_tpu_torch")))
"""


def test_tf_imported_only_by_the_exporters(tmp_path):
    """In a fresh process: importing the exporter and export_formats() load
    neither TensorFlow nor JAX, and a TF export loads no yolov5_tpu module
    (TensorFlow itself may load JAX)."""
    import yaml

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(small_cfg("yolov5n")))
    proc = subprocess.run([sys.executable, "-c", _IMPORTS, str(cfg), str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "[]" and lines[-1] == "[]", lines
