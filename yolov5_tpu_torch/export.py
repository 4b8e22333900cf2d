"""Model export, the port of ``yolov5_tpu/export.py``.

| format      | artifact                                       | via                        |
|-------------|------------------------------------------------|----------------------------|
| ckpt        | ``.fused.ckpt`` (BN folded), ``.json`` meta     | the port's msgpack writer  |
| pt2         | ``.pt2`` program, ``.pt2.json`` meta            | ``torch.export.save``      |
| onnx        | ``.onnx`` (opset 13, NCHW graph)               | ``yolov5_tpu_torch.onnx``  |
| saved_model | ``_saved_model/``, ``yolov5_tpu_meta.json`` in it | the ONNX graph as TF ops |
| pb          | ``.pb`` frozen GraphDef, ``.pb.json`` meta      | the same TF function       |
| tflite      | ``.tflite`` or ``-int8.tflite``, ``.json`` meta | ``TFLiteConverter``        |

``pt2`` takes the place of the JAX package's ``stablehlo``: the framework's
own serialised program, loadable with ``torch.export.load`` and nothing of
this package. The ONNX file is emitted by the port's own converter (no
``onnx`` package is needed). The TensorFlow formats are built from that
ONNX graph (``onnx/to_tf.py``: NHWC TF ops, the initializers as constants)
as a ``tf.Module`` whose ``f`` takes ``TensorSpec(shape, tf.uint8,
name="images")``, the JAX package's jax2tf artifacts' signature, so that
each package's ``Detector`` runs the other's files. An ``--int8`` TFLite
file is calibrated on up to 100 letterboxed train images of ``--data``
(else 8 seeded random batches) and converted from a graph whose boxes are
divided by the image size (``normalize_boxes``; its meta says
``"normalized": true``). TensorFlow is imported by these exporters only:
``export_formats()`` looks for it without importing it. TensorRT, CoreML,
OpenVINO and Paddle need toolchains that are not installed:
``export_formats()`` reports each as unavailable with its reason.

The exported forward takes a uint8 (bs, s, s, 3) RGB batch and gives the
decoded (bs, N, 5 + nc) float32 predictions. It is traced from the
BN-folded float32 model on the host, so the stem is the plain Conv + SiLU
(the JAX export's ``packed_stem=False`` graph): the artifact has no device,
and what runs it (``infer.Detector`` on ``--device``) runs it on the card.
With ``--nms`` the pt2 graph also holds the NMS at the JAX export's settings
(conf 0.25, IoU 0.45, max_det 100, 1024 candidates; torch ops, not kernel
K1) and gives (boxes (bs, 100, 4) float32, scores (bs, 100), classes
(bs, 100) int32, valid (bs, 100) bool). The ONNX graph cannot hold it, so
a TF export composes the ONNX forward with the same NMS in TF ops
(``onnx.to_tf.non_max_suppression_tf``).

    python -m yolov5_tpu_torch.export --weights best.ckpt --include ckpt pt2 onnx
    python -m yolov5_tpu_torch.export --weights best.ckpt --include saved_model pb tflite
    python -m yolov5_tpu_torch.export --weights best.ckpt --include tflite --int8 --data d.yaml
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

_NO_NMS = ("--nms: the onnx graph cannot hold the NMS (no sort or loop lowering; the JAX "
           "package's onnx --nms fails too): see ROADMAP")
# the NMS of an --nms graph: the JAX export's settings (yolov5_tpu/export.py)
EXPORT_NMS = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, max_nms=1024)


def export_formats():
    """Format table: (name, suffix, available, note). TensorFlow is looked
    for, not imported: importing it loads JAX where JAX is installed."""
    tf_ok = importlib.util.find_spec("tensorflow") is not None
    tf_note = "" if tf_ok else "tensorflow not installed"
    return [
        ("ckpt", ".ckpt", True, "inference checkpoint (BN folded), the JAX package's layout"),
        ("pt2", ".pt2", True, "torch.export program (torch.export.save)"),
        ("saved_model", "_saved_model", tf_ok, tf_note or "the ONNX graph as TF ops"),
        ("pb", ".pb", tf_ok, tf_note or "frozen GraphDef"),
        ("tflite", ".tflite", tf_ok, tf_note or "fp32/int8"),
        ("onnx", ".onnx", True, "torch.export -> ONNX emitter (opset 13)"),
        ("engine", ".engine", False, "TensorRT is not installed"),
        ("coreml", ".mlmodel", False, "coremltools is not installed"),
        ("openvino", "_openvino_model", False, "openvino is not installed"),
        ("paddle", "_paddle_model", False, "paddle is not installed"),
    ]


def try_export(fn):
    """Report one format's failure and go on (reference export.py:182):
    the wrapped exporter returns its artifact's path, or None after printing
    why it failed; success prints the size and the seconds."""

    def wrapper(*args, **kwargs):
        name = fn.__name__.replace("export_", "")
        t0 = time.time()
        try:
            out = fn(*args, **kwargs)
            p = Path(out)
            size = (sum(f.stat().st_size for f in p.rglob("*")) if p.is_dir()
                    else p.stat().st_size) / 1e6
            print(f"export {name}: ok, {out} ({size:.1f} MB, {time.time() - t0:.1f}s)")
            return out
        except Exception as e:
            print(f"export {name}: FAILED after {time.time() - t0:.1f}s: {e}")
            return None

    return wrapper


class ExportForward(nn.Module):
    """uint8 (bs, s, s, 3) RGB -> what the model gives, decoded: (bs, N, no)
    float32 predictions (with a Segment head also the (bs, hm, wm, nm)
    prototypes; a classifier's (bs, nc) logits as they are). With
    ``with_nms`` a detector's predictions go through the traceable NMS at
    ``EXPORT_NMS``: (boxes, scores, classes int32, valid).

    ``normalize_boxes`` (the image size) divides each level's anchors and
    stride by it inside the decode, so that every output channel lies in
    ~[0, 1], as int8 quantization needs: per-tensor scales cannot hold pixel
    boxes and confidences in one tensor, and a divide after the levels'
    concatenation leaves a pixel-range tensor pinned to a 0-1 scale, which
    saturates the boxes (the JAX export's ``normalize_boxes``,
    yolov5_tpu/export.py:99-111; the reference's TFDetect divides for the
    same reason)."""

    def __init__(self, model, with_nms=False, normalize_boxes=None):
        super().__init__()
        self.model = model
        self.with_nms = with_nms
        self.decodes = hasattr(model, "anchors")
        if self.decodes:
            scale = float(normalize_boxes or 1.0)
            self.strides = [float(s) / scale for s in model.stride]
            for i, a in enumerate(model.anchors):
                self.register_buffer(f"anchors_{i}",
                                     torch.tensor(a, dtype=torch.float32) / scale,
                                     persistent=False)

    def forward(self, images):
        from yolov5_tpu_torch.models.layers import decode

        x = (images.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
        out = self.model(x)
        if not self.decodes:
            return out
        maps, proto = out if isinstance(out, tuple) else (out, None)
        anchors = [getattr(self, f"anchors_{i}") for i in range(len(self.strides))]
        pred = decode(maps, anchors, self.strides, torch.float32, nc=self.model.nc)
        if self.with_nms:
            from yolov5_tpu_torch.ops.nms import non_max_suppression

            d = non_max_suppression(pred, **EXPORT_NMS, traceable=True)
            return d.boxes, d.scores, d.classes, d.valid
        return pred if proto is None else (pred, proto)


def _build_forward(weights, cfg, imgsz, batch_size, seed=0, with_nms=False):
    """(forward, example input, model, names): the BN-folded float32 model
    on the host, wrapped in ExportForward (with the NMS for ``with_nms``),
    and a zero uint8 batch.

    ``weights`` as ``infer.Detector`` takes them: None or "" (seeded random),
    a .pt or .ckpt path, or a state_dict."""
    from yolov5_tpu_torch.infer import load_model
    from yolov5_tpu_torch.models.yolo import DetectionModel

    model, names = load_model(weights or None, cfg, seed, DetectionModel, "export")
    model = model.float().eval()
    forward = ExportForward(model, with_nms).eval()
    example = torch.zeros((batch_size, imgsz, imgsz, 3), dtype=torch.uint8)
    return forward, example, model, names or model.names


def _meta_json(meta):
    return json.dumps(meta, indent=1, default=str)


def _trace(forward, example):
    t0 = time.time()
    with torch.no_grad():
        program = torch.export.export(forward, (example,))
    print(f"export: traced {type(forward.model).__name__} b{example.shape[0]} "
          f"{example.shape[1]}px on the host in {time.time() - t0:.1f}s")
    return program


def _onnx_bytes(program, name, meta):
    """The traced forward as ONNX (opset 13) bytes, the meta as
    metadata_props (each value JSON)."""
    from yolov5_tpu_torch.onnx.convert import program_to_onnx

    return program_to_onnx(program.run_decompositions(), input_names=["images"],
                           model_name=name, doc="yolov5_tpu_torch ONNX export",
                           metadata={k: json.dumps(v, default=str) for k, v in meta.items()})


@try_export
def export_ckpt(model, meta, file):
    """The fused inference checkpoint (the reference's strip_optimizer
    artifact) in the JAX package's payload layout: params and batch_stats
    of the BN-folded model, no EMA, ``fused`` True."""
    from yolov5_tpu_torch.models.weights import to_jax_variables
    from yolov5_tpu_torch.utils.checkpoint import msgpack_serialize

    variables = to_jax_variables(model.state_dict())
    payload = {"params": variables["params"], "batch_stats": variables.get("batch_stats", {}),
               "ema_params": None, "ema_stats": None, "fused": True}
    file = Path(file)
    file.write_bytes(msgpack_serialize(payload))
    Path(str(file) + ".json").write_text(_meta_json(meta))
    return file


@try_export
def export_pt2(program, file, meta):
    """``torch.export.save`` of the traced forward (with the NMS where it
    was traced with it), its meta beside it."""
    file = Path(file)
    # the program carries its example batch (39 MB at b32 640 px), which
    # loading it does not need
    program.example_inputs = None
    torch.export.save(program, str(file))
    Path(str(file) + ".json").write_text(_meta_json(meta))
    return file


@try_export
def export_onnx(program, file, meta, with_nms=False, device="cuda"):
    """The traced forward as ONNX (opset 13) through the port's converter,
    the meta as metadata_props (each value JSON); then one call of the
    port's runtime on ``device`` over a zero batch, which must give finite
    outputs of the traced shapes."""
    from yolov5_tpu_torch.onnx.runtime import Runtime

    if with_nms:
        raise NotImplementedError(_NO_NMS)
    file = Path(file)
    data = _onnx_bytes(program, file.stem, meta)
    file.write_bytes(data)
    rt = Runtime(data, device=device)
    outs = rt(torch.zeros(rt.inputs[0][1], dtype=torch.uint8))
    for o, (oname, shape) in zip(outs, rt.outputs):
        if tuple(o.shape) != shape or not torch.isfinite(o.float()).all():
            raise ValueError(f"{file.name}: the runtime on {rt.device} gave {oname} of shape "
                             f"{tuple(o.shape)} (graph: {shape}), finite "
                             f"{bool(torch.isfinite(o.float()).all())}")
    return file


def _tf_function(graph, shape, with_nms=False):
    """The ONNX ``graph`` (bytes, no NMS) as a ``tf.function`` of one uint8
    batch of ``shape`` named "images", the JAX exports' signature; with
    ``with_nms`` its predictions go through ``non_max_suppression_tf`` at
    ``EXPORT_NMS``."""
    from yolov5_tpu_torch.onnx.to_tf import import_tensorflow, non_max_suppression_tf, to_tf

    tf = import_tensorflow()
    fn = to_tf(graph)

    def forward(images):
        pred = fn(images)
        return non_max_suppression_tf(pred, **EXPORT_NMS) if with_nms else pred

    return tf.function(forward, autograph=False,
                       input_signature=[tf.TensorSpec(shape, tf.uint8, name="images")])


@try_export
def export_saved_model(graph, shape, file, with_nms=False):
    """A SavedModel of a ``tf.Module`` whose ``f`` is ``_tf_function``."""
    from yolov5_tpu_torch.onnx.to_tf import import_tensorflow

    tf = import_tensorflow()
    module = tf.Module()
    module.f = _tf_function(graph, shape, with_nms)
    tf.saved_model.save(module, str(file))
    return Path(file)


@try_export
def export_pb(graph, shape, file, with_nms=False):
    """A frozen TensorFlow GraphDef (reference export.py:793-816 keras2pb):
    ``_tf_function``'s concrete graph with its variables folded to
    constants, written as a binary .pb, which ``infer.Detector`` loads with
    ``wrap_function`` / ``import_graph_def``."""
    from yolov5_tpu_torch.onnx.to_tf import import_tensorflow

    tf = import_tensorflow()
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    frozen = convert_variables_to_constants_v2(
        _tf_function(graph, shape, with_nms).get_concrete_function())
    file = Path(file)
    tf.io.write_graph(graph_or_graph_def=frozen.graph, logdir=str(file.parent), name=file.name,
                      as_text=False)
    return file


@try_export
def export_tflite(saved_model_dir, file, int8=False, rep_data=None):
    """A SavedModel as TFLite (builtin ops, TF ops where needed); ``int8``
    quantizes with ``rep_data`` (uint8 batches) as its representative
    dataset."""
    from yolov5_tpu_torch.onnx.to_tf import import_tensorflow

    tf = import_tensorflow()
    conv = tf.lite.TFLiteConverter.from_saved_model(str(saved_model_dir))
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS,
                                      tf.lite.OpsSet.SELECT_TF_OPS]
    if int8:
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
        if rep_data is not None:
            conv.representative_dataset = lambda: ([x] for x in rep_data)
    Path(file).write_bytes(conv.convert())
    return Path(file)


def _representative_images(data, shape, n=100):
    """Up to ``n`` uint8 batches of ``shape`` for int8 calibration, each one
    letterboxed train image (val where there is no train split) repeated
    (reference export.py:819-860); None without images or on failure. The
    images are read by ``data.imageio``, so BMP needs no OpenCV."""
    import glob

    from yolov5_tpu_torch.data.imageio import imread
    from yolov5_tpu_torch.data.letterbox import letterbox
    from yolov5_tpu_torch.utils.general import check_dataset

    try:
        data_dict = check_dataset(data)
        root = Path(data_dict.get("train") or data_dict.get("val"))
        files = sorted(f for f in (root.rglob("*") if root.is_dir()
                                   else map(Path, glob.glob(str(root))))
                       if f.suffix.lower() in {".jpg", ".jpeg", ".png", ".bmp"})[:n]
        s = shape[1]
        out = []
        for f in files:
            try:
                im = imread(f)
            except (OSError, ValueError):
                continue
            lb = letterbox(im[..., ::-1], (s, s))[0]
            out.append(np.broadcast_to(lb[None], shape).astype(np.uint8))
        return out or None
    except Exception as e:
        print(f"int8 calibration data unavailable ({e}); using random")
        return None


def gd_outputs(gd):
    """Output node names of a TensorFlow GraphDef: the nodes nobody consumes,
    NoOps left out (a copy of ``yolov5_tpu.export.gd_outputs``, which the
    ``.pb`` backend of ``infer.Detector`` needs)."""
    name_list, input_list = [], []
    for node in gd.node:
        name_list.append(node.name)
        input_list.extend(node.input)
    return sorted(f"{x}:0" for x in list(set(name_list) - set(input_list))
                  if not x.startswith("NoOp"))


def run(weights="", cfg="yolov5s", imgsz=640, batch_size=1, include=("ckpt", "pt2"),
        with_nms=False, int8=False, output_dir=None, name=None, data=None, device="cuda"):
    """Export orchestrator (reference export.py run(), :1285-1488), the JAX
    package's order of steps (yolov5_tpu/export.py:322-362). Returns
    {format: path or None}. An unavailable format is skipped with its
    reason; a format that fails is reported and the others go on.
    ``device`` is where the written .onnx is checked (the card unless the
    caller asks for the CPU). ``int8`` makes the tflite file int8,
    calibrated on ``data``'s train images (a dataset YAML) where given."""
    from yolov5_tpu_torch.infer import resolve_device
    from yolov5_tpu_torch.utils.checkpoint import anchors_to_yaml

    device = resolve_device(device, "export")
    table = {n: (ok, note) for n, _, ok, note in export_formats()}
    for fmt in include:
        if fmt not in table:
            raise ValueError(f"unknown format {fmt}")
        if not table[fmt][0]:
            print(f"skipping {fmt}: {table[fmt][1]}")
    include = [f for f in include if table[f][0]]

    forward, example, model, names = _build_forward(weights, cfg, imgsz, batch_size,
                                                    with_nms=with_nms)
    stem = name or (Path(str(weights)).stem if isinstance(weights, (str, Path)) and weights
                    else str(cfg))
    out_dir = Path(output_dir or (Path(str(weights)).parent
                                  if isinstance(weights, (str, Path)) and weights
                                  else "runs/export"))
    out_dir.mkdir(parents=True, exist_ok=True)
    meta = {"cfg": model.cfg, "nc": model.nc, "names": names, "stride": list(model.stride),
            "anchors": anchors_to_yaml(model.anchors), "imgsz": imgsz, "with_nms": with_nms,
            "format": "yolov5_tpu-export"}
    artifacts = {}
    if "ckpt" in include:
        artifacts["ckpt"] = export_ckpt(model, meta, out_dir / f"{stem}.fused.ckpt")
    # the fp32 saved_model is made where it is asked for or fp32 tflite needs
    # it; int8 tflite converts its own normalized-box saved_model
    fp32_sm = "saved_model" in include or ("tflite" in include and not int8)
    program = graph = None
    if {"pt2", "onnx"} & set(include):
        program = _trace(forward, example)
        if "pt2" in include:
            artifacts["pt2"] = export_pt2(program, out_dir / f"{stem}.pt2", meta)
        if "onnx" in include:
            artifacts["onnx"] = export_onnx(program, out_dir / f"{stem}.onnx", meta, with_nms,
                                            device=device)
    if fp32_sm or "pb" in include:
        # the TF graph holds the NMS as TF ops: it is built from the forward
        # without it
        if program is None or with_nms:
            program = _trace(ExportForward(model).eval(), example)
        graph = _onnx_bytes(program, stem, meta)
    shape = tuple(example.shape)
    sm_dir = None
    if fp32_sm:
        sm_dir = export_saved_model(graph, shape, out_dir / f"{stem}_saved_model", with_nms)
        artifacts["saved_model"] = sm_dir
        if sm_dir:
            (Path(sm_dir) / "yolov5_tpu_meta.json").write_text(_meta_json(meta))
    if "pb" in include:
        artifacts["pb"] = export_pb(graph, shape, out_dir / f"{stem}.pb", with_nms)
        if artifacts["pb"]:
            Path(str(artifacts["pb"]) + ".json").write_text(_meta_json(meta))
    if "tflite" in include:
        rep, src_dir, tfl_meta = None, sm_dir, meta
        if int8:
            rep = _representative_images(data, shape) if data else None
            if rep is None:
                rng = np.random.default_rng(0)
                rep = [rng.integers(0, 255, shape, dtype=np.uint8) for _ in range(8)]
            program_n = _trace(ExportForward(model, normalize_boxes=imgsz).eval(), example)
            src_dir = export_saved_model(_onnx_bytes(program_n, stem, meta), shape,
                                         out_dir / f"{stem}_saved_model_int8", with_nms)
            tfl_meta = dict(meta, normalized=True)
        if src_dir:
            artifacts["tflite"] = export_tflite(
                src_dir, out_dir / f"{stem}{'-int8' if int8 else ''}.tflite", int8=int8,
                rep_data=rep)
        if artifacts.get("tflite"):
            Path(str(artifacts["tflite"]) + ".json").write_text(_meta_json(tfl_meta))
    return artifacts


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.export")
    p.add_argument("--weights", default="", help=".ckpt or .pt (default: seeded random weights)")
    p.add_argument("--cfg", default="yolov5s")
    p.add_argument("--imgsz", "--img", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=1, help="the graph's fixed batch")
    p.add_argument("--include", nargs="+", default=["ckpt", "pt2"],
                   help=" ".join(n for n, *_ in export_formats()))
    p.add_argument("--nms", action="store_true",
                   help="embed NMS in the pt2 and TF graphs (fails for onnx: ROADMAP)")
    p.add_argument("--int8", action="store_true", help="int8 TFLite (normalized boxes)")
    p.add_argument("--data", default=None,
                   help="dataset YAML whose train images calibrate --int8 (else random)")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the written .onnx is checked: cuda, cuda:N or cpu")
    opt = p.parse_args(argv)
    arts = run(weights=opt.weights, cfg=opt.cfg, imgsz=opt.imgsz, batch_size=opt.batch_size,
               include=tuple(opt.include), with_nms=opt.nms, int8=opt.int8,
               output_dir=opt.output_dir, data=opt.data, device=opt.device)
    print({k: str(v) for k, v in arts.items()})
    return arts


if __name__ == "__main__":
    main()
