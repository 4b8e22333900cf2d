"""Model export, the port of ``yolov5_tpu/export.py``.

| format  | artifact                                   | via                          |
|---------|--------------------------------------------|------------------------------|
| ckpt    | ``.fused.ckpt`` (BN folded), ``.json`` meta | the port's msgpack writer    |
| pt2     | ``.pt2`` program, ``.pt2.json`` meta        | ``torch.export.save``        |
| onnx    | ``.onnx`` (opset 13, NCHW graph)           | ``yolov5_tpu_torch.onnx``    |

``pt2`` takes the place of the JAX package's ``stablehlo``: the framework's
own serialised program, loadable with ``torch.export.load`` and nothing of
this package. The ONNX file is emitted by the port's own converter (no
``onnx`` package is needed). The TensorFlow formats (saved_model, pb,
tflite) need a torch -> TensorFlow path that does not exist here, and
TensorRT, CoreML, OpenVINO and Paddle their toolchains: ``export_formats()``
reports each as unavailable with its reason. ``Detector`` runs the JAX
package's TensorFlow exports all the same (``infer.py``).

The exported forward takes a uint8 (bs, s, s, 3) RGB batch and gives the
decoded (bs, N, 5 + nc) float32 predictions. It is traced from the
BN-folded float32 model on the host, so the stem is the plain Conv + SiLU
(the JAX export's ``packed_stem=False`` graph): the artifact has no device,
and what runs it (``infer.Detector`` on ``--device``) runs it on the card.
With ``--nms`` the pt2 graph also holds the NMS at the JAX export's settings
(conf 0.25, IoU 0.45, max_det 100, 1024 candidates; torch ops, not kernel
K1) and gives (boxes (bs, 100, 4) float32, scores (bs, 100), classes
(bs, 100) int32, valid (bs, 100) bool); the ONNX graph cannot hold it.

    python -m yolov5_tpu_torch.export --weights best.ckpt --include ckpt pt2 onnx
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch import nn

_NO_TF = "needs a torch -> TensorFlow path, which the port lacks (ROADMAP)"
_NO_NMS = ("--nms: the onnx graph cannot hold the NMS (no sort or loop lowering; the JAX "
           "package's onnx --nms fails too): see ROADMAP")
# the NMS of an --nms graph: the JAX export's settings (yolov5_tpu/export.py)
EXPORT_NMS = dict(conf_thres=0.25, iou_thres=0.45, max_det=100, max_nms=1024)


def export_formats():
    """Format table: (name, suffix, available, note)."""
    return [
        ("ckpt", ".ckpt", True, "inference checkpoint (BN folded), the JAX package's layout"),
        ("pt2", ".pt2", True, "torch.export program (torch.export.save)"),
        ("saved_model", "_saved_model", False, _NO_TF),
        ("pb", ".pb", False, _NO_TF),
        ("tflite", ".tflite", False, _NO_TF),
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
    ``EXPORT_NMS``: (boxes, scores, classes int32, valid)."""

    def __init__(self, model, with_nms=False):
        super().__init__()
        self.model = model
        self.with_nms = with_nms
        self.decodes = hasattr(model, "anchors")
        if self.decodes:
            self.strides = [float(s) for s in model.stride]
            for i, a in enumerate(model.anchors):
                self.register_buffer(f"anchors_{i}", torch.tensor(a, dtype=torch.float32),
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
    from yolov5_tpu_torch.onnx.convert import program_to_onnx
    from yolov5_tpu_torch.onnx.runtime import Runtime

    if with_nms:
        raise NotImplementedError(_NO_NMS)
    file = Path(file)
    data = program_to_onnx(program.run_decompositions(), input_names=["images"],
                           model_name=file.stem, doc="yolov5_tpu_torch ONNX export",
                           metadata={k: json.dumps(v, default=str) for k, v in meta.items()})
    file.write_bytes(data)
    rt = Runtime(data, device=device)
    outs = rt(torch.zeros(rt.inputs[0][1], dtype=torch.uint8))
    for o, (oname, shape) in zip(outs, rt.outputs):
        if tuple(o.shape) != shape or not torch.isfinite(o.float()).all():
            raise ValueError(f"{file.name}: the runtime on {rt.device} gave {oname} of shape "
                             f"{tuple(o.shape)} (graph: {shape}), finite "
                             f"{bool(torch.isfinite(o.float()).all())}")
    return file


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
        with_nms=False, output_dir=None, name=None, device="cuda"):
    """Export orchestrator (reference export.py run(), :1285-1488). Returns
    {format: path or None}. An unavailable format is skipped with its
    reason; a format that fails is reported and the others go on.
    ``device`` is where the written .onnx is checked (the card unless the
    caller asks for the CPU)."""
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
    if "pt2" in include or "onnx" in include:
        t0 = time.time()
        with torch.no_grad():
            program = torch.export.export(forward, (example,))
        print(f"export: traced {type(model).__name__} b{batch_size} {imgsz}px on the host "
              f"in {time.time() - t0:.1f}s")
        if "pt2" in include:
            artifacts["pt2"] = export_pt2(program, out_dir / f"{stem}.pt2", meta)
        if "onnx" in include:
            artifacts["onnx"] = export_onnx(program, out_dir / f"{stem}.onnx", meta, with_nms,
                                            device=device)
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
                   help="embed NMS in the pt2 graph (fails for onnx: ROADMAP)")
    p.add_argument("--int8", action="store_true",
                   help="int8 TFLite: unavailable, reported and nothing written for it")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the written .onnx is checked: cuda, cuda:N or cpu")
    opt = p.parse_args(argv)
    if opt.int8:
        print(f"skipping int8: {_NO_TF}")
    arts = run(weights=opt.weights, cfg=opt.cfg, imgsz=opt.imgsz, batch_size=opt.batch_size,
               include=tuple(opt.include), with_nms=opt.nms, output_dir=opt.output_dir,
               device=opt.device)
    print({k: str(v) for k, v in arts.items()})
    return arts


if __name__ == "__main__":
    main()
