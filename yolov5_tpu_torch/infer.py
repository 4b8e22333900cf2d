"""High-level inference: weights -> BN-folded model on an explicit device ->
raw head maps -> decode + NMS -> padded ``Detections`` -> boxes on the source
image, annotated and saved.

The port of ``yolov5_tpu/infer.py``: ``Detector`` (serving from the raw
maps, the decoded forward that validation uses, test-time augmentation, and
the exported backends: ``.onnx`` through the port's ONNX runtime on the
device, OpenCV DNN, a KServe v2 server, the JAX package's TensorFlow
exports), ``Ensemble``, ``annotate`` and ``save_one_box``, and ``run``, what
the detect CLI calls. On a CUDA device the forward's stem runs kernel K2 and
the suppression kernel K1 (K1 after every backend); the other convolutions
run through ``F.conv2d``. Annotation draws with numpy (``utils/font.py`` for
the labels), so it needs no OpenCV.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolov5_tpu_torch.data.imageio import imwrite
from yolov5_tpu_torch.data.letterbox import scale_boxes_np
from yolov5_tpu_torch.data.sources import LoadImages, batched
from yolov5_tpu_torch.models.layers import decode
from yolov5_tpu_torch.models.weights import (fuse_conv_bn, from_jax_variables,
                                             load_torch_state_dict, load_weights)
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.ops.nms import (detections_to_numpy, non_max_suppression,
                                      non_max_suppression_from_maps)
from yolov5_tpu_torch.utils import font
from yolov5_tpu_torch.utils.checkpoint import load_checkpoint, variables_from_checkpoint
from yolov5_tpu_torch.utils.general import increment_path
from yolov5_tpu_torch.utils.profile import span

# test-time augmentation: (scale, flip left-right) per pass (reference
# models/yolo.py:269-312), and the value the scaled images are padded with
TTA_PASSES = ((1.0, False), (0.83, True), (0.67, False))
TTA_PAD = 0.447


def tta_scale(x: torch.Tensor, ratio: float, gs: int) -> torch.Tensor:
    """(bs, 3, h, w) in [0, 1] -> resized to (int(h·ratio), int(w·ratio)),
    then padded at the bottom and right with TTA_PAD up to multiples of gs.

    Bilinear with antialiasing, in float32: ``jax.image.resize(...,
    "bilinear")``, which the JAX package calls, antialiases when it scales
    down (the reference's ``F.interpolate`` does not)."""
    h, w = x.shape[2:]
    nh = -int(-h * ratio // gs) * gs  # ceil to a stride multiple
    nw = -int(-w * ratio // gs) * gs
    y = F.interpolate(x.float(), size=(int(h * ratio), int(w * ratio)), mode="bilinear",
                      align_corners=False, antialias=True).to(x.dtype)
    return F.pad(y, (0, nw - y.shape[3], 0, nh - y.shape[2]), value=TTA_PAD)


def resolve_device(device, who):
    """``device`` as a torch.device; a CUDA device where none is present
    raises (no quiet fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device={device!r}): no CUDA device is available")
    return dev


def load_model(weights, cfg, seed, model_cls, who, fuse=True):
    """A ``model_cls`` (DetectionModel or SegmentationModel) on the host, BN
    folded into the convs unless ``fuse`` is False, and its class names from
    a checkpoint's meta (or None). Unfused, it needs weights that still hold
    their BN: folded ones raise ValueError.

    ``weights`` is one of:
      - None: seeded random weights;
      - a reference ``.pt`` path;
      - a ``.ckpt`` path written by the JAX package: its EMA weights when it
        has them, and cfg, class names and anchors from its meta;
      - a state_dict in the reference torch layout (fused or not; see
        ``models.weights.from_jax_variables``)."""
    names = anchors = None
    if weights is None:
        sd = model_cls(cfg, seed=seed).state_dict()
    elif isinstance(weights, dict):
        sd = weights
    elif str(weights).endswith(".ckpt"):
        payload, meta = load_checkpoint(weights)
        cfg = meta.get("cfg", cfg)
        anchors = meta.get("anchors")  # autoanchor may have evolved them
        sd = from_jax_variables(variables_from_checkpoint(payload, prefer_ema=True))
        names = {int(k): v for k, v in meta.get("names", {}).items()} or None
    elif str(weights).endswith(".pt"):
        sd = load_torch_state_dict(Path(weights))
    else:
        raise ValueError(f"{who}: weights must be None, a .pt or .ckpt path, or "
                         f"a state_dict, got {weights!r}")
    model = model_cls(cfg, fused=fuse, seed=seed, anchors=anchors)
    missed = load_weights(model, fuse_conv_bn(sd) if fuse else sd)
    if not fuse and any(m.endswith("bn.running_var") for m in missed):
        raise ValueError(f"{who}(fuse=False): the weights are BN-folded; running unfused "
                         "needs weights that hold their BN")
    if missed:
        print(f"weight import: {len(missed)} unmatched entries")
    return model, names


def _class_filter(classes, nc):
    """A class id list -> an (nc,) bool keep-mask, or None."""
    if classes is None:
        return None
    keep = np.zeros(nc, bool)
    keep[list(classes)] = True
    return keep


class Detector:
    """Weights in, detections out.

    ``weights`` as ``load_model`` takes them (BN is folded at load unless
    ``fuse`` is False; ``fused`` says which form runs, and only the folded
    stem reaches kernel K2), or an
    exported model: a ``.onnx`` file (the port's ONNX runtime on ``device``,
    or OpenCV's DNN module with ``dnn``), ``triton+http(s)://host:port/model``
    (a KServe v2 server), or a ``_saved_model`` / ``.pb`` / ``.tflite``
    export of either package (TensorFlow on the host). An exported model
    decodes in its graph: ``forward`` gives its predictions on ``device``,
    ``__call__`` adds the NMS (K1 on the card), ``model`` is None and names,
    classes and size come from the file's metadata. Several weights make an ``Ensemble``: see
    ``ensemble``. ``half`` runs the model in bfloat16. ``fuse`` means
    nothing to an exported model, whose graph is fixed. It runs on the card
    unless ``device`` says otherwise (``device="cpu"``), and raises where no
    card is present."""

    def __init__(self, weights=None, cfg="yolov5s", imgsz=640, half=False,
                 device="cuda", seed=0, dnn=False, fuse=True):
        self.device = resolve_device(device, "Detector")
        self.dtype = torch.bfloat16 if half else torch.float32
        if isinstance(weights, (list, tuple)):
            raise ValueError("Detector: several weights make an Ensemble; build it "
                             "with yolov5_tpu_torch.infer.ensemble(weights, ...)")
        w = "" if weights is None or isinstance(weights, dict) else str(weights)
        if w.endswith(EXPORTED) or w.startswith(REMOTE):
            self._init_exported(w, imgsz, dnn)
            return
        self.backend = "torch"
        model, names = load_model(weights, cfg, seed, DetectionModel, "Detector", fuse)
        self.fused = fuse
        self.model = model.to(self.device, self.dtype).to(
            memory_format=torch.channels_last).eval()
        self.names = names or model.names
        self.nc = model.nc
        self.imgsz = imgsz
        self.stride = model.stride
        self.anchors = tuple(torch.tensor(a, dtype=torch.float32, device=self.device)
                             for a in model.anchors)

    def _init_exported(self, w, imgsz, dnn):
        """An exported model as the decoded forward (the reference's
        DetectMultiBackend role, models/common.py:456-814; the JAX package's
        ``Detector._init_*_backend``). A backend whose library is missing
        raises ImportError naming it; none falls back to another."""
        if w.startswith(REMOTE):
            self.backend, fwd, meta = _remote_backend(w)
        elif w.endswith(".onnx"):
            self.backend, fwd, meta = _onnx_backend(w, self.device, dnn)
        else:
            self.backend, fwd, meta = _tf_backend(w, imgsz)
        self.model = None
        self.fused = True  # as the JAX package says of its exported backends
        self.dtype = torch.float32
        self.names = {int(k): v for k, v in (meta.get("names") or {}).items()}
        self.nc = int(meta.get("nc", max(self.names, default=79) + 1))
        self.imgsz = int(meta.get("imgsz", imgsz))
        self.stride = tuple(int(s) for s in meta.get("stride", (32,)))
        self.anchors = None
        self._exported = fwd

    def _images(self, images_uint8) -> torch.Tensor:
        images = torch.as_tensor(images_uint8)
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"Detector: need (bs, H, W, 3) uint8 images, got "
                             f"{tuple(images.shape)} {images.dtype}")
        return images

    def _to_input(self, images_uint8) -> torch.Tensor:
        """(bs, H, W, 3) uint8 -> (bs, 3, H, W) channels_last in the working
        dtype: cast, then divide by 255 in that dtype."""
        with span("detect.input", device=self.device):
            images = self._images(images_uint8).to(self.device, non_blocking=True).contiguous()
            x = images.permute(0, 3, 1, 2)  # NHWC storage = channels_last
            return x.to(self.dtype) / 255.0

    def _model(self, x):
        with span("detect.model", device=self.device):
            return self.model(x)

    def _decode(self, maps) -> torch.Tensor:
        return decode(maps, self.anchors, self.stride, torch.float32, nc=self.nc)

    @torch.inference_mode()
    def forward_maps(self, images_uint8):
        """The raw head maps [(bs, ny, nx, na, no)] in the working dtype."""
        if self.model is None:
            raise ValueError(f"Detector: the {self.backend} backend gives no raw maps")
        return self._model(self._to_input(images_uint8))

    @torch.inference_mode()
    def forward(self, images_uint8) -> torch.Tensor:
        """Decoded predictions (bs, N, 5 + nc) in float32: xywh in pixels,
        objectness and class probabilities."""
        if self.model is None:
            return self._exported(self._images(images_uint8)).to(self.device)
        return self._decode(self._model(self._to_input(images_uint8)))

    @torch.inference_mode()
    def forward_tta(self, images_uint8) -> torch.Tensor:
        """Decoded predictions of the test-time augmentation passes
        (TTA_PASSES), each de-scaled (and un-flipped) back to the input
        frame, concatenated along N."""
        if self.model is None:
            raise ValueError(f"TTA is not supported on the {self.backend} backend")
        x0 = self._to_input(images_uint8)
        h, w = x0.shape[2:]
        gs = max(self.stride)
        outs = []
        for ratio, flip in TTA_PASSES:
            x = x0.flip(3) if flip else x0
            if ratio != 1.0:
                x = tta_scale(x, ratio, gs)
            p = self._decode(self.model(x.contiguous(memory_format=torch.channels_last)))
            # de-scale with the actual per-axis resize ratio
            rx = int(w * ratio) / w if ratio != 1.0 else 1.0
            ry = int(h * ratio) / h if ratio != 1.0 else 1.0
            xs = p[..., 0:1] / rx
            if flip:
                xs = w - xs
            outs.append(torch.cat([xs, p[..., 1:2] / ry, p[..., 2:3] / rx,
                                   p[..., 3:4] / ry, p[..., 4:]], -1))
        return torch.cat(outs, 1)

    @torch.inference_mode()
    def __call__(self, images_uint8, conf_thres=0.25, iou_thres=0.45,
                 max_det=1000, classes=None, agnostic=False, max_nms=2048,
                 augment=False):
        """images: (bs, s, s, 3) uint8 RGB (letterboxed), numpy or tensor.
        Returns padded ``Detections`` on the model's device: from the raw
        maps, or with ``augment`` from the decoded TTA predictions, or from
        an exported model's decoded predictions."""
        with span("detect"):
            class_filter = _class_filter(classes, self.nc)
            if augment or self.model is None:  # an exported model's TTA raises
                return non_max_suppression(
                    self.forward_tta(images_uint8) if augment else self.forward(images_uint8),
                    conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                    agnostic=agnostic, class_filter=class_filter, max_nms=max_nms)
            maps = self._model(self._to_input(images_uint8))
            return non_max_suppression_from_maps(
                maps, self.anchors, self.stride, conf_thres=conf_thres,
                iou_thres=iou_thres, max_det=max_det, agnostic=agnostic,
                class_filter=class_filter, max_nms=max_nms, nc=self.nc)

    def warmup(self, batch_size=1):
        """One forward + NMS on a black batch (builds the CUDA kernels)."""
        self(np.zeros((batch_size, self.imgsz, self.imgsz, 3), np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# exported models (the reference's DetectMultiBackend suffixes) and the remote scheme
EXPORTED = ("_saved_model", ".tflite", ".pb", ".onnx")
REMOTE = ("triton+http://", "triton+https://")


def export_size(det, imgsz, weights):
    """The image size an exported model takes: its export size, with a
    warning where ``imgsz`` asks for another (a fixed graph takes no other)."""
    if imgsz != det.imgsz:
        print(f"WARNING: --imgsz {imgsz} does not match the export size {det.imgsz} of "
              f"{weights}; using {det.imgsz}")
    return det.imgsz


def _meta_values(props):
    """An .onnx file's metadata_props, each value JSON where it parses."""
    meta = {}
    for k, v in props.items():
        try:
            meta[k] = json.loads(v)
        except (json.JSONDecodeError, TypeError):
            meta[k] = v
    return meta


def _onnx_backend(w, device, dnn):
    """(backend, forward, meta) of an .onnx file: the port's ONNX runtime on
    ``device`` (initializers uploaded once), or with ``dnn`` OpenCV's DNN
    module on the host (the reference's --dnn, models/common.py:515-517)."""
    from yolov5_tpu_torch.onnx import proto

    buf = Path(w).read_bytes()
    meta = _meta_values(proto.parse_model(buf).metadata)
    if dnn:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(f"Detector({w!r}, dnn=True): OpenCV (cv2) is not installed; "
                              "its DNN module runs --dnn") from e
        net = cv2.dnn.readNetFromONNX(w)

        def fwd(images):  # the export's signature: uint8 NHWC in, decoded out
            net.setInput(images.cpu().numpy())
            return torch.from_numpy(np.ascontiguousarray(net.forward()))

        return "onnx-dnn", fwd, meta
    from yolov5_tpu_torch.onnx.runtime import Runtime

    rt = Runtime(buf, device=device)
    return "onnx", lambda images: rt(images)[0], meta


def _remote_backend(w):
    """(backend, forward, meta) of a KServe / Triton v2 model
    (``triton+http://host:port/model``; the reference's TritonRemoteModel,
    utils/triton.py:11-78): the server's graph must give decoded (bs, N, no)
    predictions, as the exports do. Names and nc from its metadata's
    parameters."""
    from yolov5_tpu_torch.remote import KServeV2Client

    client = KServeV2Client(w)
    params = client.metadata.get("parameters") or {}
    names = params.get("names")
    meta = {"names": names if isinstance(names, dict) else {}}
    if "nc" in params:
        meta["nc"] = params["nc"]

    def fwd(images):
        return torch.from_numpy(client.infer(images.cpu().numpy())).float()

    return "triton", fwd, meta


def _tf_backend(w, imgsz):
    """(backend, forward, meta) of a TensorFlow export of either package
    (SavedModel directory, frozen ``.pb``, ``.tflite``; reference
    models/common.py:545-561,676-712), run by TensorFlow on the host."""
    from yolov5_tpu_torch.onnx.to_tf import import_tensorflow

    try:
        tf = import_tensorflow()
    except ImportError as e:
        raise ImportError(f"Detector({w!r}): TensorFlow is not installed; it runs "
                          "_saved_model, .pb and .tflite exports") from e
    meta_path = Path(w) / "yolov5_tpu_meta.json" if w.endswith("_saved_model") \
        else Path(w + ".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    if w.endswith("_saved_model"):
        mod = tf.saved_model.load(w)

        def fwd(images):
            return _from_tf(mod.f(tf.constant(images.cpu().numpy())))

        return "saved_model", fwd, meta
    if w.endswith(".pb"):
        from yolov5_tpu_torch.export import gd_outputs

        gd = tf.compat.v1.GraphDef()
        gd.ParseFromString(Path(w).read_bytes())
        wrapped = tf.compat.v1.wrap_function(
            lambda: tf.compat.v1.import_graph_def(gd, name=""), [])
        inputs = [n.name + ":0" for n in gd.node if n.op == "Placeholder"]
        frozen = wrapped.prune(
            tf.nest.map_structure(wrapped.graph.as_graph_element, inputs[0]),
            tf.nest.map_structure(wrapped.graph.as_graph_element, gd_outputs(gd)))

        def fwd(images):
            out = frozen(tf.constant(images.cpu().numpy()))
            return _from_tf(out[0] if isinstance(out, (list, tuple)) else out)

        return "pb", fwd, meta
    interp = tf.lite.Interpreter(model_path=w)
    interp.allocate_tensors()
    inp, outd = interp.get_input_details()[0], interp.get_output_details()[0]
    # int8 exports carry boxes divided by imgsz (the JAX export's
    # normalize_boxes); scale them back as the reference does (common.py:707)
    box_scale = float(meta.get("imgsz", imgsz)) if meta.get("normalized") else 1.0

    def fwd(images):
        interp.set_tensor(inp["index"], images.cpu().numpy())
        interp.invoke()
        pred = np.asarray(interp.get_tensor(outd["index"]), np.float32)
        if box_scale != 1.0:
            pred = np.concatenate([pred[..., :4] * box_scale, pred[..., 4:]], -1)
        return torch.from_numpy(pred)

    return "tflite", fwd, meta


def _from_tf(t):
    return torch.from_numpy(np.array(t, np.float32))


class Ensemble:
    """Several detectors as one (reference models/experimental.py:44-57):
    the members' decoded predictions are concatenated before one NMS. Names,
    classes, size, device and strides are the first member's."""

    def __init__(self, detectors):
        self.detectors = list(detectors)
        first = self.detectors[0]
        self.names, self.nc, self.imgsz = first.names, first.nc, first.imgsz
        self.device, self.stride = first.device, first.stride

    @torch.inference_mode()
    def forward(self, images_uint8) -> torch.Tensor:
        images = torch.as_tensor(images_uint8).to(self.device)
        return torch.cat([d.forward(images) for d in self.detectors], 1)

    @torch.inference_mode()
    def __call__(self, images_uint8, conf_thres=0.25, iou_thres=0.45,
                 max_det=1000, classes=None, agnostic=False, max_nms=2048,
                 augment=False):
        """As ``Detector.__call__``, on the concatenated predictions."""
        if augment:
            raise ValueError("TTA is not supported on the ensemble backend")
        return non_max_suppression(
            self.forward(images_uint8), conf_thres=conf_thres, iou_thres=iou_thres,
            max_det=max_det, agnostic=agnostic,
            class_filter=_class_filter(classes, self.nc), max_nms=max_nms)


def ensemble(weights_list, **kw):
    """An Ensemble of one Detector per weights entry (the reference's
    attempt_load with a list, models/experimental.py:60-101); ``kw`` go to
    every Detector."""
    return Ensemble([Detector(w, **kw) for w in weights_list])


# ---------------------------------------------------------------------------
# Annotation (numpy; cv2.rectangle / cv2.putText in the JAX package)
# ---------------------------------------------------------------------------

# a readable default palette (BGR) for annotation
_PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
    (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
    (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]


def color_for(cls_id):
    return _PALETTE[int(cls_id) % len(_PALETTE)]


def _draw_outline(im, p1, p2, color, lw):
    """The outline of the box p1-p2 (integer corners) at line width lw: every
    pixel whose centre lies within r of the rectangle's border, r = 1/2 for
    lw = 1 and (lw + 1) / 2 above (the pixels that ``cv2.rectangle(...,
    lw, LINE_AA)`` colours fully, rounded outer corners included). Drawn
    strip by strip around the four sides, clipped to the image."""
    h, w = im.shape[:2]
    (x1, x2), (y1, y2) = sorted((p1[0], p2[0])), sorted((p1[1], p2[1]))
    r = 0.5 if lw <= 1 else (lw + 1) / 2
    e = int(np.ceil(r))
    for ya, yb, xa, xb in ((y1 - e, y1 + e, x1 - e, x2 + e), (y2 - e, y2 + e, x1 - e, x2 + e),
                           (y1 - e, y2 + e, x1 - e, x1 + e), (y1 - e, y2 + e, x2 - e, x2 + e)):
        ya, yb, xa, xb = max(ya, 0), min(yb + 1, h), max(xa, 0), min(xb + 1, w)
        if ya >= yb or xa >= xb:
            continue
        ys = np.arange(ya, yb, dtype=np.float64)[:, None]
        xs = np.arange(xa, xb, dtype=np.float64)[None, :]
        dx = np.maximum(np.maximum(x1 - xs, xs - x2), 0.0)
        dy = np.maximum(np.maximum(y1 - ys, ys - y2), 0.0)
        inside = np.minimum(np.minimum(xs - x1, x2 - xs), np.minimum(ys - y1, y2 - ys))
        d = np.where((dx > 0) | (dy > 0), np.hypot(dx, dy), inside)
        im[ya:yb, xa:xb][d <= r] = color


def _fill(im, p1, p2, color):
    """Fill the box p1-p2, corners included, clipped to the image."""
    h, w = im.shape[:2]
    (x1, x2), (y1, y2) = sorted((p1[0], p2[0])), sorted((p1[1], p2[1]))
    im[max(y1, 0):min(y2 + 1, h), max(x1, 0):min(x2 + 1, w)] = color


def annotate(im, boxes, scores, classes, names, line_width=None,
             hide_labels=False, hide_conf=False):
    """Draw boxes + labels on a BGR image in place: the JAX package's
    layout (palette, line width, the label bar above the box where it fits
    and inside it otherwise, white text), drawn with numpy and the bitmap
    font of ``utils/font.py`` (glyphs ``line_width`` pixels a dot)."""
    lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)
    for box, score, cls in zip(boxes, scores, classes):
        c = color_for(cls)
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        _draw_outline(im, p1, p2, c, lw)
        if hide_labels:
            continue
        label = (f"{names.get(int(cls), int(cls))}" if hide_conf else
                 f"{names.get(int(cls), int(cls))} {score:.2f}")
        w, h = font.text_size(label, lw)
        outside = p1[1] - h >= 3
        p2t = (p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3)
        _fill(im, p1, p2t, c)
        font.put_text(im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2), lw,
                      (255, 255, 255))
    return im


def save_one_box(box, im0, path, gain=1.02, pad=10):
    """Crop a detection (xyxy) from the original image with margin and save
    (reference utils/plots.py save_one_box: gain 1.02, pad 10px, clipped)."""
    h0, w0 = im0.shape[:2]
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw = (x2 - x1) * gain + 2 * pad
    bh = (y2 - y1) * gain + 2 * pad
    x1 = int(max(cx - bw / 2, 0)); x2 = int(min(cx + bw / 2, w0))
    y1 = int(max(cy - bh / 2, 0)); y2 = int(min(cy + bh / 2, h0))
    path.parent.mkdir(parents=True, exist_ok=True)
    imwrite(path, im0[y1:y2, x1:x2])


# ---------------------------------------------------------------------------
# The detect run
# ---------------------------------------------------------------------------

def _source_iter(source, imgsz, vid_stride):
    s = str(source)
    if s.startswith("screen"):
        from yolov5_tpu_torch.data.sources import LoadScreenshots

        return LoadScreenshots(s, img_size=imgsz)
    if s.isnumeric() or s.startswith(("rtsp://", "rtmp://")) or s.endswith(".streams"):
        from yolov5_tpu_torch.data.sources import LoadStreams

        return LoadStreams(Path(s).read_text().split() if s.endswith(".streams") else s,
                           img_size=imgsz)
    return LoadImages(source, img_size=imgsz, vid_stride=vid_stride)


def _show(path, im, state):
    """--view-img: show one frame; without OpenCV or a display, say so once
    and stop showing (``state["view"]`` turns False)."""
    try:
        import cv2

        cv2.imshow(str(path), im)
        cv2.waitKey(1)
    except ImportError:
        state["view"] = False
        print("--view-img: OpenCV (cv2) is not installed, disabled")
    except cv2.error:
        state["view"] = False  # headless: warn once, keep going
        print("--view-img: no display available, disabled")


def _read_ahead(source_iter, batch_size, pin):
    """Start a thread that reads and letterboxes the source a few batches
    ahead. Returns its queue of (group, uint8 (bs, s, s, 3) batch) items,
    ended by None; a failure in the thread is re-raised by ``drain``."""
    q: queue.Queue = queue.Queue(maxsize=3)
    failure = []

    def read():
        try:
            for g in batched(source_iter, batch_size):
                ims = torch.from_numpy(np.stack([x[1] for x in g]))
                q.put((g, ims.pin_memory() if pin else ims))
        except Exception as e:  # handed to the main thread
            failure.append(e)
        finally:
            q.put(None)

    def drain():
        while (item := q.get()) is not None:
            yield item
        if failure:
            raise failure[0]

    threading.Thread(target=read, daemon=True).start()
    return drain()


def run(weights=None, source="", cfg="yolov5s", imgsz=640, conf_thres=0.25,
        iou_thres=0.45, max_det=1000, classes=None, agnostic_nms=False,
        save_txt=False, save_conf=False, save_img=True, project="runs/detect",
        name="exp", exist_ok=False, line_thickness=None, batch_size=1,
        half=False, verbose=True, augment=False, data=None, hide_labels=False,
        hide_conf=False, save_crop=False, save_csv=False, vid_stride=1,
        view_img=False, dnn=False, device="cuda"):
    """Detect over a source; save annotated images / label txts. Returns
    (results, save_dir), results the list of (path, detections (n, 6)
    [x1, y1, x2, y2, conf, cls] on the source image), one per image of
    every batch (a short last batch is padded by repeating its last image).

    ``weights``: None or "" (seeded random), a .pt or .ckpt path, a
    state_dict, or an exported model (.onnx, with ``dnn`` through OpenCV;
    ``triton+http://``; the JAX package's TensorFlow exports), as
    ``Detector`` takes them. Runs on ``device`` (default the card; raises
    where there is none)."""
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
    (save_dir / "labels").mkdir(exist_ok=True)
    det = Detector(weights if isinstance(weights, dict) else (weights or None), cfg=cfg,
                   imgsz=imgsz, half=half, device=device, dnn=dnn)
    if data:  # class names from a dataset yaml (reference --data role)
        import yaml

        names = yaml.safe_load(Path(data).read_text()).get("names")
        if names:
            det.names = {int(k): v for k, v in (names.items()
                         if isinstance(names, dict) else enumerate(names))}
    if det.model is None:
        imgsz = export_size(det, imgsz, weights)
    det.warmup(batch_size)
    batches = _read_ahead(_source_iter(source, imgsz, vid_stride), batch_size,
                          pin=det.device.type == "cuda")

    # Three stages overlap: the reader thread letterboxes ahead, the main
    # thread enqueues batch i's forward + NMS on the device and only then
    # copies batch i-1's detections to the host (the one synchronisation),
    # and the host post-processes batch i-1 while the device runs batch i.
    def staged():
        pending = None
        for group, ims in batches:
            dets = det(ims, conf_thres, iou_thres, max_det, classes, agnostic_nms,
                       augment=augment)
            if pending is not None:
                yield pending[0], detections_to_numpy(pending[1])
            pending = (group, dets)
        if pending is not None:
            yield pending[0], detections_to_numpy(pending[1])

    results = []
    csv_rows = []  # (image, prediction, confidence) — reference --save-csv
    vid_writers = {}  # source path -> cv2.VideoWriter (reference detect.py:286-310)
    show = {"view": view_img}
    t_total = 0.0
    t_wall0 = time.perf_counter()
    for group, rows in staged():
        t_total = time.perf_counter() - t_wall0
        for (path, im_lb, im0, meta), r in zip(group, rows):
            if len(r):
                r = np.asarray(r)
                r[:, :4] = scale_boxes_np(im_lb.shape[:2], r[:, :4], im0.shape[:2])
            results.append((path, r))
            if verbose:
                counts = {}
                for c in r[:, 5].astype(int):
                    counts[c] = counts.get(c, 0) + 1
                desc = ", ".join(f"{n} {det.names.get(c, c)}" for c, n in counts.items())
                print(f"{path}: {len(r)} dets  {desc}")
            mode = meta.get("mode", "image")
            stem = Path(path).stem
            # per-frame txt names for videos/streams (reference detect.py:188)
            frame_tag = "" if mode == "image" else f"_{meta.get('frame', 0)}"
            if save_txt and len(r):
                h0, w0 = im0.shape[:2]
                lines = []
                for *xyxy, conf, cls in r:
                    x1, y1, x2, y2 = xyxy
                    row = [int(cls), (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                           (x2 - x1) / w0, (y2 - y1) / h0]
                    if save_conf:
                        row.append(conf)
                    lines.append(" ".join(f"{v:.6g}" for v in row))
                (save_dir / "labels" / f"{stem}{frame_tag}.txt").write_text(
                    "\n".join(lines) + "\n")
            if save_csv:
                for *xyxy, conf, cls in r:
                    csv_rows.append((Path(path).name, det.names.get(int(cls), int(cls)),
                                     f"{conf:.2f}"))
            if save_crop:
                for j, (*xyxy, conf, cls) in enumerate(r):
                    cname = str(det.names.get(int(cls), int(cls)))
                    save_one_box(xyxy, im0, save_dir / "crops" / cname /
                                 f"{stem}{frame_tag}_{j}.jpg")
            if save_img or show["view"]:
                im_out = im0.copy()
                annotate(im_out, r[:, :4], r[:, 4], r[:, 5], det.names, line_thickness,
                         hide_labels=hide_labels, hide_conf=hide_conf)
                if show["view"]:
                    _show(path, im_out, show)
            if save_img:
                if mode == "image":
                    imwrite(save_dir / Path(path).name, im_out)
                else:  # one VideoWriter per source: annotated mp4 out
                    writer = vid_writers.get(path)
                    if writer is None:
                        import cv2  # a video source has loaded it already

                        h0, w0 = im_out.shape[:2]
                        safe = stem if mode == "video" else f"stream{meta.get('stream', 0)}"
                        writer = cv2.VideoWriter(
                            str(save_dir / f"{safe}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                            float(meta.get("fps") or 30.0), (w0, h0))
                        vid_writers[path] = writer
                    writer.write(im_out)
    for writer in vid_writers.values():
        writer.release()
    if save_csv and csv_rows:
        import csv

        with open(save_dir / "predictions.csv", "w", newline="") as f:
            wcsv = csv.writer(f)
            wcsv.writerow(["Image Name", "Prediction", "Confidence"])
            wcsv.writerows(csv_rows)
    if verbose:
        n = max(len(results), 1)
        print(f"done: {len(results)} images, {1000 * t_total / n:.3f} ms/img "
              f"(pipelined decode+forward+NMS wall), results in {save_dir}")
    return results, save_dir
