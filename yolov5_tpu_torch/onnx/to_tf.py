"""ONNX -> TensorFlow: the port's ONNX graphs as functions of TF ops.

``to_tf(model_bytes)`` parses an ONNX model (:mod:`.proto`) and returns a
Python function of TF tensors that computes the graph with TF ops, one or a
few per node; ``export.py`` wraps it in a ``tf.function`` for the
SavedModel, frozen-graph and TFLite exports. It covers the op table of
:mod:`.runtime` (the ops that both packages' converters emit); any other
op raises ``UnsupportedOp`` naming it. Initializers become constants.

**Layout.** The ONNX graph is NCHW, while TF's CPU ``Conv2D``, its pooling
and TFLite take NHWC only. Each 4-D value is therefore carried either as
it is, or "nhwc": the tensor held is the ONNX value permuted by
(0, 2, 3, 1). Convs, pooling, Resize and BatchNormalization take and give
nhwc values; the ops that do not depend on layout (element-wise, Concat,
Slice, Pad, Softmax, the keepdims reductions) remap their axes and keep
it; a constant is permuted on the host. A Transpose is composed with the
carried permutation, so the graph's leading NHWC -> NCHW Transpose of the
uint8 input and each Detect level's NCHW -> NHWC Transpose emit nothing.
Only an op that needs the NCHW order (Reshape, MatMul, Gemm, Expand, a
reduction that drops axes) and the graph's outputs see a real transpose.

``non_max_suppression_tf`` is the NMS of an ``--nms`` TF export, in TF
ops: ``ops.nms.non_max_suppression(..., traceable=True)`` step for step.

TensorFlow is imported inside the functions, never when this module is
imported.
"""

from __future__ import annotations

import numpy as np

from ..ops.nms import MAX_WH
from . import proto
from .convert import UnsupportedOp

# the ONNX value permuted by _P is the nhwc tensor; logical axis a of an
# nhwc value is its axis _PINV[a]
_P = (0, 2, 3, 1)
_PINV = (0, 3, 1, 2)


def import_tensorflow():
    """``tensorflow``, with the GPUs hidden from it: the TF exports and
    backends run on the host, and TF would otherwise reserve the card's
    memory beside torch's. Raises ImportError where it is not installed."""
    import tensorflow as tf

    try:
        tf.config.set_visible_devices([], "GPU")
    except RuntimeError:  # TF's devices were already set up: they stay as they are
        pass
    return tf


class _V:
    """A graph value: ``t`` (a TF tensor, or None for a constant not yet
    made one), ``nhwc`` (see the module docstring) and ``host`` (a
    constant's numpy value, None otherwise)."""

    __slots__ = ("t", "nhwc", "host")

    def __init__(self, t=None, nhwc=False, host=None):
        self.t, self.nhwc, self.host = t, nhwc, host

    @property
    def rank(self):
        return self.host.ndim if self.host is not None else len(self.t.shape)

    @property
    def shape(self):
        """The ONNX (logical) shape."""
        s = list(self.host.shape if self.host is not None else self.t.shape.as_list())
        return [s[a] for a in _PINV] if self.nhwc else s


def to_tf(model_bytes: bytes):
    """The ONNX model as ``fn(*inputs) -> output or tuple of outputs``, a
    function of TF tensors (call it inside a ``tf.function``)."""
    tf = import_tensorflow()

    model = proto.parse_model(model_bytes)
    g = model.graph
    consts = {k: np.array(v) for k, v in g.initializers.items()}
    input_names = [n for n, _, _ in g.inputs if n not in consts]
    output_names = [n for n, _, _ in g.outputs]
    for node in g.nodes:
        if node.op_type not in _OPS:
            raise UnsupportedOp(f"to_tf: op {node.op_type!r} has no TensorFlow lowering")

    def fn(*args):
        env = {k: _V(host=v) for k, v in consts.items()}
        for name, x in zip(input_names, args):
            env[name] = _V(tf.convert_to_tensor(x))
        for node in g.nodes:
            ins = [env[i] if i else None for i in node.inputs]
            out = _OPS[node.op_type](tf, node.op_type, node.attrs, ins)
            for name, v in zip(node.outputs, out if isinstance(out, (list, tuple)) else [out]):
                env[name] = v
        outs = tuple(_logical(tf, env[n]) for n in output_names)
        return outs[0] if len(outs) == 1 else outs

    fn.input_names, fn.output_names = input_names, output_names
    return fn


# ---------------------------------------------------------------------------
# layout helpers


def _tensor(tf, v):
    """v's tensor as it is carried (a constant becomes a tf.constant)."""
    if v.t is None:
        v.t = tf.constant(v.host)
    return v.t


def _logical(tf, v):
    """v in the ONNX layout."""
    if v.nhwc:
        return tf.transpose(v.t, _PINV)
    return _tensor(tf, v)


def _nhwc(tf, v):
    """v (rank <= 4, broadcast to rank 4 by leading 1s) carried nhwc."""
    if v.nhwc:
        return v.t
    if v.host is not None:
        h = v.host.reshape((1,) * (4 - v.host.ndim) + v.host.shape)
        return tf.constant(np.ascontiguousarray(h.transpose(_P)))
    t = v.t
    if len(t.shape) < 4:
        t = tf.reshape(t, [1] * (4 - len(t.shape)) + t.shape.as_list())
    return tf.transpose(t, _P)


def _host(v):
    """A shape-like input's values as a list of ints (or floats)."""
    if v.host is None:
        raise UnsupportedOp("to_tf: a shape, axes or pads input computed in the graph")
    return v.host.reshape(-1).tolist()


def _axis(a, rank, nhwc):
    a %= rank
    return _PINV[a] if nhwc else a


def _carry(vs):
    """Whether an op over vs (broadcasting) runs nhwc: some input is nhwc
    and none has rank > 4."""
    return any(v.nhwc for v in vs) and all(v.rank <= 4 for v in vs)


def _nary(tf, vs, f):
    if _carry(vs):
        return _V(f(*[_nhwc(tf, v) for v in vs]), nhwc=True)
    return _V(f(*[_logical(tf, v) for v in vs]))


# ---------------------------------------------------------------------------
# ops


def _div(tf, a, b):
    return tf.truncatediv(a, b) if a.dtype.is_integer else tf.math.truediv(a, b)


_BINARY = {
    "Add": lambda tf: tf.add, "Sub": lambda tf: tf.subtract, "Mul": lambda tf: tf.multiply,
    "Div": lambda tf: lambda a, b: _div(tf, a, b), "Pow": lambda tf: tf.pow,
    "Greater": lambda tf: tf.greater, "GreaterOrEqual": lambda tf: tf.greater_equal,
    "Less": lambda tf: tf.less, "LessOrEqual": lambda tf: tf.less_equal,
    "Equal": lambda tf: tf.equal, "And": lambda tf: tf.logical_and,
    "Or": lambda tf: tf.logical_or, "Xor": lambda tf: tf.math.logical_xor,
}
_UNARY = {
    "Sigmoid": lambda tf: tf.sigmoid, "Sqrt": lambda tf: tf.sqrt,
    "Reciprocal": lambda tf: tf.math.reciprocal, "Exp": lambda tf: tf.exp,
    "Log": lambda tf: tf.math.log, "Tanh": lambda tf: tf.tanh, "Neg": lambda tf: tf.negative,
    "Abs": lambda tf: tf.abs, "Floor": lambda tf: tf.floor, "Ceil": lambda tf: tf.math.ceil,
    "Sign": lambda tf: tf.sign, "Not": lambda tf: tf.logical_not,
    "Identity": lambda tf: tf.identity,
}


def _binary(tf, op, a, ins):
    return _nary(tf, ins[:2], _BINARY[op](tf))


def _unary(tf, op, a, ins):
    v = ins[0]
    return _V(_UNARY[op](tf)(_tensor(tf, v)), nhwc=v.nhwc)


def _same_pads(k, s, d, lo, hi):
    """Whether TF's SAME padding equals the ONNX pads (stride 1 only: with
    a stride TF pads the end first)."""
    return all(si == 1 and l == h == (di * (ki - 1)) // 2 and (di * (ki - 1)) % 2 == 0
               for ki, si, di, l, h in zip(k, s, d, lo, hi))


def _spatial_pad(tf, x, lo, hi, value=0):
    """Pad an nhwc tensor's H and W by the ONNX begin/end pads ``lo``/``hi``."""
    if not any(lo) and not any(hi):
        return x
    return tf.pad(x, [[0, 0], [lo[0], hi[0]], [lo[1], hi[1]], [0, 0]], constant_values=value)


def _conv(tf, op, a, ins):
    x, w = _nhwc(tf, ins[0]), ins[1].host
    if w is None or w.ndim != 4:
        raise UnsupportedOp("to_tf: Conv needs a constant 4-D (OIHW) weight")
    c_out, c_in_g, kh, kw = w.shape
    s = list(a.get("strides", [1, 1]))
    d = list(a.get("dilations", [1, 1]))
    pads = list(a.get("pads", [0, 0, 0, 0]))
    lo, hi = pads[:2], pads[2:]
    if _same_pads((kh, kw), s, d, lo, hi):
        padding = "SAME"
    else:
        x, padding = _spatial_pad(tf, x, lo, hi), "VALID"
    groups = a.get("group", 1)
    c_in = c_in_g * groups
    strides = [1, s[0], s[1], 1]
    if groups == 1:
        y = tf.nn.conv2d(x, tf.constant(np.ascontiguousarray(w.transpose(2, 3, 1, 0))),
                         strides, padding, dilations=d)
    elif groups == c_in and c_in_g == 1 and s[0] == s[1]:
        # depthwise: output channel i * mult + m reads input channel i
        mult = c_out // c_in
        f = w.reshape(c_in, mult, kh, kw).transpose(2, 3, 0, 1)
        y = tf.nn.depthwise_conv2d(x, tf.constant(np.ascontiguousarray(f)), strides, padding,
                                   dilations=d)
    else:  # TF's CPU Conv2D refuses groups: one conv per group, concatenated
        xs = tf.split(x, groups, axis=3)
        ws = np.split(w, groups, axis=0)
        y = tf.concat([tf.nn.conv2d(xi, tf.constant(np.ascontiguousarray(wi.transpose(2, 3, 1, 0))),
                                    strides, padding, dilations=d)
                       for xi, wi in zip(xs, ws)], axis=3)
    if len(ins) > 2 and ins[2] is not None:
        y = tf.nn.bias_add(y, _tensor(tf, ins[2]))
    return _V(y, nhwc=True)


def _maxpool(tf, op, a, ins):
    k = list(a["kernel_shape"])
    if a.get("ceil_mode", 0) or any(d != 1 for d in a.get("dilations", [1, 1])):
        raise UnsupportedOp("to_tf: MaxPool with ceil_mode or dilations")
    pads = list(a.get("pads", [0, 0, 0, 0]))
    x = _nhwc(tf, ins[0])
    # pad with the lowest value, which never wins the max, then VALID
    x = _spatial_pad(tf, x, pads[:2], pads[2:], value=x.dtype.min)
    s = list(a.get("strides", k))
    return _V(tf.nn.max_pool2d(x, k, [1, s[0], s[1], 1], "VALID"), nhwc=True)


def _resize(tf, op, a, ins):
    if a.get("mode", "nearest") != "nearest":
        raise UnsupportedOp(f"to_tf: Resize mode {a.get('mode')!r}")
    f = [float(s) for s in _host(ins[2])]
    if len(f) != 4 or f[:2] != [1.0, 1.0] or any(s != int(s) for s in f[2:]):
        raise UnsupportedOp(f"to_tf: Resize by scales {f}: only integer spatial factors")
    x = _nhwc(tf, ins[0])
    h, w = x.shape[1], x.shape[2]
    # nearest, asymmetric, floor: each pixel repeated, as runtime._resize
    y = tf.raw_ops.ResizeNearestNeighbor(images=x, size=[h * int(f[2]), w * int(f[3])],
                                         align_corners=False, half_pixel_centers=False)
    return _V(y, nhwc=True)


def _maxmin(tf, op, a, ins):
    fn = tf.maximum if op == "Max" else tf.minimum

    def f(*ts):
        out = ts[0]
        for t in ts[1:]:
            out = fn(out, t)
        return out

    return _nary(tf, ins, f)


def _where(tf, op, a, ins):
    return _nary(tf, ins, lambda c, x, y: tf.where(tf.cast(c, tf.bool), x, y))


_TF_DTYPES = {proto.FLOAT: "float32", proto.DOUBLE: "float64", proto.FLOAT16: "float16",
              proto.BFLOAT16: "float32", proto.UINT8: "uint8", proto.INT8: "int8",
              proto.INT16: "int16", proto.INT32: "int32", proto.INT64: "int64",
              proto.BOOL: "bool"}


def _cast(tf, op, a, ins):
    v = ins[0]
    return _V(tf.cast(_tensor(tf, v), getattr(tf, _TF_DTYPES[a["to"]])), nhwc=v.nhwc)


def _concat(tf, op, a, ins):
    rank = ins[0].rank
    if _carry(ins) and rank == 4:
        return _V(tf.concat([_nhwc(tf, v) for v in ins], _axis(a["axis"], 4, True)), nhwc=True)
    return _V(tf.concat([_logical(tf, v) for v in ins], a["axis"] % rank))


def _reshape(tf, op, a, ins):
    x = _logical(tf, ins[0])
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(_host(ins[1]))]
    return _V(tf.reshape(x, shape))


def _transpose(tf, op, a, ins):
    v = ins[0]
    r = v.rank
    perm = list(a.get("perm", list(range(r))[::-1]))
    # the held tensor's axis for each output axis, for a plain output ...
    # (where neither output needs no transpose, the plain one is made: its
    # consumers, a Reshape or the graph's output, need the ONNX order)
    src = [_PINV[p] for p in perm] if v.nhwc else perm
    if r == 4 and [src[p] for p in _P] == list(range(4)):  # ... and for an nhwc one
        return _V(_tensor(tf, v), nhwc=True)
    t = _tensor(tf, v)
    return _V(t if src == list(range(r)) else tf.transpose(t, src))


def _slice(tf, op, a, ins):
    v = ins[0]
    starts, ends = _host(ins[1]), _host(ins[2])
    r = v.rank
    axes = _host(ins[3]) if len(ins) > 3 and ins[3] is not None else list(range(len(starts)))
    steps = _host(ins[4]) if len(ins) > 4 and ins[4] is not None else [1] * len(starts)
    shape = v.shape
    idx = [slice(None)] * r
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        if sp <= 0:
            raise UnsupportedOp(f"to_tf: Slice with step {sp}")
        ax %= r
        n = shape[ax]
        st, en = (max(0, min(x + n if x < 0 else x, n)) for x in (st, en))
        idx[_axis(ax, r, v.nhwc)] = slice(st, en, sp)
    return _V(_tensor(tf, v)[tuple(idx)], nhwc=v.nhwc)


def _pad(tf, op, a, ins):
    if a.get("mode", "constant") != "constant":
        raise UnsupportedOp(f"to_tf: Pad mode {a.get('mode')!r}")
    v = ins[0]
    r = v.rank
    pads = _host(ins[1])
    pairs = [[int(pads[i]), int(pads[i + r])] for i in range(r)]
    if v.nhwc:
        pairs = [pairs[p] for p in _P]
    value = float(_host(ins[2])[0]) if len(ins) > 2 and ins[2] is not None else 0.0
    return _V(tf.pad(_tensor(tf, v), pairs, constant_values=value), nhwc=v.nhwc)


def _expand(tf, op, a, ins):
    x = _logical(tf, ins[0])
    shape = np.broadcast_shapes(tuple(x.shape.as_list()), tuple(_host(ins[1])))
    return _V(tf.broadcast_to(x, shape))


def _matmul(tf, op, a, ins):
    return _V(tf.linalg.matmul(_logical(tf, ins[0]), _logical(tf, ins[1])))


def _gemm(tf, op, a, ins):
    x = tf.linalg.matmul(_logical(tf, ins[0]), _logical(tf, ins[1]),
                         transpose_a=bool(a.get("transA")), transpose_b=bool(a.get("transB")))
    alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
    if alpha != 1.0:
        x = x * alpha
    if len(ins) > 2 and ins[2] is not None:
        c = _logical(tf, ins[2])
        x = x + (c * beta if beta != 1.0 else c)
    return _V(x)


_REDUCE = {"ReduceSum": "reduce_sum", "ReduceMax": "reduce_max", "ReduceMin": "reduce_min",
           "ReduceProd": "reduce_prod"}


def _reduce(tf, op, a, ins):
    v = ins[0]
    r = v.rank
    axes = a.get("axes")
    if axes is None and len(ins) > 1 and ins[1] is not None:
        axes = _host(ins[1])
    axes = list(range(r)) if not axes else [x % r for x in axes]
    keep = bool(a.get("keepdims", 1))
    fn = getattr(tf, _REDUCE[op])
    if v.nhwc and keep:
        return _V(fn(v.t, [_PINV[x] for x in axes], keepdims=True), nhwc=True)
    return _V(fn(_logical(tf, v), axes, keepdims=keep))


def _softmax(tf, op, a, ins):
    v = ins[0]
    return _V(tf.nn.softmax(_tensor(tf, v), axis=_axis(a.get("axis", -1), v.rank, v.nhwc)),
              nhwc=v.nhwc)


def _clip(tf, op, a, ins):
    v = ins[0]
    x = _tensor(tf, v)
    if len(ins) > 1 and ins[1] is not None:
        x = tf.maximum(x, _tensor(tf, ins[1]))
    if len(ins) > 2 and ins[2] is not None:
        x = tf.minimum(x, _tensor(tf, ins[2]))
    return _V(x, nhwc=v.nhwc)


def _batchnorm(tf, op, a, ins):
    x = _nhwc(tf, ins[0]) if ins[0].rank == 4 else _logical(tf, ins[0])
    scale, bias, mean, var = (_host(v) for v in ins[1:5])
    eps = a.get("epsilon", 1e-5)
    mul = np.asarray(scale, np.float32) / np.sqrt(np.asarray(var, np.float32) + np.float32(eps))
    add = np.asarray(bias, np.float32) - np.asarray(mean, np.float32) * mul
    if ins[0].rank != 4:  # channels on axis 1
        shape = [1, -1] + [1] * (ins[0].rank - 2)
        mul, add = mul.reshape(shape), add.reshape(shape)
    return _V(x * tf.constant(mul) + tf.constant(add), nhwc=ins[0].rank == 4)


_OPS = {**{k: _binary for k in _BINARY}, **{k: _unary for k in _UNARY},
        "Conv": _conv, "MaxPool": _maxpool, "Resize": _resize, "Max": _maxmin,
        "Min": _maxmin, "Where": _where, "Cast": _cast, "Concat": _concat,
        "Reshape": _reshape, "Transpose": _transpose, "Slice": _slice, "Pad": _pad,
        "Expand": _expand, "MatMul": _matmul, "Gemm": _gemm,
        **{k: _reduce for k in _REDUCE}, "Softmax": _softmax, "Clip": _clip,
        "BatchNormalization": _batchnorm}


# ---------------------------------------------------------------------------
# the NMS of an --nms export

def _argsort_desc(tf, x):
    """Descending order of (bs, M), ties to the lower index (``lax.top_k``'s
    and ``ops.nms._select_k``'s order): TF's stable descending argsort is a
    full-length top_k, which puts the lower index first among equals."""
    return tf.argsort(x, axis=-1, direction="DESCENDING", stable=True)


def _iou(tf, b):
    """(bs, K, 4) xyxy -> (bs, K, K) IoU, as ``ops.nms_kernel._iou``."""
    x1, y1, x2, y2 = (b[..., i] for i in range(4))
    iw = tf.maximum(tf.minimum(x2[:, :, None], x2[:, None, :])
                    - tf.maximum(x1[:, :, None], x1[:, None, :]), 0.0)
    ih = tf.maximum(tf.minimum(y2[:, :, None], y2[:, None, :])
                    - tf.maximum(y1[:, :, None], y1[:, None, :]), 0.0)
    inter = iw * ih
    area = tf.maximum(x2 - x1, 0.0) * tf.maximum(y2 - y1, 0.0)
    return inter / (area[:, :, None] + area[:, None, :] - inter + 1e-7)


def non_max_suppression_tf(pred, conf_thres=0.25, iou_thres=0.45, max_det=100, max_nms=1024):
    """``ops.nms.non_max_suppression(pred, ..., traceable=True)`` (one label
    a box, class offsets, no class filter) in TF ops: decoded (bs, N, 5 + nc)
    -> (boxes (bs, max_det, 4) float32, scores (bs, max_det), classes
    (bs, max_det) int32, valid (bs, max_det) bool). The greedy walk is
    ``ops.nms_kernel.greedy_nms_traceable``'s: one candidate a step of a
    ``tf.while_loop`` over the whole batch, over (bs, K, K) overlaps
    computed once."""
    tf = import_tensorflow()

    bs, n, no = pred.shape
    nc = no - 5
    conf = float(np.float32(conf_thres))
    cls_scores = pred[..., 5:5 + nc] * pred[..., 4:5]
    cx, cy, w, h = (pred[..., i] for i in range(4))
    boxes = tf.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)
    best = tf.reduce_max(cls_scores, -1)
    best = tf.where(best > conf, best, tf.zeros_like(best))
    k = min(max_nms, n)
    order = _argsort_desc(tf, best)[:, :k]
    top_scores = tf.gather(best, order, batch_dims=1)
    cls_idx = tf.gather(tf.argmax(cls_scores, -1, output_type=tf.int32), order, batch_dims=1)
    top_boxes = tf.gather(boxes, order, batch_dims=1)

    nms_boxes = top_boxes + (tf.cast(cls_idx, tf.float32) * MAX_WH)[..., None]
    idx = tf.range(k)
    earlier = idx[:, None] < idx[None, :]
    over = (_iou(tf, nms_boxes) > float(np.float32(iou_thres))) & earlier[None]  # (bs, K, K)
    live = tf.concat([top_scores > 0, tf.zeros((bs, 1), tf.bool)], 1)

    def cond(i, keep, n_kept):
        return tf.reduce_any(live[:, i] & (n_kept < max_det))

    def body(i, keep, n_kept):
        hit = tf.reduce_any(over[:, :, i] & keep, 1)
        new = live[:, i] & (n_kept < max_det) & ~hit
        keep = keep | ((idx == i)[None, :] & new[:, None])
        return i + 1, keep, n_kept + tf.cast(new, tf.int32)

    start = (tf.constant(0), tf.zeros((bs, k), tf.bool), tf.zeros((bs,), tf.int32))
    keep = tf.while_loop(cond, body, start)[1]

    kept = tf.where(keep, top_scores, tf.zeros_like(top_scores))
    md = min(max_det, k)
    order = _argsort_desc(tf, kept)[:, :md]
    scores = tf.gather(kept, order, batch_dims=1)
    out_boxes = tf.gather(top_boxes, order, batch_dims=1)
    classes = tf.gather(cls_idx, order, batch_dims=1)
    if md < max_det:  # pad to the static output size
        pad = max_det - md
        scores = tf.pad(scores, [[0, 0], [0, pad]])
        out_boxes = tf.pad(out_boxes, [[0, 0], [0, pad], [0, 0]])
        classes = tf.pad(classes, [[0, 0], [0, pad]])
    return out_boxes, scores, classes, scores > 0
