"""torch.export -> ONNX converter.

The port's counterpart of ``yolov5_tpu/onnx/convert.py``, which lowers a
jaxpr: this module lowers the core ATen graph of
``torch.export.export(module, (example,)).run_decompositions()`` to an ONNX
(opset 13) model, serialised by :mod:`.proto`, with no ``onnx`` package.

- **One handler per op.** Every ATen op of the graph maps to 0-3 ONNX nodes;
  an op without a handler raises ``UnsupportedOp`` naming it. Handlers see
  the decomposed graph, so composite ops (``silu``, ``hardswish``, ``mish``)
  reach them only on torch versions whose default decompositions keep them,
  and each has one.
- **Host constant folding.** A node whose inputs are all constants
  (parameters, buffers, lifted constants, Python scalars) is evaluated on
  the host and becomes a constant: the decode's ``arange``/``expand`` grids,
  anchors and strides (``models/layers.py`` ``decode_level``) end up as
  initializers.
- **NCHW throughout.** The traced module computes in NCHW, so there is no
  layout pass: a Transpose is emitted only for a ``permute`` of the graph
  (the input's NHWC -> NCHW, the Detect head's views, attention).
  ``clone``, a copy that changes nothing but the memory format, and
  ``_assert_tensor_metadata`` emit nothing.
- **Only ops that both runtimes know** (the op table of
  ``yolov5_tpu/onnx/runtime.py`` and of :mod:`.runtime`), as the JAX
  converter emits them: SiLU as Sigmoid + Mul, LeakyReLU as GreaterOrEqual
  + Where, a mean as ReduceSum times 1/n, a square as Mul, nearest upsample
  as Resize (nearest, floor, asymmetric). Opset 13's ReduceSum takes its
  axes as an input, the other Reduce ops as an attribute.
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from . import proto

OPSET = 13

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
              torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


class UnsupportedOp(NotImplementedError):
    """An op of the traced graph that has no ONNX lowering here."""


def _np_dtype(dtype):
    if dtype not in _NP_DTYPES:
        raise UnsupportedOp(f"no ONNX data type for {dtype}")
    return np.dtype(_NP_DTYPES[dtype])


def _host(value):
    """A constant as a numpy array (a tensor's values, a Python scalar's)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class _Builder:
    """The graph being written: nodes, initializers (deduplicated by value)
    and a record per FX value: ("g", onnx name, dtype, shape) for a graph
    value, ("c", value) for a host constant, ("m", [records]) for an op with
    several outputs, ("none",) for an op without one."""

    def __init__(self):
        self.nodes: list[bytes] = []
        self.initializers: list[bytes] = []
        self._consts: dict[tuple, str] = {}
        self._n = 0
        self.vals: dict[str, tuple] = {}

    def fresh(self, hint):
        self._n += 1
        return f"{hint}_{self._n}"

    def emit(self, op, inputs, attrs=None, hint=None, outputs=None):
        out = outputs or [self.fresh(hint or op.lower())]
        self.nodes.append(proto.node(op, inputs, out, name=self.fresh(f"n_{op}"), attrs=attrs))
        return out[0] if len(out) == 1 else out

    def initializer(self, arr: np.ndarray, hint="const"):
        arr = np.ascontiguousarray(arr)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        if key not in self._consts:
            name = self.fresh(hint)
            self.initializers.append(proto.tensor(name, arr))
            self._consts[key] = name
        return self._consts[key]

    def i64(self, values, hint="shape"):
        return self.initializer(np.asarray(values, np.int64), hint)

    # -- values -----------------------------------------------------------
    def rec(self, a):
        if isinstance(a, torch.fx.Node):
            return self.vals[a.name]
        return ("c", a)

    def is_const(self, a):
        if isinstance(a, (list, tuple)):
            return all(self.is_const(x) for x in a)
        return self.rec(a)[0] == "c"

    def const(self, a):
        if isinstance(a, (list, tuple)):
            return type(a)(self.const(x) for x in a)
        return self.rec(a)[1]

    def dtype(self, a):
        r = self.rec(a)
        if r[0] == "g":
            return r[2]
        v = r[1]
        return v.dtype if isinstance(v, torch.Tensor) else torch.tensor(v).dtype

    def shape(self, a):
        r = self.rec(a)
        return list(r[3]) if r[0] == "g" else list(np.shape(_host(r[1])))

    def name(self, a, dtype=None, hint="c"):
        """The ONNX name of tensor argument ``a``, in ``dtype`` when given: a
        graph value (through a Cast when its dtype differs) or a constant as
        an initializer."""
        r = self.rec(a)
        if r[0] == "c":
            arr = _host(r[1])
            if dtype is not None:
                arr = arr.astype(_np_dtype(dtype))
            return self.initializer(arr, hint)
        if r[0] != "g":
            raise UnsupportedOp(f"value {a} is not a tensor")
        if dtype is not None and dtype != r[2]:
            return self.emit("Cast", [r[1]], attrs={"to": proto.onnx_dtype(_np_dtype(dtype))})
        return r[1]


def _out(node):
    """(dtype, shape) of an FX node's (first) output, from its meta."""
    v = node.meta["val"]
    if isinstance(v, (list, tuple)):
        v = v[0]
    return v.dtype, tuple(int(s) for s in v.shape)


def _set(b, node, onnx_name):
    dtype, shape = _out(node)
    b.vals[node.name] = ("g", onnx_name, dtype, shape)


def _alias(b, node, a):
    b.vals[node.name] = b.rec(a)


# ---------------------------------------------------------------------------
# handlers: (the _Builder, the FX node, its args, its kwargs)

_BINARY = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div", "pow": "Pow",
           "maximum": "Max", "minimum": "Min"}
_COMPARE = {"ge": "GreaterOrEqual", "gt": "Greater", "le": "LessOrEqual", "lt": "Less",
            "eq": "Equal"}
_LOGICAL = {"logical_and": "And", "logical_or": "Or", "logical_xor": "Xor",
            "bitwise_and": "And", "bitwise_or": "Or", "bitwise_xor": "Xor"}
_UNARY = {"sigmoid": "Sigmoid", "exp": "Exp", "log": "Log", "tanh": "Tanh", "sqrt": "Sqrt",
          "neg": "Neg", "abs": "Abs", "floor": "Floor", "ceil": "Ceil", "sign": "Sign",
          "reciprocal": "Reciprocal", "logical_not": "Not", "bitwise_not": "Not"}
# ops that only change what a tensor is called, its strides or its memory format
_ALIASES = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous", "view_as",
            "_conj", "dropout"}


def _binary(b, node, args, kwargs, op):
    dtype, _ = _out(node)
    x, y = args[0], args[1]
    alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
    if op == "div" and kwargs.get("rounding_mode") is not None:
        raise UnsupportedOp(f"div with rounding_mode={kwargs['rounding_mode']!r}")
    if op == "pow" and not isinstance(y, torch.fx.Node) and float(y) == 2.0:
        xn = b.name(x, dtype)
        _set(b, node, b.emit("Mul", [xn, xn], hint="sq"))
        return
    yn = b.name(y, dtype)
    if alpha != 1:
        yn = b.emit("Mul", [yn, b.initializer(np.asarray(alpha, _np_dtype(dtype)))])
    _set(b, node, b.emit(_BINARY[op], [b.name(x, dtype), yn], hint=op))


def _compare(b, node, args, kwargs, op):
    dtype = torch.result_type(
        *[torch.empty((), dtype=b.dtype(a)) if isinstance(a, torch.fx.Node) else a
          for a in args[:2]])
    x, y = b.name(args[0], dtype), b.name(args[1], dtype)
    if op == "ne":
        out = b.emit("Not", [b.emit("Equal", [x, y])], hint="ne")
    else:
        out = b.emit(_COMPARE[op], [x, y], hint=op)
    _set(b, node, out)


def _scalar(b, value, dtype):
    return b.initializer(np.asarray(value, _np_dtype(dtype)), "s")


def _unary(b, node, args, kwargs, op):
    x = b.name(args[0])
    dtype, _ = _out(node)
    if op == "rsqrt":
        out = b.emit("Reciprocal", [b.emit("Sqrt", [x])], hint="rsqrt")
    elif op == "log1p":
        out = b.emit("Log", [b.emit("Add", [x, _scalar(b, 1, dtype)])], hint="log1p")
    elif op == "relu":
        out = b.emit("Max", [x, _scalar(b, 0, dtype)], hint="relu")
    elif op == "silu":
        out = b.emit("Mul", [x, b.emit("Sigmoid", [x])], hint="silu")
    elif op == "leaky_relu":
        slope = args[1] if len(args) > 1 else kwargs.get("negative_slope", 0.01)
        ge = b.emit("GreaterOrEqual", [x, _scalar(b, 0, dtype)])
        neg = b.emit("Mul", [x, _scalar(b, slope, dtype)])
        out = b.emit("Where", [ge, x, neg], hint="leaky")
    elif op in ("hardswish", "hardsigmoid"):
        t = b.emit("Clip", [b.emit("Add", [x, _scalar(b, 3, dtype)]), _scalar(b, 0, dtype),
                            _scalar(b, 6, dtype)])
        t = b.emit("Div", [t, _scalar(b, 6, dtype)])
        out = b.emit("Mul", [x, t], hint=op) if op == "hardswish" else t
    elif op == "mish":  # x * tanh(log(1 + exp(x)))
        sp = b.emit("Log", [b.emit("Add", [b.emit("Exp", [x]), _scalar(b, 1, dtype)])])
        out = b.emit("Mul", [x, b.emit("Tanh", [sp])], hint="mish")
    else:
        out = b.emit(_UNARY[op], [x], hint=op)
    _set(b, node, out)


def _clamp(b, node, args, kwargs):
    dtype, _ = _out(node)
    lo = args[1] if len(args) > 1 else kwargs.get("min")
    hi = args[2] if len(args) > 2 else kwargs.get("max")
    big = np.finfo(_np_dtype(dtype)).max if dtype.is_floating_point else \
        np.iinfo(_np_dtype(dtype)).max
    # both bounds always given: a runtime that drops empty inputs keeps them apart
    lo_n = b.name(lo, dtype) if lo is not None else _scalar(b, -big, dtype)
    hi_n = b.name(hi, dtype) if hi is not None else _scalar(b, big, dtype)
    _set(b, node, b.emit("Clip", [b.name(args[0], dtype), lo_n, hi_n], hint="clip"))


def _where(b, node, args, kwargs):
    dtype, _ = _out(node)
    _set(b, node, b.emit("Where", [b.name(args[0]), b.name(args[1], dtype),
                                   b.name(args[2], dtype)], hint="where"))


def _convolution(b, node, args, kwargs):
    x, w, bias, stride, padding, dilation, transposed, _, groups = args[:9]
    if transposed:
        raise UnsupportedOp("convolution: transposed convolution has no lowering "
                            "(the runtimes know no ConvTranspose)")
    if not b.is_const(w) or (bias is not None and not b.is_const(bias)):
        raise UnsupportedOp("convolution: weights computed in the graph")
    wa = _host(b.const(w)).astype(np.float32)
    inputs = [b.name(x), b.initializer(wa, "weight")]
    if bias is not None:
        inputs.append(b.initializer(_host(b.const(bias)).astype(np.float32), "bias"))
    attrs = {"strides": list(stride), "pads": list(padding) * 2, "dilations": list(dilation),
             "group": int(groups), "kernel_shape": list(wa.shape[2:])}
    _set(b, node, b.emit("Conv", inputs, attrs=attrs, hint="conv"))


def _max_pool(b, node, args, kwargs):
    x, k = args[0], list(args[1])
    stride = list(args[2]) if len(args) > 2 and args[2] else k
    pad = args[3] if len(args) > 3 else 0
    dil = args[4] if len(args) > 4 else 1
    ceil = args[5] if len(args) > 5 else False
    pad = list(pad) if isinstance(pad, (list, tuple)) else [pad, pad]
    dil = list(dil) if isinstance(dil, (list, tuple)) else [dil, dil]
    if ceil or any(d != 1 for d in dil):
        raise UnsupportedOp("max_pool2d with ceil_mode or dilation")
    out = b.emit("MaxPool", [b.name(x)], hint="pool",
                 attrs={"kernel_shape": k, "strides": stride, "pads": pad * 2})
    dtype, shape = _out(node)
    rec = ("g", out, dtype, shape)
    if node.target._overloadpacket.__name__ == "max_pool2d_with_indices":
        b.vals[node.name] = ("m", [rec, None])  # the indices: see _getitem
    else:
        b.vals[node.name] = rec


def _upsample_nearest(b, node, args, kwargs):
    x = args[0]
    _, (_, _, h, w) = _out(node)
    _, _, h0, w0 = b.shape(x)
    if h % h0 or w % w0:
        raise UnsupportedOp(f"upsample_nearest2d by a non-integer factor ({h0}x{w0} -> {h}x{w})")
    scales = b.initializer(np.array([1.0, 1.0, h / h0, w / w0], np.float32), "scales")
    roi = b.initializer(np.zeros(0, np.float32), "roi")
    _set(b, node, b.emit("Resize", [b.name(x), roi, scales], hint="resize",
                         attrs={"mode": "nearest", "nearest_mode": "floor",
                                "coordinate_transformation_mode": "asymmetric"}))


def _cat(b, node, args, kwargs):
    tensors = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    dtype, shape = _out(node)
    names = [b.name(t, dtype) for t in tensors
             if not (b.is_const(t) and 0 in np.shape(_host(b.const(t))))]
    _set(b, node, b.emit("Concat", names, attrs={"axis": int(dim) % len(shape)}, hint="cat"))


def _reshape(b, node, args, kwargs):
    _, shape = _out(node)
    _set(b, node, b.emit("Reshape", [b.name(args[0]), b.i64(shape)], hint="reshape"))


def _permute(b, node, args, kwargs):
    rank = len(b.shape(args[0]))
    op = node.target._overloadpacket.__name__
    if op == "permute":
        perm = [int(d) % rank for d in args[1]]
    else:  # transpose(x, d0, d1) / t(x)
        d0, d1 = (args[1], args[2]) if op == "transpose" else (0, 1)
        perm = list(range(rank))
        perm[d0 % rank], perm[d1 % rank] = perm[d1 % rank], perm[d0 % rank]
    if perm == list(range(rank)):
        _alias(b, node, args[0])
        return
    _set(b, node, b.emit("Transpose", [b.name(args[0])], attrs={"perm": perm}, hint="tr"))


def _expand(b, node, args, kwargs):
    _, shape = _out(node)
    if tuple(b.shape(args[0])) == shape:
        _alias(b, node, args[0])
        return
    _set(b, node, b.emit("Expand", [b.name(args[0]), b.i64(shape)], hint="expand"))


def _slice_node(b, x, dim, start, end, step, rank):
    return b.emit("Slice", [b.name(x), b.i64([start], "starts"), b.i64([end], "ends"),
                            b.i64([dim % rank], "axes"), b.i64([step], "steps")], hint="slice")


def _slice(b, node, args, kwargs):
    x = args[0]
    shape = b.shape(x)
    dim = args[1] if len(args) > 1 else 0
    start = args[2] if len(args) > 2 and args[2] is not None else 0
    end = args[3] if len(args) > 3 and args[3] is not None else shape[dim]
    step = args[4] if len(args) > 4 else 1
    n = shape[dim]
    start, end = (max(0, min(s + n if s < 0 else s, n)) for s in (start, end))
    if (start, end, step) == (0, n, 1):
        _alias(b, node, x)
        return
    _set(b, node, _slice_node(b, x, dim, start, end, step, len(shape)))


def _select(b, node, args, kwargs):
    x, dim, index = args
    shape = b.shape(x)
    index = index % shape[dim]
    s = _slice_node(b, x, dim, index, index + 1, 1, len(shape))
    _, out_shape = _out(node)
    _set(b, node, b.emit("Reshape", [s, b.i64(out_shape)], hint="select"))


def _split(b, node, args, kwargs):
    x = args[0]
    shape = b.shape(x)
    dim = args[2] if len(args) > 2 else kwargs.get("dim", 0)
    n = shape[dim]
    if node.target._overloadpacket.__name__ == "split_with_sizes":
        sizes = list(args[1])
    else:
        sizes = [min(args[1], n - s) for s in range(0, n, args[1])]
    recs, start = [], 0
    dtype = b.dtype(x)
    for size, v in zip(sizes, node.meta["val"]):
        name = _slice_node(b, x, dim, start, start + size, 1, len(shape))
        recs.append(("g", name, dtype, tuple(int(s) for s in v.shape)))
        start += size
    b.vals[node.name] = ("m", recs)


def _pad(b, node, args, kwargs):
    x, pad = args[0], list(args[1])
    value = args[2] if len(args) > 2 else kwargs.get("value", 0.0)
    rank = len(b.shape(x))
    if any(p < 0 for p in pad):
        raise UnsupportedOp("constant_pad_nd with negative padding")
    lo, hi = [0] * rank, [0] * rank
    for j in range(len(pad) // 2):  # torch pads from the last dim backwards
        lo[rank - 1 - j], hi[rank - 1 - j] = pad[2 * j], pad[2 * j + 1]
    dtype = b.dtype(x)
    _set(b, node, b.emit("Pad", [b.name(x), b.i64(lo + hi, "pads"),
                                 _scalar(b, value or 0, dtype)], hint="pad"))


def _to_copy(b, node, args, kwargs):
    dtype, _ = _out(node)
    if dtype == b.dtype(args[0]):
        _alias(b, node, args[0])
        return
    _set(b, node, b.name(args[0], dtype))


def _matmul(b, node, args, kwargs):
    op = node.target._overloadpacket.__name__
    if op == "addmm":
        bias, x, w = args[:3]
        beta = kwargs.get("beta", 1)
        alpha = kwargs.get("alpha", 1)
        out = b.emit("Gemm", [b.name(x), b.name(w), b.name(bias)], hint="gemm",
                     attrs={"alpha": float(alpha), "beta": float(beta)})
    else:  # mm, bmm, matmul
        out = b.emit("MatMul", [b.name(args[0]), b.name(args[1])], hint="mm")
    _set(b, node, out)


def _softmax(b, node, args, kwargs):
    rank = len(b.shape(args[0]))
    _set(b, node, b.emit("Softmax", [b.name(args[0])], attrs={"axis": int(args[1]) % rank},
                         hint="softmax"))


def _reduce(b, node, args, kwargs):
    op = node.target._overloadpacket.__name__
    x = args[0]
    shape = b.shape(x)
    dims = args[1] if len(args) > 1 and args[1] is not None else []
    dims = [int(d) % len(shape) for d in ([dims] if isinstance(dims, int) else dims)] \
        or list(range(len(shape)))
    keep = int(bool(args[2] if len(args) > 2 else kwargs.get("keepdim", False)))
    dtype, _ = _out(node)
    if op == "amax":
        out = b.emit("ReduceMax", [b.name(x)], attrs={"axes": dims, "keepdims": keep})
    else:  # opset 13: ReduceSum takes its axes as an input
        out = b.emit("ReduceSum", [b.name(x, dtype), b.i64(dims, "axes")],
                     attrs={"keepdims": keep}, hint="rsum")
        if op == "mean":
            n = math.prod(shape[d] for d in dims)
            out = b.emit("Mul", [out, _scalar(b, 1.0 / n, dtype)], hint="mean")
    _set(b, node, out)


def _getitem(b, node, args, kwargs):
    r = b.rec(args[0])
    if r[0] != "m" or r[1][args[1]] is None:
        raise UnsupportedOp(f"getitem {args[1]} of {args[0]}: max_pool2d's indices "
                            "have no lowering")
    b.vals[node.name] = r[1][args[1]]


_HANDLERS = {
    **{op: (lambda o: lambda b, n, a, k: _binary(b, n, a, k, o))(op) for op in _BINARY},
    **{op: (lambda o: lambda b, n, a, k: _compare(b, n, a, k, o))(op) for op in (*_COMPARE, "ne")},
    **{op: (lambda o: lambda b, n, a, k: _set(b, n, b.emit(
        _LOGICAL[o], [b.name(a[0]), b.name(a[1])])))(op) for op in _LOGICAL},
    **{op: (lambda o: lambda b, n, a, k: _unary(b, n, a, k, o))(op)
       for op in (*_UNARY, "rsqrt", "log1p", "relu", "silu", "leaky_relu", "hardswish",
                  "hardsigmoid", "mish")},
    "clamp": _clamp, "where": _where,
    "convolution": _convolution,
    "max_pool2d_with_indices": _max_pool, "max_pool2d": _max_pool,
    "upsample_nearest2d": _upsample_nearest,
    "cat": _cat, "concat": _cat,
    "view": _reshape, "_unsafe_view": _reshape, "reshape": _reshape, "squeeze": _reshape,
    "unsqueeze": _reshape, "flatten": _reshape,
    "permute": _permute, "transpose": _permute, "t": _permute,
    "expand": _expand, "slice": _slice, "select": _select,
    "split_with_sizes": _split, "split": _split,
    "constant_pad_nd": _pad, "_to_copy": _to_copy,
    "mm": _matmul, "bmm": _matmul, "addmm": _matmul, "matmul": _matmul,
    "_softmax": _softmax, "softmax": _softmax,
    "mean": _reduce, "sum": _reduce, "amax": _reduce,
}


def _fold(b, node, args, kwargs):
    """Evaluate a node whose inputs are all constants, on the host."""
    b.vals[node.name] = ("c", node.target(*b.const(tuple(args)),
                                          **{k: b.const(v) for k, v in kwargs.items()}))


def _convert_node(b, node):
    if node.target is operator.getitem:
        if b.is_const(node.args[0]):
            _fold(b, node, node.args, {})
        else:
            _getitem(b, node, node.args, {})
        return
    op = node.target._overloadpacket.__name__
    if op == "_assert_tensor_metadata":
        b.vals[node.name] = ("none",)
        return
    args, kwargs = node.args, dict(node.kwargs)
    tensors = [a for a in (*args, *kwargs.values())
               if isinstance(a, torch.fx.Node)
               or (isinstance(a, (list, tuple)) and any(isinstance(x, torch.fx.Node) for x in a))]
    if all(b.is_const(a) for a in tensors):
        _fold(b, node, args, kwargs)
        return
    if op in _ALIASES:
        _alias(b, node, args[0])
        return
    handler = _HANDLERS.get(op)
    if handler is None:
        raise UnsupportedOp(f"op '{node.target}' has no ONNX lowering")
    handler(b, node, args, kwargs)


def to_onnx(module, example, input_names=None, output_names=None,
            model_name="yolov5_tpu_torch", doc="", metadata=None) -> bytes:
    """Trace ``module(example)`` with ``torch.export`` (decomposed to core
    ATen) and serialise it as an ONNX model. ``module`` runs on the host;
    its outputs (a tensor or a tuple of tensors) become ``output_{i}``."""
    ep = torch.export.export(module, (example,)).run_decompositions()
    return program_to_onnx(ep, input_names=input_names, output_names=output_names,
                           model_name=model_name, doc=doc, metadata=metadata)


def program_to_onnx(ep, input_names=None, output_names=None,
                    model_name="yolov5_tpu_torch", doc="", metadata=None) -> bytes:
    """An ExportedProgram (core ATen, static shapes) as ONNX model bytes."""
    from torch.export.graph_signature import InputKind

    b = _Builder()
    consts = {**ep.state_dict, **ep.constants}
    user = [s for s in ep.graph_signature.input_specs if s.kind == InputKind.USER_INPUT]
    input_names = list(input_names or [f"input_{i}" for i in range(len(user))])
    graph_inputs = []
    for spec in ep.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            name = input_names[len(graph_inputs)]
            node = next(n for n in ep.graph.nodes if n.name == spec.arg.name)
            dtype, shape = _out(node)
            b.vals[spec.arg.name] = ("g", name, dtype, shape)
            graph_inputs.append(proto.value_info(name, proto.onnx_dtype(_np_dtype(dtype)),
                                                 list(shape)))
        elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER, InputKind.CONSTANT_TENSOR):
            b.vals[spec.arg.name] = ("c", consts[spec.target].detach())
        else:
            raise UnsupportedOp(f"graph input of kind {spec.kind}")

    outs = None
    for node in ep.graph.nodes:
        if node.op == "call_function":
            _convert_node(b, node)
        elif node.op == "output":
            outs = node.args[0]
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    output_names = list(output_names or [f"output_{i}" for i in range(len(outs))])
    graph_outputs = []
    for name, out in zip(output_names, outs):
        r = b.rec(out)
        if r[0] == "c":
            arr = _host(r[1])
            b.emit("Identity", [b.initializer(arr, "out_const")], outputs=[name])
            dtype, shape = arr.dtype, list(arr.shape)
        else:
            b.emit("Identity", [r[1]], outputs=[name])
            dtype, shape = _np_dtype(r[2]), list(r[3])
        graph_outputs.append(proto.value_info(name, proto.onnx_dtype(dtype), shape))
    g = proto.graph(b.nodes, model_name, graph_inputs, graph_outputs, b.initializers)
    return proto.model(g, opset=OPSET, producer="yolov5_tpu_torch", doc=doc, metadata=metadata)
