"""A small ONNX runtime on torch tensors, on the card or on the CPU.

The port's counterpart of ``yolov5_tpu/onnx/runtime.py``: it runs every op
of that runtime's table (the ops both packages' converters emit) with torch
on one device, so that ``infer.Detector``, ``val`` and ``detect`` run an
``.onnx`` file, the port's or the JAX package's, on the card. The
initializers are uploaded to the device once, at construction; the integer
inputs that give shapes, axes and pads are read from their host copies, so a
call makes no copy to the host. Each node is one or a few torch calls (about
one kernel launch each): it interprets the graph, it compiles nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import proto

_TORCH_DTYPES = {proto.FLOAT: torch.float32, proto.DOUBLE: torch.float64,
                 proto.FLOAT16: torch.float16, proto.BFLOAT16: torch.float32,
                 proto.UINT8: torch.uint8, proto.INT8: torch.int8, proto.INT16: torch.int16,
                 proto.INT32: torch.int32, proto.INT64: torch.int64, proto.BOOL: torch.bool}


def _pad_pairs(lo, hi):
    """ONNX begin/end pads per axis -> F.pad's list, last axis first."""
    out = []
    for a, b in zip(reversed(lo), reversed(hi)):
        out += [int(a), int(b)]
    return out


def _conv(x, w, b, attrs):
    pads = attrs.get("pads", [0] * (2 * (w.dim() - 2)))
    n = len(pads) // 2
    lo, hi = pads[:n], pads[n:]
    if lo != hi:  # conv2d pads symmetrically: pad first
        x = F.pad(x, _pad_pairs(lo, hi))
        lo = [0] * n
    return F.conv2d(x, w, b, stride=tuple(attrs.get("strides", [1] * n)), padding=tuple(lo),
                    dilation=tuple(attrs.get("dilations", [1] * n)),
                    groups=attrs.get("group", 1))


def _maxpool(x, attrs):
    k = attrs["kernel_shape"]
    pads = attrs.get("pads", [0] * (2 * len(k)))
    if attrs.get("ceil_mode", 0) or any(d != 1 for d in attrs.get("dilations", [1] * len(k))):
        raise NotImplementedError("MaxPool with ceil_mode or dilations")
    if any(pads):  # the padding never wins the max
        x = F.pad(x, _pad_pairs(pads[:len(k)], pads[len(k):]), value=float("-inf"))
    return F.max_pool2d(x, tuple(k), tuple(attrs.get("strides", k)))


def _resize(x, scales, attrs):
    if attrs.get("mode", "nearest") != "nearest":
        raise NotImplementedError(f"Resize mode {attrs.get('mode')!r}")
    f = [float(s) for s in scales]
    if len(f) != 4 or f[:2] != [1.0, 1.0] or any(s != int(s) for s in f[2:]):
        raise NotImplementedError(f"Resize by scales {f}: only integer spatial factors")
    return x.repeat_interleave(int(f[2]), 2).repeat_interleave(int(f[3]), 3)


def _slice(x, starts, ends, axes, steps):
    axes = list(range(len(starts))) if axes is None else axes
    steps = [1] * len(starts) if steps is None else steps
    idx = [slice(None)] * x.dim()
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        if sp <= 0:
            raise NotImplementedError(f"Slice with step {sp}")
        ax %= x.dim()
        n = x.shape[ax]
        st, en = (max(0, min(v + n if v < 0 else v, n)) for v in (st, en))
        idx[ax] = slice(st, en, sp)
    return x[tuple(idx)]


def _reduce(op, x, axes, keep):
    dims = tuple(range(x.dim())) if not axes else tuple(a % x.dim() for a in axes)
    if op == "ReduceSum":
        return x.sum(dims, keepdim=keep)
    if op == "ReduceMax":
        return x.amax(dims, keepdim=keep)
    if op == "ReduceMin":
        return x.amin(dims, keepdim=keep)
    for d in sorted(dims, reverse=True):  # ReduceProd
        x = x.prod(d, keepdim=keep)
    return x


_ELTWISE = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": torch.div,
            "Pow": torch.pow, "Greater": torch.gt, "GreaterOrEqual": torch.ge,
            "Less": torch.lt, "LessOrEqual": torch.le, "Equal": torch.eq,
            "And": torch.logical_and, "Or": torch.logical_or, "Xor": torch.logical_xor}
_UNARY = {"Sigmoid": torch.sigmoid, "Sqrt": torch.sqrt, "Reciprocal": torch.reciprocal,
          "Exp": torch.exp, "Log": torch.log, "Tanh": torch.tanh, "Neg": torch.neg,
          "Abs": torch.abs, "Floor": torch.floor, "Ceil": torch.ceil, "Sign": torch.sign,
          "Not": torch.logical_not, "Identity": lambda x: x}
# the inputs each op reads as host lists (shapes, axes, pads, scales, the pad
# value), by position
_HOST_INPUTS = {"Reshape": (1,), "Slice": (1, 2, 3, 4), "Pad": (1, 2), "Expand": (1,),
                "ReduceSum": (1,), "Resize": (2,)}


class Runtime:
    """Execute an ONNX model on ``device``: ``Runtime(model_bytes)(images)``
    -> the graph's outputs, a list of tensors on that device. The device
    defaults to the card, and a card that is not there raises."""

    def __init__(self, model_bytes: bytes, device="cuda"):
        from yolov5_tpu_torch.infer import resolve_device

        self.device = resolve_device(device, "onnx.Runtime")
        model = proto.parse_model(model_bytes)
        self.metadata = model.metadata
        g = model.graph
        self.nodes = g.nodes
        self.inputs = [(n, tuple(s)) for n, _, s in g.inputs if n not in g.initializers]
        self.input_names = [n for n, _ in self.inputs]
        self.outputs = [(n, tuple(s)) for n, _, s in g.outputs]
        self.output_names = [n for n, _ in self.outputs]
        # own the buffers: parse_model returns read-only views of model_bytes
        self._host = {k: np.array(v) for k, v in g.initializers.items()}
        self._consts = {k: torch.from_numpy(v).to(self.device) for k, v in self._host.items()}

    def __call__(self, *args, **feeds):
        for name, val in zip(self.input_names, args):
            feeds[name] = val
        env = dict(self._consts)
        for name, shape in self.inputs:
            if name not in feeds:
                raise ValueError(f"onnx.Runtime: missing input {name!r}")
            x = torch.as_tensor(feeds[name]).to(self.device)
            if shape and all(isinstance(s, int) for s in shape) and tuple(x.shape) != shape:
                raise ValueError(f"onnx.Runtime: input {name!r} has shape {tuple(x.shape)}; "
                                 f"the graph was exported for {shape}")
            env[name] = x
        for node in self.nodes:
            ins = [env[i] if i else None for i in node.inputs]
            for j in _HOST_INPUTS.get(node.op_type, ()):
                if j < len(node.inputs) and node.inputs[j]:
                    ins[j] = self._host_list(node.inputs[j], env)
            out = self._run(node.op_type, node.attrs, ins)
            outs = out if isinstance(out, (list, tuple)) else [out]
            for name, val in zip(node.outputs, outs):
                env[name] = val
        return [env[n] for n in self.output_names]

    def _host_list(self, name, env):
        """A shape-like input as a host list: from its initializer's host
        copy, or, for a value computed in the graph, from the device."""
        arr = self._host.get(name)
        if arr is None:
            arr = env[name].cpu().numpy()
        return arr.reshape(-1).tolist()

    def _run(self, op, a, ins):
        if op in _ELTWISE:
            return _ELTWISE[op](ins[0], ins[1])
        if op in _UNARY:
            return _UNARY[op](ins[0])
        if op == "Conv":
            return _conv(ins[0], ins[1], ins[2] if len(ins) > 2 else None, a)
        if op == "MaxPool":
            return _maxpool(ins[0], a)
        if op == "Resize":
            return _resize(ins[0], ins[2], a)
        if op in ("Max", "Min"):
            fn = torch.maximum if op == "Max" else torch.minimum
            out = ins[0]
            for t in ins[1:]:
                out = fn(out, t)
            return out
        if op == "Where":
            return torch.where(ins[0].bool(), ins[1], ins[2])
        if op == "Cast":
            return ins[0].to(_TORCH_DTYPES[a["to"]])
        if op == "Concat":
            return torch.cat(ins, a["axis"])
        if op == "Reshape":
            shape = [ins[0].shape[i] if s == 0 else s for i, s in enumerate(ins[1])]
            return ins[0].reshape(shape)
        if op == "Transpose":
            return ins[0].permute(a.get("perm", list(range(ins[0].dim()))[::-1]))
        if op == "Slice":
            return _slice(ins[0], ins[1], ins[2], *(ins[3:5] + [None] * (5 - len(ins))))
        if op == "Pad":
            if a.get("mode", "constant") != "constant":
                raise NotImplementedError(f"Pad mode {a.get('mode')!r}")
            n = ins[0].dim()
            value = float(ins[2][0]) if len(ins) > 2 and ins[2] is not None else 0.0
            return F.pad(ins[0], _pad_pairs(ins[1][:n], ins[1][n:]), value=value)
        if op == "Expand":
            return ins[0].expand(torch.broadcast_shapes(ins[0].shape, tuple(ins[1])))
        if op == "MatMul":
            return torch.matmul(ins[0], ins[1])
        if op == "Gemm":
            x = ins[0].T if a.get("transA") else ins[0]
            w = ins[1].T if a.get("transB") else ins[1]
            out = a.get("alpha", 1.0) * (x @ w)
            return out + a.get("beta", 1.0) * ins[2] if len(ins) > 2 and ins[2] is not None \
                else out
        if op in ("ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd"):
            axes = a.get("axes")
            if axes is None and len(ins) > 1 and ins[1] is not None:
                axes = ins[1]
            return _reduce(op, ins[0], axes, bool(a.get("keepdims", 1)))
        if op == "Softmax":
            return torch.softmax(ins[0], a.get("axis", -1))
        if op == "Clip":
            lo = ins[1] if len(ins) > 1 else None
            hi = ins[2] if len(ins) > 2 else None
            return torch.clamp(ins[0], lo, hi)
        if op == "BatchNormalization":
            x, scale, bias, mean, var = ins[:5]
            return F.batch_norm(x, mean, var, scale, bias, False, 0.0, a.get("epsilon", 1e-5))
        raise NotImplementedError(f"onnx.Runtime: op {op!r}")
