"""Weight interop: BN folding, the permissive reference ``.pt`` loader, and
the conversions from and to the JAX package's variables.

State dicts use the reference torch key layout (``model.{i}.cv1.conv.weight``,
OIHW), the layout ``yolov5_tpu/models/weights.py::torch_key_to_flax`` maps
from; ``from_jax_variables`` is its inverse and ``to_jax_variables`` the
inverse of that, so both packages can be fed the same weights and the
checkpoint writer can write the JAX layout. A Segment head's keys
(``model.24.m.0.weight``, ``model.24.proto.cv1.conv.weight``) map like any
other, so the reference's segmentation ``.pt`` loads directly. A Classify
head's ``linear`` is a flax ``Dense``: its kernel is (in, out), the
transpose of torch's (out, in) ``weight``.
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch

from yolov5_tpu_torch.models.layers import BN_EPS


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------

def _fold(sd: dict, bn: str, weight: str, bias: str, rows=slice(None)):
    """``weight`` and ``bias`` (keys of sd; the bias may be absent) with the
    BN at prefix ``bn`` folded in, over the BN's channels ``rows``:
      w' = w * gamma / sqrt(var + eps),  b' = beta + (b - mean) * gamma / sqrt(var + eps)
    (the math of ``yolov5_tpu.models.weights._fold``)."""
    gamma, beta = sd[bn + "weight"][rows].float(), sd[bn + "bias"][rows].float()
    mean, var = sd[bn + "running_mean"][rows].float(), sd[bn + "running_var"][rows].float()
    scale = gamma / torch.sqrt(var + BN_EPS)
    prior = sd[bias].float() if bias in sd else 0.0
    return sd[weight].float() * scale[:, None, None, None], beta + (prior - mean) * scale


def fuse_conv_bn(state_dict: dict) -> dict:
    """Fold each BN into the conv it follows, for a ``fused`` model. Returns a
    new state dict of f32 tensors; one already folded passes through.

      - ``<p>bn`` into ``<p>conv`` (Conv, and the Convs inside every block);
      - ``<p>X_bn`` into ``<p>X_conv`` (CrossConv's cv1 and cv2 pairs);
      - ``<p>bn`` over ``<p>m.{j}`` convs (MixConv2d): each conv takes its
        slice of the BN's channels;
      - any other ``<p>bn`` follows no conv (BottleneckCSP's, after a concat)
        and stays, with its running statistics.

    (The JAX package's ``fuse_conv_bn`` folds only the first kind: see
    ROADMAP.md, "Know these gaps".)"""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    out = dict(sd)
    for k in sd:
        if not k.endswith("bn.running_var"):
            continue
        bn = k[:-len("running_var")]  # "<p>bn." or "<p>X_bn."
        p = bn[:-len("bn.")]
        if p.endswith("_") or p + "conv.weight" in sd:  # <p>X_bn -> <p>X_conv, <p>bn -> <p>conv
            convs = [p + "conv."]
        else:
            convs = []
            while f"{p}m.{len(convs)}.weight" in sd and sd[f"{p}m.{len(convs)}.weight"].dim() == 4:
                convs.append(f"{p}m.{len(convs)}.")
        if not convs:
            continue
        start = 0
        for c in convs:
            n = sd[c + "weight"].shape[0]
            out[c + "weight"], out[c + "bias"] = _fold(sd, bn, c + "weight", c + "bias",
                                                       slice(start, start + n))
            start += n
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            del out[bn + leaf]
    return {k: v.float() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Permissive torch .pt loading
# ---------------------------------------------------------------------------

class _Stub:
    """Inert stand-in for any un-importable pickled class."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *a, **k):  # some pickles call factory objects
        return self


def _permissive_torch_load(path):
    """torch.load with unknown classes mapped to stubs (cpu only). Unpickling
    can run code: load only checkpoints from a trusted source."""

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith(("torch", "collections", "builtins", "numpy", "argparse", "pathlib")):
                try:
                    return super().find_class(module, name)
                except (ImportError, AttributeError):
                    pass
            return type(name, (_Stub,), {"__module__": module})

    shim = type("shim", (), {"Unpickler": Unpickler, "load": None})
    return torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)


def _harvest_tensors(obj, prefix="", out=None, seen=None):
    """Recursively collect tensors from stubbed nn.Module object graphs."""
    out = {} if out is None else out
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return out
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out[prefix.rstrip(".")] = obj.detach().float().numpy()
        return out
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return out
    for coll in ("_parameters", "_buffers"):
        for k, v in (d.get(coll) or {}).items():
            if v is not None and isinstance(v, torch.Tensor):
                out[prefix + k] = v.detach().float().numpy()
    for k, v in (d.get("_modules") or {}).items():
        _harvest_tensors(v, prefix + k + ".", out, seen)
    return out


def load_torch_state_dict(path, prefer_ema=True):
    """Load a reference-format checkpoint to {name: np.ndarray}: plain
    state_dicts, {'model': module} dicts, and EMA selection."""
    ckpt = _permissive_torch_load(path)
    if isinstance(ckpt, dict):
        cand = None
        if prefer_ema and ckpt.get("ema") is not None:
            cand = ckpt["ema"]
        elif "model" in ckpt:
            cand = ckpt["model"]
        if cand is None:
            cand = ckpt
        if isinstance(cand, dict):  # already a state_dict
            return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor) else v)
                    for k, v in cand.items() if isinstance(v, torch.Tensor)}
        return _harvest_tensors(cand)
    return _harvest_tensors(ckpt)


def load_weights(model: torch.nn.Module, state_dict: dict) -> list[str]:
    """Copy every entry of ``state_dict`` whose key and shape match the
    model's; keep the model's own value elsewhere. Returns what did not
    match, as ``yolov5_tpu.models.weights.import_torch_weights`` does."""
    own = model.state_dict()
    missed = []
    for k, v in own.items():
        if k.endswith("num_batches_tracked"):  # BN bookkeeping, not a weight
            continue
        if k not in state_dict:
            missed.append(f"missing {k}")
            continue
        theirs = torch.as_tensor(state_dict[k])
        if tuple(theirs.shape) != tuple(v.shape):
            missed.append(f"shape mismatch {k}: {tuple(theirs.shape)} vs {tuple(v.shape)}")
            continue
        own[k] = theirs.to(v.dtype)
    model.load_state_dict(own)
    return missed


# ---------------------------------------------------------------------------
# JAX variables -> state_dict
# ---------------------------------------------------------------------------

# (collection, flax leaf) -> torch leaf
_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    # AconC's per-channel parameters: (c,) in flax, (1, c, 1, 1) here
    ("params", "p1"): "p1",
    ("params", "p2"): "p2",
    ("params", "beta"): "beta",
}
_ACON = ("p1", "p2", "beta")
_INDEXED = re.compile(r"^(.+)_(\d+)$")


def _torch_module_path(path: list[str]) -> list[str]:
    """Flax module path -> torch module path: layers_{i} -> model.{i},
    layers_{i}_{r} (repeat r of a sequential layer) -> model.{i}.{r},
    m_0 -> m.0, seq_{p} -> {p}."""
    out = []
    for j, p in enumerate(path):
        if j == 0 and p.startswith("layers_"):
            out += ["model", *p[len("layers_"):].split("_")]
        elif p.startswith("seq_"):
            out.append(p[len("seq_"):])
        elif _INDEXED.match(p):
            out += list(_INDEXED.match(p).groups())
        else:
            out.append(p)
    return out


def from_jax_variables(variables) -> dict:
    """The JAX package's variables ({"params": ..., "batch_stats": ...},
    fused or not) as a state_dict of f32 tensors in the reference torch
    layout: the inverse of ``torch_key_to_flax``, HWIO -> OIHW for conv
    kernels, (in, out) -> (out, in) for Dense kernels, bn
    scale/bias/mean/var -> weight/bias/running_mean/running_var."""
    sd = {}

    def walk(coll, tree, path):
        for name, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(coll, v, path + [name])
                continue
            leaf = _LEAVES.get((coll, name))
            if leaf is None:
                raise ValueError(f"from_jax_variables: no torch counterpart for "
                                 f"{coll}/{'/'.join(path + [name])}")
            # a bfloat16 leaf of a checkpoint arrives as a torch tensor
            a = v.float().numpy() if isinstance(v, torch.Tensor) else np.array(v, np.float32)
            if name == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T  # HWIO -> OIHW
            elif name in _ACON:
                a = a.reshape(1, -1, 1, 1)
            key = ".".join(_torch_module_path(path) + [leaf])
            sd[key] = torch.from_numpy(np.ascontiguousarray(a))

    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(coll, variables[coll], [])
    return sd


# ---------------------------------------------------------------------------
# state_dict -> JAX variables
# ---------------------------------------------------------------------------

def torch_key_to_flax(key: str):
    """One state_dict key -> (collection, flax path list), or None for keys
    with no flax counterpart (num_batches_tracked). A copy of the mapping of
    ``yolov5_tpu.models.weights.torch_key_to_flax``: model.{i} -> layers_{i},
    m.0 -> m_0; with two fixes, so that it inverts ``from_jax_variables`` on
    every layout the JAX package builds: model.{i}.{r} (repeat r of a
    sequential layer) -> layers_{i}_{r}, where the JAX mapping gives
    layers_{i}/seq_{r}, which its model does not have; and AconC's p1, p2
    and beta, which the JAX mapping drops."""
    if key.endswith("num_batches_tracked"):
        return None
    parts = key.split(".")
    if parts[0] == "model":
        parts = parts[1:]
    out = []
    i = 0
    if parts and parts[0].isdigit():
        out.append(f"layers_{parts[0]}")
        i = 1
        if len(parts) > 2 and parts[1].isdigit():  # a sequential repeat
            out[0] += f"_{parts[1]}"
            i = 2
    leaf, mids = parts[-1], parts[i:-1]
    j = 0
    while j < len(mids):
        if j + 1 < len(mids) and mids[j + 1].isdigit():  # m.0 -> m_0
            out.append(f"{mids[j]}_{mids[j + 1]}")
            j += 2
        else:
            out.append(f"seq_{mids[j]}" if mids[j].isdigit() else mids[j])
            j += 1
    bn = bool(out) and (out[-1] == "bn" or out[-1].endswith("_bn"))
    leaves = {"weight": ("params", "scale" if bn else "kernel"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var"),
              **{a: ("params", a) for a in _ACON}}
    if leaf not in leaves:
        return None
    coll, name = leaves[leaf]
    return coll, out + [name]


def to_jax_variables(state_dict: dict) -> dict:
    """A state_dict in the reference torch layout as the JAX package's
    variables, {"params": ..., "batch_stats": ...} of nested dicts of f32
    numpy arrays: the inverse of ``from_jax_variables`` (OIHW -> HWIO, and
    (out, in) -> (in, out) for a Linear)."""
    out = {"params": {}, "batch_stats": {}}
    for k, v in state_dict.items():
        m = torch_key_to_flax(k)
        if m is None:
            continue
        coll, path = m
        a = v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(
            v, np.float32)
        if path[-1] == "kernel" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif path[-1] == "kernel" and a.ndim == 2:
            a = a.T  # a Linear's (out, in) -> a Dense kernel's (in, out)
        elif path[-1] in _ACON:
            a = a.reshape(-1)
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
