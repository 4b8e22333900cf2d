"""YAML-driven model graph and the detection model.

``load_config``, ``LayerSpec``, ``parse_graph`` and ``check_anchor_order``
are copies of ``yolov5_tpu/models/yolo.py`` without JAX, tested equal to
their originals on every bundled config; the configs themselves are read by
path from ``yolov5_tpu/models/configs``. ``DetectionModel`` is an
``nn.Module`` that builds every module of the JAX package's registry
(sequential repeats as ``nn.Sequential``), executes the parsed layer list
with the reference's save-list, probes its strides with a real forward, and draws seeded
torch-style initial weights; with a Segment head it returns ``(maps,
proto)``, and ``SegmentationModel`` names that case. ``ClassificationModel``
runs the detection graph cut at ``cutoff`` with a Classify head appended.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from yolov5_tpu_torch.models import layers as L
from yolov5_tpu_torch.ops.boxes import make_divisible

CONFIG_DIR = Path(__file__).resolve().parents[2] / "yolov5_tpu" / "models" / "configs"

# Modules whose YAML repeat-count `n` becomes an internal arg instead of
# sequential repetition.
_INTERNAL_N = {"C3", "C3x", "C3TR", "C3Ghost", "BottleneckCSP"}
# Modules taking no channel argument.
_NO_CHANNELS = {"Concat", "Upsample", "nn.Upsample", "Contract", "Expand",
                "MaxPool", "nn.MaxPool2d", "ZeroPad", "nn.ZeroPad2d"}

# torch-style activation strings in YAML `activation:` keys -> our names
_ACT_ALIASES = {
    "nn.SiLU()": "silu", "nn.ReLU()": "relu", "nn.LeakyReLU(0.1)": "leaky_relu",
    "nn.Hardswish()": "hardswish", "nn.Mish()": "mish",
    "silu": "silu", "relu": "relu", "leaky_relu": "leaky_relu",
    "hardswish": "hardswish", "mish": "mish", "identity": "identity",
}


def _hashable(x):
    """Recursively convert lists to tuples so specs stay hashable."""
    if isinstance(x, (list, tuple)):
        return tuple(_hashable(v) for v in x)
    return x


def _resolve_arg(a, nc, anchors):
    """YAML args may be symbolic ('nc', 'anchors', 'None') or plain strings."""
    if not isinstance(a, str):
        return a
    table = {"nc": nc, "anchors": anchors, "None": None}
    return table.get(a, a)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One graph node: where its inputs come from and how to build it."""

    i: int  # layer index
    frm: tuple  # input layer indices (-1 = previous)
    module: str  # registry name
    args: tuple  # positional args (resolved, hashable)
    kwargs: tuple  # extra kwargs as sorted (k, v) pairs
    n: int = 1  # sequential repeats (only for non-internal-n modules)
    c2: int = 0  # output channels (bookkeeping)


def load_config(cfg) -> dict:
    """Load a model config: dict passthrough, name (resolved against the
    bundled configs dir), or explicit path."""
    import yaml

    if isinstance(cfg, dict):
        return dict(cfg)
    p = Path(cfg)
    if not p.exists():
        for cand in (CONFIG_DIR / f"{cfg}.yaml", CONFIG_DIR / f"{p.stem}.yaml"):
            if cand.exists():
                p = cand
                break
    with open(p) as f:
        d = yaml.safe_load(f)
    d["yaml_file"] = str(p)
    return d


def parse_graph(cfg: dict, ch_in: int = 3):
    """Resolve the YAML layer list into LayerSpecs + the save-index list.

    Returns (specs, save, ch) where ch[i] is layer i's output channels.
    """
    gd = cfg.get("depth_multiple", 1.0)
    gw = cfg.get("width_multiple", 1.0)
    anchors = cfg.get("anchors")
    nc = cfg["nc"]
    act = cfg.get("activation")  # optional global activation override
    if act:
        act = _ACT_ALIASES.get(str(act), str(act))
    if isinstance(anchors, (list, tuple)):
        na = len(anchors[0]) // 2
        anchors_t = tuple(tuple(zip(a[0::2], a[1::2])) for a in anchors)
    else:
        na = int(anchors) if anchors else 3
        anchors_t = ()
    no = na * (nc + 5)

    specs: list[LayerSpec] = []
    save: set[int] = set()
    ch: list[int] = [ch_in]

    rows = list(cfg["backbone"]) + list(cfg["head"])
    for i, (f, n, m, args) in enumerate(rows):
        frm = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        # normalize negative indices (other than -1 = previous) to absolute
        frm = tuple(x if x == -1 else (x if x >= 0 else i + x) for x in frm)
        args = [_resolve_arg(a, nc, anchors) for a in args]
        n_scaled = max(round(n * gd), 1) if n > 1 else n
        kwargs: dict[str, Any] = {}
        if act and m in {"Conv", "DWConv", "Bottleneck", "C3", "SPPF", "SPP"}:
            kwargs["act"] = act

        c1 = ch[frm[0] + 1 if frm[0] != -1 else len(ch) - 1] if m != "Concat" else sum(
            ch[x + 1 if x != -1 else len(ch) - 1] for x in frm
        )

        if m in _NO_CHANNELS:
            if m in {"nn.Upsample", "Upsample"}:
                # torch signature (size, scale_factor, mode)
                scale = int(args[1]) if len(args) > 1 else 2
                spec_args: tuple = (scale,)
                m = "Upsample"
            elif m in {"nn.MaxPool2d", "MaxPool"}:
                # torch signature (kernel, stride, padding)
                k = int(args[0]) if args else 2
                s = int(args[1]) if len(args) > 1 else k
                p = int(args[2]) if len(args) > 2 else 0
                spec_args = (k, s, p)
                m = "MaxPool"
            elif m in {"nn.ZeroPad2d", "ZeroPad"}:
                spec_args = (_hashable(args[0]) if args else (0, 1, 0, 1),)
                m = "ZeroPad"
            elif m in {"Contract", "Expand"}:
                spec_args = (int(args[0]),)
                gain = int(args[0])
                c1 = c1 * gain * gain if m == "Contract" else c1 // (gain * gain)
            else:
                spec_args = ()
            c2 = c1
        elif m in {"Detect", "Segment"}:
            head_nc = args[0]
            c2 = 0
            spec_args = (head_nc, anchors_t)
            if m == "Segment":
                # args: [nc, anchors, nm, npr]
                kwargs["nm"] = args[2] if len(args) > 2 else 32
                kwargs["npr"] = make_divisible(args[3] * gw, 8) if len(args) > 3 else 256
            save.update(x % i for x in frm)
            specs.append(
                LayerSpec(i, frm, m, spec_args, tuple(sorted(kwargs.items())), 1, c2)
            )
            ch.append(c2)
            continue
        elif m == "Classify":
            c2 = args[0]
            spec_args = tuple([c2] + args[1:])
        else:
            # channel-producing compute modules: args[0] is c2 (scaled)
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            rest = list(args[1:])
            if m in _INTERNAL_N:
                kwargs["n"] = n_scaled
                n_scaled = 1
                if rest:  # e.g. C3 [c2, False] -> shortcut flag
                    kwargs["shortcut"] = bool(rest.pop(0))
                if rest:
                    kwargs["g"] = rest.pop(0)
                if rest:
                    kwargs["e"] = rest.pop(0)
                spec_args = (c2,)
            elif m == "C3SPP":
                # args [c2, k] but k is a keyword (field order differs)
                if rest:
                    kwargs["k"] = _hashable(rest.pop(0))
                spec_args = (c2,)
            elif m == "TransformerBlock":
                # args [c2, num_heads]; repeat count is internal
                kwargs["n"] = n_scaled
                n_scaled = 1
                spec_args = tuple([c2] + rest)
            else:
                spec_args = _hashable(tuple([c2] + rest))

        for x in frm:
            if x != -1:
                save.add(x)
        specs.append(LayerSpec(i, frm, m, spec_args, tuple(sorted(kwargs.items())), n_scaled, c2))
        ch.append(c2)

    return specs, tuple(sorted(save)), ch[1:]


def check_anchor_order(anchors, strides):
    """Ensure anchor areas are ordered like strides; returns possibly-reversed
    anchors."""
    a = np.asarray(anchors, np.float32)  # (nl, na, 2)
    areas = a.prod(-1).mean(-1)
    da = areas[-1] - areas[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds) and da != 0:
        a = a[::-1].copy()
    return tuple(tuple(map(tuple, lvl)) for lvl in a)


# the YAML modules that take their input's channel count first, as the JAX
# package's registry (yolov5_tpu/models/yolo.py) names them
_REGISTRY = {
    "Conv": L.Conv, "DWConv": L.DWConv, "Bottleneck": L.Bottleneck,
    "BottleneckCSP": L.BottleneckCSP, "CrossConv": L.CrossConv, "C3": L.C3, "C3x": L.C3x,
    "C3TR": L.C3TR, "C3SPP": L.C3SPP, "C3Ghost": L.C3Ghost, "SPP": L.SPP, "SPPF": L.SPPF,
    "Focus": L.Focus, "GhostConv": L.GhostConv, "GhostBottleneck": L.GhostBottleneck,
    "MixConv2d": L.MixConv2d, "TransformerBlock": L.TransformerBlock,
}
# the YAML modules without channels: their spec args are their constructor's
# (MaxPool's (k, s, p) and ZeroPad's (l, r, t, b) are torch's own arguments)
_SHAPE_ONLY = {"Concat": L.Concat, "Upsample": L.Upsample, "Contract": L.Contract,
               "Expand": L.Expand, "MaxPool": nn.MaxPool2d, "ZeroPad": nn.ZeroPad2d}


def _build_module(spec: LayerSpec, c_in: list, fused: bool) -> nn.Module:
    """Construct one layer; ``c_in`` holds each input's channel count. A
    sequential repeat (``spec.n`` > 1) is an ``nn.Sequential`` of ``n``
    copies, the first from c_in[0] channels and the others from c2, so its
    keys read ``model.{i}.{r}.…`` (the JAX package's ``layers_{i}_{r}``)."""
    if spec.n > 1:
        one = dataclasses.replace(spec, n=1)
        return nn.Sequential(*(_build_module(one, c_in if r == 0 else [spec.c2], fused)
                               for r in range(spec.n)))
    kw = dict(spec.kwargs)
    if spec.module in _SHAPE_ONLY:
        return _SHAPE_ONLY[spec.module](*spec.args)
    if spec.module == "Detect":
        return L.Detect(spec.args[0], spec.args[1], c_in)
    if spec.module == "Segment":
        return L.Segment(spec.args[0], spec.args[1], c_in, fused=fused, **kw)
    if spec.module == "Classify":
        return L.Classify(c_in[0], *spec.args, fused=fused, **kw)
    if spec.module not in _REGISTRY:
        raise NotImplementedError(f"layer {spec.i}: module {spec.module} is not in the registry")
    return _REGISTRY[spec.module](c_in[0], *spec.args, fused=fused, **kw)


def _init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded torch-style init: conv and linear weights and biases
    U(±1/sqrt(fan_in)) (torch's kaiming_uniform(a=sqrt(5)) default); BN
    weight 1, bias 0, running mean 0, var 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


class DetectionModel(nn.Module):
    """Detection model built from a YAML config (reference models/yolo.py).
    Its forward gives the raw maps, or ``(maps, proto)`` under a Segment
    head."""

    def __init__(self, cfg="yolov5s", ch=3, nc=None, fused=False, seed=0, anchors=None):
        """``anchors`` (YAML-style flat lists per level, as a checkpoint's
        meta stores them) replace the cfg's: autoanchor may have evolved them."""
        super().__init__()
        self.cfg = load_config(cfg)
        if nc is not None and nc != self.cfg.get("nc"):
            self.cfg["nc"] = nc
        if anchors is not None:
            self.cfg["anchors"] = anchors
        self.nc = self.cfg["nc"]
        self.fused = fused
        self.specs, self.save, out_ch = parse_graph(self.cfg, ch)
        self.model = _build_graph(self.specs, [ch, *out_ch], fused)
        head = self.specs[-1]
        if head.module not in ("Detect", "Segment"):
            raise NotImplementedError(f"head {head.module} is not ported")
        _init_weights(self, torch.Generator().manual_seed(seed))

        # probe strides with a real forward at 256 px, as the reference does
        s = 256
        with torch.no_grad():
            x = torch.zeros(1, ch, s, s).contiguous(memory_format=torch.channels_last)
            maps = self.forward(x)
        if head.module == "Segment":
            maps = maps[0]
        self.stride = tuple(int(s / m.shape[1]) for m in maps)
        self.anchors = check_anchor_order(head.args[1], self.stride)
        self._init_detect_biases()
        self.names = self.cfg.get("names") or {i: f"class{i}" for i in range(self.nc)}

    @property
    def anchors_per_stride(self):
        """The anchors in stride units, for the loss (the reference keeps
        anchors /= stride, models/yolo.py:250)."""
        return tuple(tuple((aw / s, ah / s) for aw, ah in lvl)
                     for lvl, s in zip(self.anchors, self.stride))

    def _init_detect_biases(self):
        """Focal-style prior on the Detect biases: obj ~ log(8 / (640/s)²),
        cls ~ log(0.6 / (nc - 0.99999)); a Segment head's nm coefficient
        biases stay as drawn."""
        det = self.model[-1]
        with torch.no_grad():
            for conv, s in zip(det.m, self.stride):
                b = conv.bias.view(det.na, det.no)
                b[:, 4] += math.log(8.0 / (640.0 / s) ** 2)
                b[:, 5:5 + self.nc] += math.log(0.6 / (self.nc - 0.99999))

    def forward(self, x):
        """x (bs, ch, H, W), channels_last -> raw maps [(bs, ny, nx, na, no)]."""
        return _run_graph(self, x)


def _build_graph(specs, chs: list, fused: bool) -> nn.ModuleList:
    """One module per spec; chs[j + 1] is layer j's output channels, chs[0]
    the input's."""
    return nn.ModuleList(
        _build_module(s, [chs[s.i if j == -1 else j + 1] for j in s.frm], fused)
        for s in specs)


def _run_graph(model: nn.Module, x):
    """Execute the layer list with the reference's save-list."""
    saved = {}
    out = x
    for spec, mod in zip(model.specs, model.model):
        if len(spec.frm) == 1:
            inp = out if spec.frm[0] == -1 else saved[spec.frm[0]]
        else:
            inp = [out if j == -1 else saved[j] for j in spec.frm]
        out = mod(inp)
        if spec.i in model.save:
            saved[spec.i] = out
    return out


class SegmentationModel(DetectionModel):
    """A DetectionModel whose config ends in a Segment head: its forward
    gives ``(maps, proto)``, maps [(bs, ny, nx, na, 5 + nc + nm)] and proto
    (bs, hm, wm, nm) (the JAX package's ``SegmentationModel``)."""

    def __init__(self, cfg="yolov5s-seg", **kw):
        super().__init__(cfg, **kw)
        if self.specs[-1].module != "Segment":
            raise ValueError(f"SegmentationModel: {cfg} has a {self.specs[-1].module} head, "
                             "not Segment")
        self.nm = self.model[-1].nm


class ClassificationModel(nn.Module):
    """A classifier: the detection graph of ``cfg`` cut to its layers below
    ``cutoff``, with a Classify head of ``nc`` logits appended at index
    ``cutoff`` (the JAX package's ``ClassificationModel``, which keeps the
    last backbone layer; the reference replaces it). x (bs, ch, H, W)
    channels_last -> logits (bs, nc)."""

    def __init__(self, cfg="yolov5s", nc=1000, cutoff=10, ch=3, fused=False, seed=0):
        super().__init__()
        self.cfg = cfg if isinstance(cfg, dict) else str(cfg)
        self.nc, self.cutoff, self.fused = nc, cutoff, fused
        specs, save, out_ch = parse_graph(load_config(cfg), ch)
        self.specs = [s for s in specs if s.i < cutoff]
        self.specs.append(LayerSpec(cutoff, (-1,), "Classify", (nc,), (), 1, nc))
        self.save = tuple(s for s in save if s < cutoff)
        self.model = _build_graph(self.specs, [ch, *out_ch[:cutoff]], fused)
        _init_weights(self, torch.Generator().manual_seed(seed))
        self.stride = (32,)
        self.names = {i: f"class{i}" for i in range(nc)}

    def forward(self, x):
        return _run_graph(self, x)


def build_model(cfg, task="detect", **kw):
    if task == "detect":
        return DetectionModel(cfg, **kw)
    if task == "segment":
        return SegmentationModel(cfg, **kw)
    if task == "classify":
        return ClassificationModel(cfg, **kw)
    raise ValueError(f"unknown task {task!r}")
