"""The plain reference of the yolov5 detection model: the graph of a published
YAML (Conv, C3, Bottleneck, SPPF, nn.Upsample, Concat, Detect), run with
plain torch operations in float32 on NCHW tensors, and the head decode.

It follows ultralytics/yolov5 v7.0 (models/common.py, models/yolo.py): Conv
is conv + BatchNorm2d(eps 1e-3) + SiLU, C3 is cv3(cat(m(cv1(x)), cv2(x))),
SPPF chains three 5x5 max pools, Detect is one 1x1 conv per level. Weights
are a state_dict in the reference's key layout (``model.{i}.cv1.conv.weight``,
OIHW); BN stays unfolded. The head maps come out as (bs, ny, nx, na, no),
and the decode is xy = (2σ - 0.5 + grid)·stride, wh = (2σ)²·anchor.

``precision`` "fp8" is the control of the comparisons: every conv's input
and weight are rounded to float8 e4m3 (a scale per image for the input, per
output channel for the weight) before an f32 conv, the nearest precision
below the bfloat16 the cells run in. "bf16" runs each conv in bfloat16 (BN
and SiLU in float32): a second witness of what bfloat16 alone does.

Nothing here imports the measured program or JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
FP8_MAX = 448.0  # the largest float8 e4m3 value


@dataclass(frozen=True)
class ConvSpec:
    """One conv of the graph: its state_dict prefix, shape, and whether a
    BN (and SiLU) follows it or it is a Detect conv with a bias."""

    key: str
    c1: int
    c2: int
    k: int
    s: int
    p: int
    head: bool = False


def load_yaml(path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _divisible(x: float, d: int = 8) -> int:
    return int(math.ceil(x / d) * d)


def parse(cfg: dict, ch_in: int = 3):
    """The layer list of ``cfg``: [(i, from, kind, info)], the save set, and
    every conv in graph order. ``info`` holds what the kind needs."""
    gd, gw, nc = cfg["depth_multiple"], cfg["width_multiple"], cfg["nc"]
    anchors = cfg["anchors"]
    na = len(anchors[0]) // 2
    no = nc + 5
    layers, convs, save = [], [], set()
    ch = [ch_in]
    rows = list(cfg["backbone"]) + list(cfg["head"])
    for i, (f, n, m, args) in enumerate(rows):
        frm = [f] if isinstance(f, int) else list(f)
        frm = [x if x == -1 else (x if x >= 0 else i + x) for x in frm]
        for x in frm:
            if x != -1:
                save.add(x)
        c_in = [ch[-1] if x == -1 else ch[x + 1] for x in frm]
        n = max(round(n * gd), 1) if n > 1 else n
        p = f"model.{i}."
        if m == "Conv":
            c2 = _divisible(args[0] * gw)
            k = args[1] if len(args) > 1 else 1
            s = args[2] if len(args) > 2 else 1
            pad = args[3] if len(args) > 3 else k // 2
            convs.append(ConvSpec(p, c_in[0], c2, k, s, pad))
            info = {"conv": convs[-1]}
        elif m == "C3":
            c2 = _divisible(args[0] * gw)
            shortcut = bool(args[1]) if len(args) > 1 else True
            c_ = int(c2 * 0.5)
            cv1 = ConvSpec(p + "cv1.", c_in[0], c_, 1, 1, 0)
            cv2 = ConvSpec(p + "cv2.", c_in[0], c_, 1, 1, 0)
            blocks = [(ConvSpec(f"{p}m.{j}.cv1.", c_, c_, 1, 1, 0),
                       ConvSpec(f"{p}m.{j}.cv2.", c_, c_, 3, 1, 1)) for j in range(n)]
            cv3 = ConvSpec(p + "cv3.", 2 * c_, c2, 1, 1, 0)
            convs += [cv1, *(c for b in blocks for c in b), cv2, cv3]
            info = {"cv1": cv1, "cv2": cv2, "cv3": cv3, "m": blocks, "add": shortcut}
        elif m == "SPPF":
            c2 = _divisible(args[0] * gw)
            c_ = c_in[0] // 2
            k = args[1] if len(args) > 1 else 5
            cv1 = ConvSpec(p + "cv1.", c_in[0], c_, 1, 1, 0)
            cv2 = ConvSpec(p + "cv2.", c_ * 4, c2, 1, 1, 0)
            convs += [cv1, cv2]
            info = {"cv1": cv1, "cv2": cv2, "k": k}
        elif m in ("nn.Upsample", "Upsample"):
            c2 = c_in[0]
            info = {"scale": int(args[1])}
        elif m == "Concat":
            c2 = sum(c_in)
            info = {}
        elif m == "Detect":
            c2 = 0
            heads = [ConvSpec(f"{p}m.{j}.", c, na * no, 1, 1, 0, head=True)
                     for j, c in enumerate(c_in)]
            convs += heads
            info = {"m": heads, "na": na, "no": no, "nc": nc,
                    "anchors": [list(zip(a[0::2], a[1::2])) for a in anchors]}
        else:
            raise NotImplementedError(f"layer {i}: {m} is not in the plain reference")
        layers.append((i, frm, m if m != "nn.Upsample" else "Upsample", info))
        ch.append(c2)
    return layers, save, convs


def strides_of(cfg: dict) -> list[int]:
    """The Detect levels' strides: the product of the conv strides on the
    path to each input of Detect."""
    layers, _, _ = parse(cfg)
    stride = {-1: 1}
    for i, frm, kind, info in layers:
        s_in = [stride[i - 1] if x == -1 else stride[x] for x in frm]
        if kind == "Conv":
            s = s_in[0] * info["conv"].s
        elif kind == "Upsample":
            s = s_in[0] // info["scale"]
        elif kind == "Detect":
            return s_in
        else:
            s = s_in[0]
        stride[i] = s
    raise ValueError("no Detect layer")


def anchors_px(cfg: dict):
    """Per level, (na, 2) anchor sizes in pixels, ordered like the strides
    (ultralytics' check_anchor_order)."""
    a = torch.tensor(cfg["anchors"], dtype=torch.float32).view(len(cfg["anchors"]), -1, 2)
    s = strides_of(cfg)
    area = a.prod(-1).mean(-1)
    if (area[-1] - area[0]).sign() != torch.tensor(float(s[-1] - s[0])).sign():
        a = a.flip(0)
    return a


def leaf_shapes(cfg: dict) -> dict:
    """{key: shape} of every weight, in the reference layout, unfused."""
    out = {}
    for c in parse(cfg)[2]:
        out[c.key + ("weight" if c.head else "conv.weight")] = (c.c2, c.c1, c.k, c.k)
        if c.head:
            out[c.key + "bias"] = (c.c2,)
        else:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                out[c.key + "bn." + leaf] = (c.c2,)
    return out


def _fp8(t: torch.Tensor, dims) -> torch.Tensor:
    """t rounded to float8 e4m3 under a scale per slice over ``dims``."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Model:
    """The graph of ``cfg`` over the state_dict ``sd`` (float32 tensors on
    one device)."""

    def __init__(self, cfg: dict, sd: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8", "bf16"):
            raise ValueError(f"precision {precision!r}: f32, bf16 or fp8")
        self.cfg = cfg
        self.sd = sd
        self.precision = precision
        self.layers, self.save, self.convs = parse(cfg)
        self.calibrating = False

    def calibrate(self, xs):
        """Run the batches ``xs`` (inputs of different shapes) together, layer
        by layer: each BN takes the statistics of all of them and normalises
        them all with those, and keeps them as its running statistics."""
        self.calibrating = True
        try:
            self._run(list(xs))
        finally:
            self.calibrating = False

    def _conv(self, c: ConvSpec, xs: list) -> list:
        w = self.sd[c.key + ("weight" if c.head else "conv.weight")]
        conv = F.conv2d
        if self.precision == "fp8":
            xs, w = [_fp8(x, (1, 2, 3)) for x in xs], _fp8(w, (1, 2, 3))
        elif self.precision == "bf16":
            conv = lambda a, k, b, s, p: F.conv2d(  # noqa: E731
                a.bfloat16(), k.bfloat16(), None if b is None else b.bfloat16(), s, p).float()
        if c.head:
            return [conv(x, w, self.sd[c.key + "bias"], c.s, c.p) for x in xs]
        ys = [conv(x, w, None, c.s, c.p) for x in xs]
        bn = c.key + "bn."
        if self.calibrating:
            n = sum(y.numel() // y.shape[1] for y in ys)
            mean = sum(y.sum((0, 2, 3)) for y in ys) / n
            var = sum(((y - mean[None, :, None, None]) ** 2).sum((0, 2, 3)) for y in ys) / n
            self.sd[bn + "running_mean"].copy_(mean)
            self.sd[bn + "running_var"].copy_(var)
        mean, var = self.sd[bn + "running_mean"], self.sd[bn + "running_var"]
        scale = self.sd[bn + "weight"] / torch.sqrt(var + BN_EPS)
        shift = self.sd[bn + "bias"] - mean * scale
        return [F.silu(y * scale[None, :, None, None] + shift[None, :, None, None]) for y in ys]

    def _layer(self, kind, info, x):
        """One layer over a list of batches (Concat and Detect: a list of
        inputs, each a list of batches)."""
        if kind == "Conv":
            return self._conv(info["conv"], x)
        if kind == "C3":
            y = self._conv(info["cv1"], x)
            for cv1, cv2 in info["m"]:
                z = self._conv(cv2, self._conv(cv1, y))
                y = [a + b for a, b in zip(y, z)] if info["add"] else z
            y2 = self._conv(info["cv2"], x)
            return self._conv(info["cv3"], [torch.cat([a, b], 1) for a, b in zip(y, y2)])
        if kind == "SPPF":
            x = self._conv(info["cv1"], x)
            k = info["k"]
            pool = lambda t: F.max_pool2d(t, k, 1, k // 2)  # noqa: E731
            y1 = [pool(t) for t in x]
            y2 = [pool(t) for t in y1]
            return self._conv(info["cv2"], [torch.cat([a, b, c, pool(c)], 1)
                                            for a, b, c in zip(x, y1, y2)])
        if kind == "Upsample":
            return [F.interpolate(t, scale_factor=info["scale"], mode="nearest") for t in x]
        if kind == "Concat":
            return [torch.cat(parts, 1) for parts in zip(*x)]
        if kind == "Detect":
            outs = []
            for c, xi in zip(info["m"], x):
                level = []
                for y in self._conv(c, xi):
                    b, _, ny, nx = y.shape
                    level.append(y.view(b, info["na"], info["no"], ny, nx).permute(0, 3, 4, 1, 2))
                outs.append(level)
            return [list(maps) for maps in zip(*outs)]  # per batch, its levels
        raise NotImplementedError(kind)

    @torch.no_grad()
    def _run(self, xs: list) -> list:
        saved = {}
        out = xs
        for i, frm, kind, info in self.layers:
            inp = [out if j == -1 else saved[j] for j in frm]
            out = self._layer(kind, info, inp if kind in ("Concat", "Detect") else inp[0])
            if i in self.save:
                saved[i] = out
        return out

    def __call__(self, x: torch.Tensor):
        """x (bs, 3, H, W) float32 in [0, 1] -> [(bs, ny, nx, na, no)]."""
        return self._run([x])[0]


def decode(maps, cfg: dict) -> torch.Tensor:
    """Head maps -> (bs, N, 5 + nc): xywh in pixels, σ(obj), σ(cls)."""
    strides = strides_of(cfg)
    anchors = anchors_px(cfg).to(maps[0].device)
    out = []
    for y, s, a in zip(maps, strides, anchors):
        b, ny, nx, na, no = y.shape
        gy, gx = torch.meshgrid(torch.arange(ny, device=y.device),
                                torch.arange(nx, device=y.device), indexing="ij")
        grid = torch.stack([gx, gy], -1).float()[:, :, None, :]
        t = torch.sigmoid(y.float())
        xy = (t[..., 0:2] * 2.0 - 0.5 + grid) * s
        wh = (t[..., 2:4] * 2.0) ** 2 * a.view(1, 1, na, 2)
        out.append(torch.cat([xy, wh, t[..., 4:]], -1).reshape(b, ny * nx * na, no))
    return torch.cat(out, 1)


def row_strides(cfg: dict, h: int, w: int, device=None) -> torch.Tensor:
    """The stride of each row of ``decode``'s output for an (h, w) input."""
    na = len(cfg["anchors"][0]) // 2
    return torch.cat([torch.full(((h // s) * (w // s) * na,), float(s), device=device)
                      for s in strides_of(cfg)])
