"""The canonical yolov5 blocks as ``nn.Module``s, and the head decode.

The port of the canonical path of ``yolov5_tpu/models/layers.py``: Conv
(plain with BN, or ``fused`` with BN folded into a conv bias), Bottleneck, C3,
SPPF, Concat, Upsample (nearest), Detect, the segmentation head (Proto,
Segment) and the classification head (Classify), plus ``decode_level`` /
``decode``. Attribute names follow the reference's torch modules, so a
state_dict key reads ``model.{i}.cv1.conv.weight`` (OIHW).

Activations are NCHW tensors in ``torch.channels_last`` memory format, whose
storage is NHWC like the JAX package's arrays. Detect returns the JAX
layout, (bs, ny, nx, na, no), as a view of its channels_last conv output,
in training and in inference alike: the loss reads the raw maps. Segment
returns ``(maps, proto)`` with ``proto`` (bs, hm, wm, nm), also a view.

In train mode BN follows flax, not ``torch.nn.BatchNorm2d``: it normalizes
with the batch's biased variance and moves the running variance with that
same biased variance (``batch_norm_train``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolov5_tpu_torch.ops.stem import STEM_WIDTHS, stem_conv

# the reference training recipe: torch BatchNorm2d(momentum=0.03, eps=1e-3)
BN_MOMENTUM = 0.03
BN_EPS = 1e-3

ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.1),
    "hardswish": F.hardswish,
    "mish": F.mish,
    "identity": lambda x: x,
}


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same'-style pad for odd kernels."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def batch_norm_train(x, bn: nn.BatchNorm2d):
    """Train-mode batch norm as flax computes it: normalize by the batch mean
    and biased variance, and move the running statistics toward the batch
    mean and the BIASED variance (torch's BatchNorm2d moves the running
    variance toward the unbiased one, n/(n-1) larger). The statistics are
    float32 whatever x's dtype; the output has x's dtype."""
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1 - m).add_(var, alpha=m)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


class Conv(nn.Module):
    """Conv2d + BatchNorm + activation; ``fused`` means BN is folded into the
    conv's weight and bias.

    The fused 6x6/s2/p2 SiLU stem on 3 channels goes to kernel K2
    (``ops.stem.stem_conv``), which runs its CUDA kernel on a CUDA tensor."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act="silu", fused=False):
        super().__init__()
        pad = autopad(k, p, d)
        self.conv = nn.Conv2d(c1, c2, k, s, pad, groups=g, dilation=d, bias=fused)
        self.bn = None if fused else nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = ACTIVATIONS[act]
        self.stem = (fused and c1 == 3 and c2 in STEM_WIDTHS and k == 6 and s == 2
                     and pad == 2 and g == 1 and d == 1 and act == "silu")

    def forward(self, x):
        if self.stem:
            return stem_conv(x, self.conv.weight, self.conv.bias)
        x = self.conv(x)
        if self.bn is not None:
            x = batch_norm_train(x, self.bn) if self.training else self.bn(x)
        return self.act(x)


class Bottleneck(nn.Module):
    """Residual bottleneck: x + cv2(cv1(x)) when shapes allow."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5, act="silu", fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, act=act, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: cv3(cat(m(cv1(x)), cv2(x)))."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act="silu", fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv2 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv3 = Conv(2 * c_, c2, 1, 1, act=act, fused=fused)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0, act=act, fused=fused)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    """Fast SPP: 3 chained k=5 max pools, concatenated with their input."""

    def __init__(self, c1, c2, k=5, act="silu", fused=False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv2 = Conv(c_ * 4, c2, 1, 1, act=act, fused=fused)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat([x, y1, y2, self.m(y2)], 1))


class Concat(nn.Module):
    """Concatenate along channels."""

    def forward(self, xs):
        return torch.cat(xs, 1)


class Upsample(nn.Module):
    """Nearest-neighbour upsample by an integer factor."""

    def __init__(self, scale=2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Proto(nn.Module):
    """Mask prototypes: Conv 3x3 -> nearest upsample x2 -> Conv 3x3 -> Conv
    1x1 to ``c2`` prototypes (reference models/common.py:1104-1117)."""

    def __init__(self, c1, c_=256, c2=32, fused=False):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3, fused=fused)
        self.up = Upsample(2)
        self.cv2 = Conv(c_, c_, 3, fused=fused)
        self.cv3 = Conv(c_, c2, 1, fused=fused)

    def forward(self, x):
        return self.cv3(self.cv2(self.up(self.cv1(x))))


class Detect(nn.Module):
    """Anchor-based detection head: one 1x1 conv per level, each output
    returned as raw logits (bs, ny, nx, na, no), no = nc + 5 + nm (nm mask
    coefficients, 0 for detection)."""

    def __init__(self, nc, anchors, ch, nm=0):
        super().__init__()
        self.nc = nc
        self.nm = nm
        self.no = nc + 5 + nm
        self.na = len(anchors[0])
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1) for c in ch)

    def forward(self, xs):
        outs = []
        for conv, x in zip(self.m, xs):
            y = conv(x)
            b, _, ny, nx = y.shape
            # channels_last storage is (b, ny, nx, na*no): a view, no copy
            outs.append(y.permute(0, 2, 3, 1).reshape(b, ny, nx, self.na, self.no))
        return outs


class Segment(Detect):
    """Detect with ``nm`` mask coefficients per anchor, and Proto on the first
    level's features (reference models/yolo.py:131-150). Returns ``(maps,
    proto)``, proto (bs, hm, wm, nm) as a view of its channels_last output."""

    def __init__(self, nc, anchors, ch, nm=32, npr=256, fused=False):
        super().__init__(nc, anchors, ch, nm)
        self.proto = Proto(ch[0], npr, nm, fused=fused)

    def forward(self, xs):
        return super().forward(xs), self.proto(xs[0]).permute(0, 2, 3, 1)


class Classify(nn.Module):
    """Classification head (reference models/common.py:1120-1140): a Conv to
    1280 channels, the global mean over H and W, dropout and ``linear`` to
    ``c2`` logits. The JAX package's flax ``Dense`` named ``linear`` gives the
    keys ``model.{i}.linear.weight`` (out, in) and ``.bias``."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, dropout_p=0.0, fused=False):
        super().__init__()
        self.conv = Conv(c1, 1280, k, s, p, g, fused=fused)
        self.drop = nn.Dropout(dropout_p)
        self.linear = nn.Linear(1280, c2)

    def forward(self, x):
        return self.linear(self.drop(self.conv(x).mean((2, 3))))


def decode_level(y, anchors_px, stride, dtype=torch.float32, nc=None):
    """Decode one raw head map (bs, ny, nx, na, no) to (bs, ny*nx*na, no):
      xy = (2σ(t_xy) - 0.5 + grid) * stride,  wh = (2σ(t_wh))² * anchor,
    σ on obj+cls; a tail past 5+nc (mask coefficients) stays raw."""
    b, ny, nx, na, no = y.shape
    sig_stop = no if nc is None else 5 + nc
    y = y.to(dtype)
    gy, gx = torch.meshgrid(torch.arange(ny, device=y.device),
                            torch.arange(nx, device=y.device), indexing="ij")
    grid = torch.stack([gx, gy], -1).to(dtype)[:, :, None, :]  # (ny, nx, 1, 2)
    anchors_px = torch.as_tensor(anchors_px, dtype=dtype, device=y.device)[None, None]
    xy = (torch.sigmoid(y[..., 0:2]) * 2.0 - 0.5 + grid) * stride
    wh = (torch.sigmoid(y[..., 2:4]) * 2.0) ** 2 * anchors_px
    pieces = [xy, wh, torch.sigmoid(y[..., 4:sig_stop])]
    if sig_stop < no:
        pieces.append(y[..., sig_stop:])
    return torch.cat(pieces, -1).reshape(b, ny * nx * na, no)


def decode(outs, anchors, strides, dtype=torch.float32, nc=None):
    """Decode all levels and concat: list[(bs,ny,nx,na,no)] -> (bs, N, no)."""
    return torch.cat([decode_level(y, a, s, dtype, nc=nc)
                      for y, a, s in zip(outs, anchors, strides)], 1)
