"""The yolov5 module zoo as ``nn.Module``s, and the head decode.

The port of ``yolov5_tpu/models/layers.py``: Conv (plain with BN, or
``fused`` with BN folded into a conv bias) and every block a YAML config
can name (DWConv, Bottleneck, CrossConv, C3 and its C3x / C3Ghost /
C3TR / C3SPP variants, BottleneckCSP, SPP, SPPF, Focus, GhostConv,
GhostBottleneck, MixConv2d, TransformerBlock, Contract, Expand, Concat,
Upsample; the YAML's MaxPool and ZeroPad are torch's own), the heads
(Detect, the segmentation head Proto / Segment, the classification head
Classify), the layers no YAML names (DWConvTranspose2d, FReLU, AconC), and
``decode_level`` / ``decode``.
Attribute names follow the JAX package's flax names, which are the
reference's torch names where it has them, so a state_dict key reads
``model.{i}.cv1.conv.weight`` (OIHW); ``models.weights`` maps them.

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

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolov5_tpu_torch.ops.epilogue import ACT_CODES, conv_epilogue
from yolov5_tpu_torch.ops.stem import STEM_WIDTHS, stem_conv
from yolov5_tpu_torch.parallel.distributed import all_reduce_sum_grad, world

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
    float32 whatever x's dtype; the output has x's dtype. When several
    processes train, the statistics are those of the global batch
    (``_batch_norm_global``), as under the JAX package's mesh."""
    if world() > 1:
        return _batch_norm_global(x, bn)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1 - m).add_(var, alpha=m)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def _batch_norm_global(x, bn: nn.BatchNorm2d):
    """``batch_norm_train`` over the global batch of several ranks: one
    float32 all-reduce of [sum, sum of squares, count] per layer, through
    which the gradient flows. The sums are taken about the running mean,
    equal on every rank, so that the variance does not cancel in float32."""
    c = x.shape[1]
    k = bn.running_mean.detach().clone().view(1, c, 1, 1)
    d = x.float() - k
    n = d.new_full((1,), float(x.shape[0] * x.shape[2] * x.shape[3]))
    s = all_reduce_sum_grad(torch.cat([d.sum((0, 2, 3)), (d * d).sum((0, 2, 3)), n]))
    dm = s[:c] / s[2 * c]
    var = s[c:2 * c] / s[2 * c] - dm * dm
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(k.view(c) + dm, alpha=m)
        bn.running_var.mul_(1 - m).add_(var, alpha=m)
    y = (d - dm.view(1, c, 1, 1)) * torch.rsqrt(var + bn.eps).view(1, c, 1, 1)
    return (y * bn.weight.view(1, c, 1, 1) + bn.bias.view(1, c, 1, 1)).to(x.dtype)


def batch_norm(c: int) -> nn.BatchNorm2d:
    """A BN of the reference recipe over ``c`` channels."""
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def apply_bn(x, bn, training: bool):
    """x through ``bn`` (None: as it is): ``batch_norm_train`` in training,
    the running statistics in eval."""
    if bn is None:
        return x
    return batch_norm_train(x, bn) if training else bn(x)


def on_card(x) -> bool:
    """Where the epilogue (K3) pays: on the CPU its plain version costs more
    than the conv with its bias and the activation, which a CPU forward keeps."""
    return x.is_cuda


def eager_inference(x, conv: nn.Conv2d) -> bool:
    """Whether the in-place epilogue (K3) may finish a conv on x: x is on the
    card, autograd needs nothing of it, and no graph is being traced
    (``torch.export`` keeps the conv with its bias)."""
    if not on_card(x) or torch.compiler.is_compiling():
        return False
    return not torch.is_grad_enabled() or not (
        x.requires_grad or conv.weight.requires_grad or conv.bias.requires_grad)


def conv_with_epilogue(x, conv: nn.Conv2d, act: str, residual=None):
    """``conv`` (which has a bias) on x without its bias, then bias, ``act``
    and the residual in one pass (``ops.epilogue.conv_epilogue``)."""
    y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation, conv.groups)
    return conv_epilogue(y, conv.bias, act, residual)


class Conv(nn.Module):
    """Conv2d + BatchNorm + activation; ``fused`` means BN is folded into the
    conv's weight and bias.

    The fused 6x6/s2/p2 SiLU stem on 3 channels goes to kernel K2
    (``ops.stem.stem_conv``), which runs its CUDA kernel on a CUDA tensor.
    Any other fused Conv with SiLU or no activation ends in kernel K3
    (``conv_with_epilogue``) on the card wherever autograd needs no gradient;
    there a ``residual`` is added in the same pass."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act="silu", fused=False):
        super().__init__()
        pad = autopad(k, p, d)
        self.conv = nn.Conv2d(c1, c2, k, s, pad, groups=g, dilation=d, bias=fused)
        self.bn = None if fused else batch_norm(c2)
        self.act = ACTIVATIONS[act]
        self.stem = (fused and c1 == 3 and c2 in STEM_WIDTHS and k == 6 and s == 2
                     and pad == 2 and g == 1 and d == 1 and act == "silu")
        self.epilogue = act if fused and act in ACT_CODES and not self.stem else None

    def forward(self, x, residual=None):
        if self.stem:
            return stem_conv(x, self.conv.weight, self.conv.bias)
        if self.epilogue and eager_inference(x, self.conv):
            return conv_with_epilogue(x, self.conv, self.epilogue, residual)
        y = self.act(apply_bn(self.conv(x), self.bn, self.training))
        return y if residual is None else residual + y


class Bottleneck(nn.Module):
    """Residual bottleneck: x + cv2(cv1(x)) when shapes allow, the add done
    inside cv2."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5, act="silu", fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, act=act, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        return self.cv2(self.cv1(x), x if self.add else None)


class DWConv(Conv):
    """Depthwise-style Conv: groups gcd(c1, c2) (the JAX package's ``DWConv``,
    a Conv with ``g = -1``; same keys as Conv)."""

    def __init__(self, c1, c2, k=1, s=1, act="silu", fused=False):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act, fused=fused)


class CrossConv(nn.Module):
    """A 1xk then kx1 conv pair, each with BN and SiLU, plus the input when
    ``shortcut`` and the shapes allow. The JAX layer names its convs and BNs
    ``cv1_conv``/``cv1_bn`` and ``cv2_conv``/``cv2_bn``; fused, each conv
    carries its BN as a bias."""

    def __init__(self, c1, c2, k=3, s=1, g=1, e=1.0, shortcut=False, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        p = autopad(k)
        self.cv1_conv = nn.Conv2d(c1, c_, (1, k), (1, s), (0, p), bias=fused)
        self.cv1_bn = None if fused else batch_norm(c_)
        self.cv2_conv = nn.Conv2d(c_, c2, (k, 1), (s, 1), (p, 0), groups=g, bias=fused)
        self.cv2_bn = None if fused else batch_norm(c2)
        self.add = shortcut and c1 == c2 and s == 1

    def forward(self, x):
        y = F.silu(apply_bn(self.cv1_conv(x), self.cv1_bn, self.training))
        y = F.silu(apply_bn(self.cv2_conv(y), self.cv2_bn, self.training))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: cv3(cat(m(cv1(x)), cv2(x))); ``inner``
    gives the blocks of ``m`` (Bottleneck here, other blocks in the
    variants)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act="silu", fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv2 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv3 = Conv(2 * c_, c2, 1, 1, act=act, fused=fused)
        self.m = nn.Sequential(*(self.inner(c_, shortcut, g, act, fused) for _ in range(n)))

    def inner(self, c_, shortcut, g, act, fused):
        return Bottleneck(c_, c_, shortcut, g, e=1.0, act=act, fused=fused)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3x(C3):
    """C3 with CrossConv blocks (k = 3, e = 1)."""

    def inner(self, c_, shortcut, g, act, fused):
        return CrossConv(c_, c_, 3, 1, g, 1.0, shortcut, fused=fused)


class C3Ghost(C3):
    """C3 with GhostBottleneck blocks."""

    def inner(self, c_, shortcut, g, act, fused):
        return GhostBottleneck(c_, c_, fused=fused)


class C3TR(C3):
    """C3 whose ``m`` is one TransformerBlock of ``n`` layers and 4 heads;
    its convs are SiLU whatever ``act`` says, as in the JAX layer."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act="silu", fused=False):
        super().__init__(c1, c2, 0, shortcut, g, e, "silu", fused)
        c_ = int(c2 * e)
        self.m = nn.Sequential(TransformerBlock(c_, c_, 4, n, fused=fused))


class C3SPP(C3):
    """C3 whose ``m`` is one SPP with pool sizes ``k``."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act="silu", fused=False,
                 k=(5, 9, 13)):
        super().__init__(c1, c2, 0, shortcut, g, e, "silu", fused)
        c_ = int(c2 * e)
        self.m = nn.Sequential(SPP(c_, c_, k, fused=fused))


class BottleneckCSP(nn.Module):
    """The original CSP bottleneck: cv4(SiLU(bn(cat(cv3(m(cv1(x))),
    cv2(x))))), cv2 and cv3 plain 1x1 convs without bias. Its ``bn`` follows
    a concat, so no conv takes it in: it stays when the model is fused."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, fused=fused)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv4 = Conv(2 * c_, c2, 1, 1, fused=fused)
        self.bn = batch_norm(2 * c_)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0, fused=fused)
                                 for _ in range(n)))

    def forward(self, x):
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(F.silu(apply_bn(y, self.bn, self.training)))


class SPP(nn.Module):
    """Spatial pyramid pooling: cv2(cat(x, maxpool_k(x) for k in ``k``)),
    x = cv1(input), stride 1, 'same' padding."""

    def __init__(self, c1, c2, k=(5, 9, 13), act="silu", fused=False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, act=act, fused=fused)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1, act=act, fused=fused)
        self.m = nn.ModuleList(nn.MaxPool2d(j, 1, j // 2) for j in k)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x, *(m(x) for m in self.m)], 1))


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


class Focus(nn.Module):
    """Space to depth by 2 (the pixel phases (0,0), (1,0), (0,1), (1,1) in
    that order along channels), then a Conv."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, fused=False):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, fused=fused)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                    x[..., 1::2, 1::2]], 1))


class GhostConv(nn.Module):
    """Ghost conv: a Conv to c2/2 channels, and a depthwise 5x5 Conv of that,
    concatenated (both SiLU, as in the JAX layer)."""

    def __init__(self, c1, c2, k=1, s=1, g=1, fused=False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, fused=fused)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, fused=fused)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: gc2(dw(gc1(x))) + shortcut, the depthwise ``dw`` and
    the shortcut's ``sc_dw`` only at stride 2, the shortcut's 1x1 ``sc_pw``
    where the channels differ. The JAX layer's quirk stays: ``gc2`` keeps
    its SiLU (the reference's has none); ``dw``, ``sc_dw`` and ``sc_pw``
    have no activation."""

    def __init__(self, c1, c2, k=3, s=1, fused=False):
        super().__init__()
        c_ = c2 // 2
        self.gc1 = GhostConv(c1, c_, 1, 1, fused=fused)
        self.dw = DWConv(c_, c_, k, s, act="identity", fused=fused) if s == 2 else None
        self.gc2 = GhostConv(c_, c2, 1, 1, fused=fused)
        self.sc_dw = DWConv(c1, c1, k, s, act="identity", fused=fused) if s == 2 else None
        self.sc_pw = (Conv(c1, c2, 1, 1, act="identity", fused=fused)
                      if s == 2 or c1 != c2 else None)

    def forward(self, x):
        y = self.gc1(x)
        if self.dw is not None:
            y = self.dw(y)
        y = self.gc2(y)
        sc = x if self.sc_dw is None else self.sc_dw(x)
        return y + (sc if self.sc_pw is None else self.sc_pw(sc))


class MixConv2d(nn.Module):
    """Mixed kernel sizes: one conv per k in ``k`` over the whole input, to
    c2 // len(k) channels each (one more for the first c2 % len(k)),
    concatenated, then BN and SiLU. Fused, each conv carries its slice of
    the BN as a bias."""

    def __init__(self, c1, c2, k=(1, 3), s=1, fused=False):
        super().__init__()
        n = len(k)
        splits = [c2 // n + (1 if i < c2 % n else 0) for i in range(n)]
        self.m = nn.ModuleList(nn.Conv2d(c1, c, j, s, j // 2, bias=fused)
                               for j, c in zip(k, splits))
        self.bn = None if fused else batch_norm(c2)

    def forward(self, x):
        y = torch.cat([m(x) for m in self.m], 1)
        return F.silu(apply_bn(y, self.bn, self.training))


class Contract(nn.Module):
    """Space to channels by ``gain``: (b, c, h, w) -> (b, c·g², h/g, w/g),
    channel (gy·g + gx)·c + ci."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.gain
        x = x.reshape(b, c, h // g, g, w // g, g).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * g * g, h // g, w // g).contiguous(
            memory_format=torch.channels_last)


class Expand(nn.Module):
    """Channels to space by ``gain``, the inverse of Contract."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.gain
        x = x.reshape(b, g, g, c // (g * g), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // (g * g), h * g, w * g).contiguous(
            memory_format=torch.channels_last)


class TransformerLayer(nn.Module):
    """The JAX package's attention layer over (b, L, c) tokens: q, k, v
    linears without bias, scaled dot-product attention over ``num_heads``
    heads with the softmax in float32, ``ma_out`` (with bias) and the
    residual, then fc2(fc1(x)) (with biases) and the residual. (The
    reference's layer has an ``nn.MultiheadAttention`` with an in-projection
    and fc1/fc2 without bias: its weights map onto neither package.)"""

    def __init__(self, c, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma_out = nn.Linear(c, c)
        self.fc1 = nn.Linear(c, c)
        self.fc2 = nn.Linear(c, c)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        q, k, v = (f(x).reshape(b, n, h, c // h).transpose(1, 2)
                   for f in (self.q, self.k, self.v))
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(c // h)
        attn = torch.softmax(attn.float(), -1).to(q.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        x = self.ma_out(out) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """A Conv to c2 channels where c1 differs, then the h·w pixels as tokens:
    p + linear(p), ``n`` TransformerLayers, and back to (b, c2, h, w)."""

    def __init__(self, c1, c2, num_heads, n=1, fused=False):
        super().__init__()
        self.conv = Conv(c1, c2, fused=fused) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(n)))

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        p = self.tr(p + self.linear(p))
        # (b, hw, c) contiguous is the channels_last storage of (b, c, h, w)
        return p.transpose(1, 2).reshape(b, c, h, w)


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


class DWConvTranspose2d(nn.Module):
    """Depthwise-style transposed conv, groups gcd(c1, c2): out = s·(in - 1)
    + k - 2·p1 + p2. ``conv`` holds the weight (c2, c1/g, k, k) and bias of
    the equivalent convolution over the s-dilated input, as the JAX layer
    keeps its kernel; the forward flips it and swaps its in and out channels
    within each group into ``conv_transpose2d``'s (c1, c2/g, k, k). (The JAX
    layer has no output padding: p2 must be 0 to match it.)"""

    def __init__(self, c1, c2, k=1, s=1, p1=0, p2=0):
        super().__init__()
        self.g, self.s, self.p1, self.p2 = math.gcd(c1, c2), s, p1, p2
        self.conv = nn.Conv2d(c1, c2, k, groups=self.g)

    def forward(self, x):
        w = self.conv.weight
        c2, cig, k, _ = w.shape
        g = self.g
        wt = (w.flip(-1, -2).reshape(g, c2 // g, cig, k, k).transpose(1, 2)
              .reshape(g * cig, c2 // g, k, k))
        return F.conv_transpose2d(x, wt, self.conv.bias, self.s, self.p1, self.p2, groups=g)


class FReLU(nn.Module):
    """Funnel activation: max(x, bn(depthwise 3x3 conv(x))). Its BN is never
    folded, as in the JAX layer."""

    def __init__(self, c1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c1, 3, 1, 1, groups=c1, bias=False)
        self.bn = batch_norm(c1)

    def forward(self, x):
        return torch.maximum(x, apply_bn(self.conv(x), self.bn, self.training))


class AconC(nn.Module):
    """ACON-C: (p1 - p2)·x·σ(β·(p1 - p2)·x) + p2·x with learnt per-channel
    p1, p2 and β, each (1, c1, 1, 1) as in the reference (the JAX layer's
    are (c1,); ``models.weights`` reshapes them)."""

    def __init__(self, c1):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.beta = nn.Parameter(torch.ones(1, c1, 1, 1))

    def forward(self, x):
        dpx = (self.p1 - self.p2) * x
        return dpx * torch.sigmoid(self.beta * dpx) + self.p2 * x


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
    coefficients, 0 for detection). Each conv's bias is added by kernel K3
    on the card wherever autograd needs no gradient."""

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
            if eager_inference(x, conv):
                y = conv_with_epilogue(x, conv, "identity")
            else:
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
