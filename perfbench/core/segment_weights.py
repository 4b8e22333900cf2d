"""Seeded weights of a segmentation configuration, calibrated on the cell's
own images, as a state_dict in the reference's key layout (float32): the
rules of ``weights.py`` for the detection graph, and

  - every BN scale at ``BN_GAIN`` of ``weights.py``'s, U(0.05, 0.15): with
    U(0.1, 0.3) bfloat16's rounding moved yolov5x-seg's prototypes by
    33-67% of their norm on the cell's 640 px frames and float8's by
    91-139% (H100, 12 and 6 seeds), too near to tell apart; at half,
    yolov5l-seg's at 320 px moved 0.6-0.7% and 9% (on a CPU);
  - the Segment convs' objectness rows at ``OBJ_GAIN`` of the head's gain:
    at the full gain one image's objectness logits lie tens above another's,
    and the shift below that gives ``per_img`` candidates on average left
    107-201 of the cell's 256 images without one on two seeds of three (no
    image on any at a tenth; H100, three seeds);
  - the Segment convs' biases: the box and objectness N(0, 0.5) and the
    classes N(-2, 1), as a Detect conv's, and the nm coefficients N(0, 0.5),
    so that a mask σ(coefficients · prototypes) covers part of its box and
    not nothing;
  - the Proto's three convs drawn as every other conv with its BN, their BN
    statistics those of the same images;
  - one scalar added to every objectness bias, found by bisection, so that
    about ``per_img`` box-class pairs an image pass ``conf_thres`` (the
    coefficient columns are not classes and are not counted);
  - then one scalar added to every coefficient bias, found by bisection on
    the same images, so that the median mask of their best detections
    (single-label NMS, ``MASK_DETS`` an image) covers ``MASK_FILL`` of its
    box at the prototypes' resolution, or as near as a shift within
    ``COEFF_SHIFT`` comes: with random weights a mask's coefficients ·
    prototypes carry an offset that can leave most masks of a seed empty.
"""

from __future__ import annotations

import math

import torch

from perfbench.core import weights
from perfbench.reference import segment, yolo

COEFF_STD = 0.5
OBJ_GAIN = 0.1
BN_GAIN = 0.5
MASK_FILL = 0.5
MASK_DETS = 50
# the coefficient shift is searched in (-COEFF_SHIFT, COEFF_SHIFT), a few of
# the coefficients' own spread: further out every mask would be the sign of
# the prototypes' sum, whatever its coefficients
COEFF_SHIFT = 4.0


@torch.no_grad()
def draw(cfg: dict, gen: torch.Generator, device) -> dict:
    """The state_dict of ``cfg`` before calibration: the detect view's
    draws (``weights._draw``), then the objectness rows' gain, the
    coefficient biases, the Proto, and the BN scales' gain."""
    nc = cfg["nc"]
    view = segment.detect_view(cfg)
    sd = weights._draw(view, gen, device)
    na = len(cfg["anchors"][0]) // 2
    for c in yolo.parse(view)[2]:
        if c.head:
            sd[c.key + "weight"].view(na, -1, c.c1)[:, 4] *= OBJ_GAIN
            b = sd[c.key + "bias"].view(na, -1)
            b[:, 5 + nc:].normal_(0.0, COEFF_STD, generator=gen)
    for c in segment.proto_specs(cfg):
        p = c.key
        sd[p + "conv.weight"] = (torch.rand((c.c2, c.c1, c.k, c.k), generator=gen, device=device)
                                 * 2 - 1) / math.sqrt(c.c1 * c.k * c.k)
        sd[p + "bn.weight"] = torch.rand(c.c2, generator=gen, device=device) * 0.2 + 0.1
        sd[p + "bn.bias"] = torch.randn(c.c2, generator=gen, device=device) * 0.1
        sd[p + "bn.running_mean"] = torch.zeros(c.c2, device=device)
        sd[p + "bn.running_var"] = torch.ones(c.c2, device=device)
    for k in sd:
        if k.endswith("bn.weight"):
            sd[k] *= BN_GAIN
    return sd


@torch.no_grad()
def calibrated(cfg: dict, seed: int, batches, conf_thres: float, per_img: float, device,
               nms: dict):
    """(state_dict, candidates an image at the found objectness shift, that
    shift, the median mask fill at the found coefficient shift, that shift).
    ``batches``: (n, h, w, 3) uint8 RGB batches on ``device``; BN takes the
    statistics of all of them, and the box-class pairs over ``conf_thres``
    (every passing class, as the multi-label NMS counts them) are counted
    over them. ``nms``: iou_thres and max_nms of the detections whose masks
    the coefficient shift is set on."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sd = draw(cfg, gen, device)
    xs = [b.permute(0, 3, 1, 2).float().div(255.0).contiguous() for b in batches]
    model = segment.Model(cfg, sd)
    model.calibrate(xs)
    nc = cfg["nc"]
    conf = float(torch.tensor(conf_thres, dtype=torch.float32))
    parts = []
    for x in xs:
        maps, _ = model(x)
        parts.append((torch.cat([m[..., 4].reshape(len(x), -1) for m in maps], 1),
                      torch.sigmoid(torch.cat([m[..., 5:5 + nc].reshape(len(x), -1, nc)
                                               for m in maps], 1))))

    def candidates(delta):
        n = sum(weights._count(o, c, delta, conf, True) * len(o) for o, c in parts)
        return n / sum(len(o) for o, _ in parts)

    delta = weights._bisect(candidates, per_img)
    measured = candidates(delta)
    na = len(cfg["anchors"][0]) // 2
    heads = [c for c in yolo.parse(segment.detect_view(cfg))[2] if c.head]
    for c in heads:
        sd[c.key + "bias"].view(na, -1)[:, 4] += delta
    fill = _mask_fill(model, cfg, xs, conf, nms)
    if fill is None:  # no detection to set it on
        return sd, measured, delta, None, 0.0
    # the fill grows with the shift where the prototypes sum above 0, else falls
    sign = 1.0 if fill(COEFF_SHIFT) >= fill(-COEFF_SHIFT) else -1.0
    shift = sign * weights._bisect(lambda d: fill(sign * d), MASK_FILL, lo=-COEFF_SHIFT,
                                   hi=COEFF_SHIFT)
    for c in heads:
        sd[c.key + "bias"].view(na, -1)[:, 5 + nc:] += shift
    return sd, measured, delta, fill(shift), shift


def _mask_fill(model, cfg, xs, conf, nms):
    """The median share of its box that a mask of the best detections of
    ``xs`` covers, at the prototypes' resolution, as a function of a shift
    of every coefficient (what a shift of the coefficient biases gives);
    None where ``xs`` have no detection."""
    nm = segment.segment_row(cfg)[2]
    parts = []
    for x in xs:
        maps, protos = model(x)
        pred, coeffs = segment.decode(maps, cfg)
        rows = segment.nms(pred, coeffs, conf, nms["iou_thres"], MASK_DETS, nms["max_nms"],
                           multi_label=False)
        hm, wm = protos.shape[2:]
        for b, r in enumerate(rows):
            if not len(r):
                continue
            r = torch.from_numpy(r).to(x.device)
            box = r[:, :4] * torch.tensor([wm / x.shape[3], hm / x.shape[2]] * 2, device=x.device)
            inside = segment.crop_mask(torch.ones(len(r), hm, wm, device=x.device), box)
            p = protos[b].reshape(nm, -1)
            parts.append((r[:, -nm:] @ p, p.sum(0), inside.reshape(len(r), hm * wm)))

    if not parts:
        return None

    def fill(shift):
        shares = [((cp + shift * ps > 0) * inside).sum(1) / inside.sum(1).clamp(min=1)
                  for cp, ps, inside in parts]
        return float(torch.cat(shares).median())

    return fill
