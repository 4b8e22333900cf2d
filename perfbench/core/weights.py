"""Seeded weights of a configuration, made on the device in a few large
calls and calibrated on the cell's own images, as a state_dict in the
reference's key layout (float32) that both sides are handed.

  - conv weights U(±1/sqrt(fan_in)), the Detect convs' HEAD_GAIN times
    that; BN scales U(0.1, 0.3), shifts N(0, 0.1);
  - Detect biases N(0, 0.5) for the box and objectness, N(-2, 1) for the
    classes;
  - BN running statistics: those of the cell's images, layer after layer,
    pooled over the batches of each input shape (every layer's output is
    normalised, so detections depend on the image);
  - then one scalar added to every objectness bias, found by bisection on
    the same images, so that about ``per_img`` candidates an image pass
    ``conf_thres`` (box-class pairs with ``multi_label``), or, given
    ``nms``, so that the reference's NMS keeps about ``per_img`` detections
    an image (the work of the suppression and of the host after it grows
    with them, so a cell whose rate they move holds them, not the
    candidates, equal from seed to seed).

The small BN scales keep each layer near its linear range: with scales
around 1, a random BN network amplifies a perturbation layer after layer
(bfloat16's rounding reached 30% of the last features' norm in yolov5s),
which trained weights do not; the head's gain gives back the logits a
spread of about one, so that what is detected depends on the image.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import yolo

HEAD_GAIN = 10.0
# the objectness shift is searched in (-SHIFT, SHIFT): the head's gain gives
# some images' best rows logits of several tens
SHIFT = 1000.0


def _draw(cfg: dict, gen: torch.Generator, device) -> dict:
    shapes = yolo.leaf_shapes(cfg)
    uniform, normal = [], []  # (key, shape, scale, offset) / (key, shape, std, mean)
    for k, s in shapes.items():
        if k.endswith("conv.weight"):
            uniform.append((k, s, 1.0 / math.sqrt(math.prod(s[1:])), 0.0))
        elif k.endswith("bn.weight"):
            uniform.append((k, s, 0.1, 0.2))
        elif k.endswith("weight"):  # a Detect conv's
            uniform.append((k, s, HEAD_GAIN / math.sqrt(math.prod(s[1:])), 0.0))
        elif k.endswith("bn.bias"):
            normal.append((k, s, 0.1, 0.0))
        elif k.endswith("bias"):  # a Detect conv's: (na·no,)
            normal.append((k, s, None, None))
    sd = {}
    nc = cfg["nc"]
    for rows, fill in ((uniform, "uniform"), (normal, "normal")):
        numels = torch.tensor([math.prod(r[1]) for r in rows], device=device)
        flat = torch.empty(int(numels.sum()), device=device)
        if fill == "uniform":
            flat.uniform_(-1.0, 1.0, generator=gen)
        else:
            flat.normal_(0.0, 1.0, generator=gen)
        scale = torch.cat([torch.full((math.prod(s),), a, device=device) if a is not None
                           else _head_slots(s[0], nc, 0.5, 1.0, device) for _, s, a, _ in rows])
        offset = torch.cat([torch.full((math.prod(s),), m, device=device) if m is not None
                            else _head_slots(s[0], nc, 0.0, -2.0, device) for _, s, _, m in rows])
        flat = flat * scale + offset
        for (k, s, _, _), t in zip(rows, torch.split(flat, numels.tolist())):
            sd[k] = t.view(s)
    for k, s in shapes.items():
        if k.endswith("running_mean"):
            sd[k] = torch.zeros(s, device=device)
        elif k.endswith("running_var"):
            sd[k] = torch.ones(s, device=device)
    return sd


def _head_slots(n: int, nc: int, box_obj: float, classes: float, device) -> torch.Tensor:
    """A value per slot of a Detect conv's (na·no,) biases: ``box_obj`` for
    the box and objectness, ``classes`` for the classes."""
    one = torch.full((nc + 5,), classes, device=device)
    one[:5] = box_obj
    return one.repeat(n // (nc + 5))


def _count(obj, cls_sig, delta, conf, multi_label):
    """Mean candidates per image passing ``conf`` with objectness logits
    shifted by ``delta``."""
    o = torch.sigmoid(obj + delta)
    if multi_label:
        return float((o[..., None] * cls_sig > conf).sum((1, 2)).float().mean())
    return float((o * cls_sig.amax(-1) > conf).sum(1).float().mean())


def _kept(all_maps, cfg, delta, conf, nms):
    """Mean detections per image that the reference's NMS keeps with the
    objectness logits shifted by ``delta`` (single-label), over every batch
    of ``all_maps`` in one walk."""
    from perfbench.reference import nms as ref_nms

    parts = []
    for maps in all_maps:
        pred = yolo.decode([torch.cat([m[..., :4], m[..., 4:5] + delta, m[..., 5:]], -1)
                            for m in maps], cfg)
        parts.append(ref_nms.select(pred, conf, False, nms["max_nms"])[:3])
    k = max(p[0].shape[1] for p in parts)
    pad = lambda t, *v: torch.nn.functional.pad(t, (*v, 0, k - t.shape[1]))  # noqa: E731
    scores = torch.cat([pad(p[0]) for p in parts])
    boxes = torch.cat([pad(p[1], 0, 0) for p in parts])
    classes = torch.cat([pad(p[2]) for p in parts])
    keep, _ = ref_nms.greedy(boxes + classes[..., None].float() * ref_nms.MAX_WH, scores,
                             nms["iou_thres"], nms["max_det"])
    return float(keep.sum()) / len(keep)


def _bisect(count, target, lo=-SHIFT, hi=SHIFT, steps=64):
    """The shift at which the increasing ``count`` crosses ``target``."""
    for _ in range(steps):
        mid = (lo + hi) / 2
        if count(mid) < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


@torch.no_grad()
def calibrated(cfg: dict, seed: int, batches, conf_thres: float, per_img: float,
               multi_label: bool, device, nms=None, count_batches=None):
    """The state_dict, the measured count per image at the found shift, and
    the shift. ``batches``: (n, h, w, 3) uint8 RGB batches on ``device``
    (one, or one per input shape); BN takes the statistics of all of them.
    ``nms`` (iou_thres, max_det, max_nms): count the detections kept;
    ``count_batches``: count over these batches instead."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sd = _draw(cfg, gen, device)
    xs = [b.permute(0, 3, 1, 2).float().div(255.0).contiguous() for b in batches]
    model = yolo.Model(cfg, sd)
    model.calibrate(xs)
    conf = float(torch.tensor(conf_thres, dtype=torch.float32))
    counted = [b.permute(0, 3, 1, 2).float().div(255.0).contiguous() for b in count_batches] \
        if count_batches is not None else xs
    all_maps = [model(x) for x in counted]
    parts = [(torch.cat([m[..., 4].reshape(len(x), -1) for m in maps], 1),
              torch.sigmoid(torch.cat([m[..., 5:].reshape(len(x), -1, cfg["nc"]) for m in maps], 1)))
             for x, maps in zip(counted, all_maps)]

    def candidates(delta):
        n = sum(_count(o, c, delta, conf, multi_label) * len(o) for o, c in parts)
        return n / sum(len(o) for o, _ in parts)

    delta = _bisect(candidates, per_img)
    count = candidates
    if nms is not None:  # kept <= candidates: the shift lies above that one
        count = lambda d: _kept(all_maps, cfg, d, conf_thres, nms)  # noqa: E731
        hi = _bisect(candidates, 16 * per_img)
        if count(hi) < per_img:
            hi = SHIFT
        delta = _bisect(count, per_img, lo=delta, hi=hi, steps=16)
    measured = count(delta)
    na = len(cfg["anchors"][0]) // 2
    for k in sd:
        if k.endswith("bias") and ".bn." not in k:
            sd[k].view(na, -1)[:, 4] += delta
    return sd, measured, delta
