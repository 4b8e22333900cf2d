"""Operations and bytes of a segmentation configuration from its shapes: the
model's convs with the Proto and the Segment head, and the least time of the
validation's mask stage (``masks_roofline.segval``). Nothing here reads what
the program counts; the peaks are ``flops.py``'s.
"""

from __future__ import annotations

from perfbench.core import flops
from perfbench.reference import segment


def conv_macs(cfg: dict, h: int, w: int, bn: bool = False) -> int:
    """Multiply-accumulates of every conv of a segmentation ``cfg`` on one
    (3, h, w) image: the detect view's (the Segment convs with their
    biases) and the Proto's, cv1 at the first level's size (h/8), cv2 and
    cv3 after its x2 upsample; with ``bn`` two more per BN output element."""
    total = flops.conv_macs(segment.detect_view(cfg), h, w, bn=bn)
    hw = (h // 8, w // 8)
    for c in segment.proto_specs(cfg):
        if c.k == 3 and c.key.endswith("cv2."):
            hw = (hw[0] * 2, hw[1] * 2)
        total += c.c2 * hw[0] * hw[1] * (c.c1 * c.k * c.k + (2 if bn else 0))
    return total


def model_flops(cfg: dict, h: int, w: int) -> float:
    """FLOPs of one forward of one (3, h, w) image, BN folded."""
    return 2.0 * conv_macs(cfg, h, w)


def mask_stage_ops(n: int, g: int, s: int, hm: int, wm: int, nm: int) -> float:
    """Operations of one image's mask IoUs at an (s, s) input: n·hm·wm·nm
    multiply-adds to assemble the masks, four bilinear taps (multiply-adds)
    a pixel of the n predicted and g GT masks upsampled to s², and g·n·s²
    multiply-adds to intersect; two operations a multiply-add."""
    return 2.0 * (n * hm * wm * nm + 4 * (n + g) * s * s + g * n * s * s)


def mask_stage_bytes(n: int, g: int, hm: int, wm: int, nm: int, proto_bytes: int) -> float:
    """Bytes of one image's mask IoUs read once and written once: its
    prototypes, the n detections' coefficients (float32) and boxes, its
    (hm, wm) int32 GT map, and the (g, n) float32 IoU matrix."""
    return hm * wm * nm * proto_bytes + n * (nm + 4) * 4 + hm * wm * 4 + g * n * 4


def mask_stage_bound_s(pairs, s: int, hm: int, wm: int, nm: int, proto_bytes: int) -> float:
    """The least time of the mask stage over the images ``pairs`` [(n, g)]
    whose masks it assembles: the larger of their bytes at the HBM rate and
    their operations at the float32 rate."""
    ops = sum(mask_stage_ops(n, g, s, hm, wm, nm) for n, g in pairs)
    nbytes = sum(mask_stage_bytes(n, g, hm, wm, nm, proto_bytes) for n, g in pairs)
    return max(nbytes / flops.PEAK_BYTES, ops / flops.PEAK_F32)


def span_roofline_pct(result, span: str, bound_key: str):
    """The runner's least times ``layer[bound_key]`` (one a batch of the
    traced stretch) over the device time of the program's spans ``span``
    in that stretch, or None where either is missing."""
    from perfbench.core.program_spans import recorded

    bounds = (result.get("layer") or {}).get(bound_key)
    ms = [s.device_ms for s in recorded() if s.name == span]
    if not bounds or not ms or sum(ms) <= 0:
        return None
    return 100.0 * sum(bounds) / (sum(ms) / 1e3)
