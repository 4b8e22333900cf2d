"""Operations and bytes from shapes, and the card's peaks: the yardstick of
the per-layer shares. Nothing here reads what the program counts.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
"""

from __future__ import annotations

from perfbench.reference import yolo

PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_F32 = 67e12  # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3

# float32 operations charged per IoU a greedy walk needs, with its compare
# (the count of the kernel table in PERF.md)
IOU_OPS = 17


def conv_macs(cfg: dict, h: int, w: int, bn: bool = False) -> int:
    """Multiply-accumulates of every conv of ``cfg`` on one (3, h, w) image,
    the Detect convs' biases included; with ``bn`` also two per output
    element of each BatchNorm (the count the published GFLOPs use)."""
    layers, _, _ = yolo.parse(cfg)
    size = {-1: (h, w)}
    total = 0

    def conv(c, hw):
        nonlocal total
        ho = (hw[0] + 2 * c.p - c.k) // c.s + 1
        wo = (hw[1] + 2 * c.p - c.k) // c.s + 1
        total += c.c2 * ho * wo * (c.c1 * c.k * c.k + (1 if c.head else 0))
        if bn and not c.head:
            total += 2 * c.c2 * ho * wo
        return ho, wo

    for i, frm, kind, info in layers:
        hw_in = [size[i - 1] if x == -1 else size[x] for x in frm]
        hw = hw_in[0]
        if kind == "Conv":
            hw = conv(info["conv"], hw)
        elif kind == "C3":
            conv(info["cv1"], hw)
            for cv1, cv2 in info["m"]:
                conv(cv1, hw)
                conv(cv2, hw)
            conv(info["cv2"], hw)
            conv(info["cv3"], hw)
        elif kind == "SPPF":
            conv(info["cv1"], hw)
            conv(info["cv2"], hw)
        elif kind == "Upsample":
            hw = (hw[0] * info["scale"], hw[1] * info["scale"])
        elif kind == "Detect":
            for c, hwl in zip(info["m"], hw_in):
                conv(c, hwl)
        size[i] = hw
    return total


def model_flops(cfg: dict, h: int, w: int) -> float:
    """FLOPs of one forward of one (3, h, w) image: two per multiply-add of
    the convs, BN folded (as the cells run it)."""
    return 2.0 * conv_macs(cfg, h, w)


def stem_bound_s(batch: int, h: int, w: int, c2: int, elem_bytes: int) -> float:
    """The least time of the fused 6x6/s2 stem conv (+bias, SiLU) on a
    (batch, 3, h, w) input: the larger of its bytes (input read once,
    output written once) at the HBM rate and its operations (2·108 per
    output element) at the bf16 tensor-core rate."""
    outs = batch * c2 * (h // 2) * (w // 2)
    nbytes = (batch * 3 * h * w + outs) * elem_bytes
    return max(nbytes / PEAK_BYTES, 2.0 * 3 * 6 * 6 * outs / PEAK_BF16)


def nms_bound_s(candidates: int, slots: int, ious: int) -> float:
    """The least time of a greedy suppression of a batch: its candidates'
    boxes and scores (20 B each) read once and its keep mask (1 B a slot)
    written once, against IOU_OPS float32 operations per IoU the walk
    needs."""
    return max((20 * candidates + slots) / PEAK_BYTES, IOU_OPS * ious / PEAK_F32)
