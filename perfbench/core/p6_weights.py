"""Seeded weights of a P6 detection configuration (four Detect levels, a
stride-64 stage), calibrated on the cell's own images: the rules of
``weights.py``, with every BN scale at ``BN_GAIN`` of its draw, U(0.05, 0.15).

With ``weights.py``'s U(0.1, 0.3) the random yolov5x6 at 1280 px is near
chaotic: bfloat16's rounding moved its detections as far as float8's did
(``det_gap.mean`` 0.103-0.196 against the float8 control's 0.164-0.860,
``det_gap.det_mean`` 0.111-0.176 against 0.149-0.231; H100, three seeds),
and the detections gathered in 27% of the images. The smaller scales keep
each layer nearer the linear range of SiLU, where a rounding error is not
amplified layer after layer.
"""

from __future__ import annotations

import types

import torch

from perfbench.core import weights

BN_GAIN = 0.5


def draw(cfg: dict, gen: torch.Generator, device) -> dict:
    """``weights.py``'s draw with every BN scale times ``BN_GAIN``."""
    sd = weights._draw(cfg, gen, device)
    for k in sd:
        if k.endswith("bn.weight"):
            sd[k] *= BN_GAIN
    return sd


# ``weights.calibrated`` (its BN statistics and objectness shift) drawing
# through ``draw``: the same code over its own globals, so that nothing of
# ``weights`` is changed
calibrated = torch.no_grad()(types.FunctionType(
    weights.calibrated.__wrapped__.__code__, {**vars(weights), "_draw": draw},
    "calibrated", weights.calibrated.__wrapped__.__defaults__))
