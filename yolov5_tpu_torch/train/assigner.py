"""Anchor-target assignment in a padded, masked form with static shapes.

The port of ``yolov5_tpu/train/assigner.py``: every (target, anchor, offset)
combination is an entry of a fixed (bs, M, na, 5) lattice, and entries that
are not assignments carry a zero mask. Nothing depends on how many targets
match, so on CUDA the loss needs no ``nonzero`` and no host sync.

Semantics (the reference's ``build_targets``, utils/loss.py:185-247):
- anchor match: max(wh/anchor, anchor/wh) per dim, max over dims < anchor_t;
- a target also lands in the horizontally or vertically adjacent cell when
  its fractional position is within g=0.5 of that cell edge and it is not on
  the image border: offsets (0,0), (±1,0), (0,±1);
- gij = clip(floor(gxy - off), 0, n-1); tbox = (gxy - gij, gwh).
"""

from __future__ import annotations

import torch

# the 5 candidate cell offsets, scaled by g=0.5 (center, left, top, right, bottom)
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def build_targets_level(targets, valid, anchors, ny, nx, anchor_t=4.0):
    """Assign targets to one pyramid level.

    targets (bs, M, 5) [cls, x, y, w, h], xywh normalized; valid (bs, M)
    bool; anchors (na, 2) in stride units. Returns a dict of (bs, M, na, 5)
    tensors: mask (bool), gi, gj, a, tcls (int64), and tbox (bs, M, na, 5, 4)
    [dx, dy, w, h] with dx, dy in (-0.5, 1.5) and w, h in stride units."""
    bs, m, _ = targets.shape
    na = anchors.shape[0]
    dt, dev = targets.dtype, targets.device
    grid = torch.tensor([nx, ny], dtype=dt, device=dev)

    cls_id = targets[..., 0].long()  # (bs, M)
    gxy = targets[..., 1:3] * grid  # grid-space xy
    gwh = targets[..., 3:5] * grid  # grid-space wh

    # anchor ratio gate -> (bs, M, na)
    r = gwh[:, :, None, :] / anchors[None, None, :, :]
    ratio = torch.maximum(r, 1.0 / r.clamp(min=1e-9)).amax(-1)
    anchor_ok = ratio < anchor_t

    # offset gates -> (bs, M, 5)
    gxf = torch.remainder(gxy, 1.0)
    gxi = grid - gxy
    gxif = torch.remainder(gxi, 1.0)
    left = (gxf[..., 0] < 0.5) & (gxy[..., 0] > 1.0)
    top = (gxf[..., 1] < 0.5) & (gxy[..., 1] > 1.0)
    right = (gxif[..., 0] < 0.5) & (gxi[..., 0] > 1.0)
    bottom = (gxif[..., 1] < 0.5) & (gxi[..., 1] > 1.0)
    off_ok = torch.stack([torch.ones_like(left), left, top, right, bottom], -1)

    # degenerate padded rows (w or h == 0) never match
    nonzero = (gwh > 0).all(-1)
    mask = ((valid & nonzero)[:, :, None, None] & anchor_ok[:, :, :, None]
            & off_ok[:, :, None, :])  # (bs, M, na, 5)

    # cell indices per offset
    offsets = torch.tensor(_OFFSETS, dtype=dt, device=dev)
    gij = torch.floor(gxy[:, :, None, :] - offsets)  # (bs, M, 5, 2)
    gi = gij[..., 0].clamp(0, nx - 1).long()
    gj = gij[..., 1].clamp(0, ny - 1).long()
    txy = gxy[:, :, None, :] - torch.stack([gi, gj], -1).to(dt)  # (bs, M, 5, 2)

    shape = (bs, m, na, 5)
    return {
        "mask": mask,
        "gi": gi[:, :, None, :].expand(shape),
        "gj": gj[:, :, None, :].expand(shape),
        "a": torch.arange(na, device=dev)[None, None, :, None].expand(shape),
        "tbox": torch.cat([txy[:, :, None].expand(bs, m, na, 5, 2),
                           gwh[:, :, None, None, :].expand(bs, m, na, 5, 2)], -1),
        "tcls": cls_id[:, :, None, None].expand(shape),
    }
