"""Polygon -> instance-mask rasterization on the device.

The port of ``yolov5_tpu/ops/rasterize.py``: the GT masks of device
augmentation are filled inside the train step from (M, V, 2) vertex tensors
instead of on the host. A pixel (ix, iy) is set when any of its four
half-pixel samples (ix ± 0.5, iy ± 0.5) is inside the polygon by the
even-odd (crossing-number) rule; that dilation stands in for the outline
that ``cv2.fillPoly`` paints.

The JAX package scans the V edges, XOR-ing each edge's crossings into an
(M, 2hm, 2wm) carry. The crossings of one edge on one sampled row are the
samples left of its intersection x: a prefix of the row, since the sample
columns are sorted. So here each edge gives one prefix length per row
(``torch.searchsorted``, the same float32 comparisons as the scan), the
prefixes are toggled into a difference array and one cumulative sum along
the row gives each sample's crossing count: the same pixels in three passes
over the grid instead of 3 V.

``densify_polygon`` and ``resample_polygon`` are the JAX package's host-side
(numpy) helpers.
"""

from __future__ import annotations

import numpy as np
import torch


def _edges(polys, n_valid):
    """Each edge's end vertex (the next one, wrapping at n_valid) and
    whether the edge is real: polys (N, V, 2), n_valid (N,) ->
    (x2, y2 (N, V), edge valid (N, V))."""
    v = polys.shape[-2]
    j = torch.arange(v, device=polys.device)
    nxt = torch.where(j == n_valid[:, None] - 1, 0, j + 1).clamp(max=v - 1)
    ev = j[None, :] < n_valid[:, None]
    return polys[..., 0].gather(1, nxt), polys[..., 1].gather(1, nxt), ev


def polygon_areas(polys, n_valid):
    """|Shoelace area| of each padded polygon (``cv2.contourArea`` on simple
    polygons). polys (..., V, 2) float, the first n_valid[...] vertices
    real; returns (...) float32.

    The JAX function gives NaN for 0 < n_valid < V (its wrap index runs past
    the last vertex); here every count gives the area."""
    lead, v = polys.shape[:-2], polys.shape[-2]
    p = polys.float().reshape(-1, v, 2)
    n = n_valid.reshape(-1)
    xn, yn, ev = _edges(p, n)
    x, y = p[..., 0], p[..., 1]
    cross = (x * yn - xn * y) * ev
    return (cross.sum(-1).abs() * 0.5).reshape(lead)


def rasterize(polys, n_valid, hm, wm):
    """Even-odd fill of padded polygons on an (hm, wm) grid.

    polys (..., V, 2) float [x, y] in mask pixels, n_valid (...) int vertex
    counts; returns (..., hm, wm) bool. Polygons with fewer than 3 vertices
    are empty."""
    lead, v = polys.shape[:-2], polys.shape[-2]
    dev = polys.device
    p = polys.float().reshape(-1, v, 2)
    n = n_valid.reshape(-1)
    x2, y2, ev = _edges(p, n)
    ev = ev & (n[:, None] >= 3)
    x1, y1 = p[..., 0], p[..., 1]
    off = torch.tensor([-0.5, 0.5], device=dev)
    px = (torch.arange(wm, dtype=torch.float32, device=dev)[:, None] + off).reshape(-1)
    py = (torch.arange(hm, dtype=torch.float32, device=dev)[:, None] + off).reshape(-1)

    # per edge and sampled row (N, V, 2hm): does the edge cross the row, where
    straddle = (y1[..., None] > py) != (y2[..., None] > py)
    dy = y2 - y1
    t = (py - y1[..., None]) / torch.where(dy == 0, 1.0, dy)[..., None]
    # x1 + t·(x2 - x1) rounded once, as the JAX function's fused multiply-add
    # (XLA contracts it): the product is exact in float64
    xint = (x1[..., None].double() + t.double() * (x2 - x1)[..., None].double()).float()
    hit = (straddle & ev[..., None]).transpose(1, 2)  # (N, 2hm, V)
    # samples crossed: px[k] < xint for k below this count (px is sorted)
    c = torch.searchsorted(px, xint.transpose(1, 2).contiguous())
    # toggle [0, c) per hit edge; counts are kept mod 256, which keeps parity
    d = torch.zeros(hit.shape[:2] + (2 * wm + 1,), dtype=torch.uint8, device=dev)
    d.scatter_add_(2, c, hit.to(torch.uint8))
    d[..., 0] += hit.sum(-1, dtype=torch.uint8)
    inside = (d.cumsum(-1, dtype=torch.uint8)[..., :2 * wm] & 1).bool()
    # a pixel is on when any of its four samples is inside
    out = inside.reshape(-1, hm, 2, wm, 2).any(4).any(2)
    return out.reshape(lead + (hm, wm))


def rasterize_overlap(polys, n_valid, hm, wm):
    """One index-encoded mask per image: polys (..., M, V, 2), n_valid
    (..., M) -> (..., hm, wm) int32, instance i written as i + 1 in
    descending-area order (the smallest on top), 0 background: the host
    loader's ``rasterize_masks(overlap=True)``. Where instances overlap the
    one with the smallest area wins, ties to the higher index of the stable
    descending sort (``jnp.argsort``'s order), by one max over ranks."""
    masks = rasterize(polys, n_valid, hm, wm)  # (..., M, hm, wm)
    areas = polygon_areas(polys, n_valid)
    m = areas.shape[-1]
    order = torch.sort(-areas, dim=-1, stable=True).indices
    ranks = torch.arange(1, m + 1, dtype=torch.int32, device=areas.device).expand_as(order)
    rank = torch.zeros_like(order, dtype=torch.int32).scatter(-1, order, ranks.contiguous())
    score = masks * rank[..., None, None]
    best, top = score.max(dim=-3)
    return torch.where(best > 0, top.to(torch.int32) + 1, 0)


def densify_polygon(points, n_out):
    """Grow a polygon (numpy (n, 2)) to exactly n_out vertices by inserting
    points along its edges (apportioned by edge length), keeping every
    original vertex; arc resampling when it already has n_out or more."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    if n == 0:
        return np.zeros((n_out, 2), np.float32)
    if n >= n_out:
        return resample_polygon(pts, n_out)
    closed = np.concatenate([pts, pts[:1]], 0)
    seglen = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    extra = n_out - n
    if seglen.sum() == 0:
        return np.concatenate([pts, np.repeat(pts[-1:], extra, 0)])
    quota = seglen / seglen.sum() * extra
    cnt = np.floor(quota).astype(int)
    rem = extra - cnt.sum()
    order = np.argsort(-(quota - cnt))
    cnt[order[:rem]] += 1
    out = []
    for i in range(n):
        out.append(pts[i])
        k = int(cnt[i])
        if k:
            t = (np.arange(1, k + 1, dtype=np.float32) / (k + 1))[:, None]
            out.extend(closed[i] * (1 - t) + closed[i + 1] * t)
    return np.asarray(out, np.float32)


def resample_polygon(points, n_out):
    """Resample a closed polygon (numpy (n, 2)) to n_out vertices evenly
    along its perimeter (the reference's resample_segments)."""
    pts = np.asarray(points, np.float32)
    if len(pts) == 0:
        return np.zeros((n_out, 2), np.float32)
    closed = np.concatenate([pts, pts[:1]], 0)
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    if total == 0:
        return np.repeat(pts[:1], n_out, 0)
    want = np.linspace(0, total, n_out, endpoint=False)
    xi = np.interp(want, cum, closed[:, 0])
    yi = np.interp(want, cum, closed[:, 1])
    return np.stack([xi, yi], 1).astype(np.float32)
