"""AutoAnchor: anchor-fit check + kmeans/genetic anchor evolution.

A copy of ``yolov5_tpu/utils/autoanchor.py`` (the reference's
utils/autoanchor.py:16-162), tested equal to it. Host numpy/scipy: this runs
once before training. The metric is the reference's: for each
label wh, r = wh/anchor per dim; x = min(r, 1/r).min over dims; a label is
"matched" when best x > 1/anchor_t. BPR (best possible recall) must exceed
0.98 or anchors are re-evolved.
"""

from __future__ import annotations

import numpy as np


def _metric(wh, anchors):
    """wh (n, 2), anchors (na, 2) -> (x (n, na) symmetric size ratio, best (n,))."""
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1 / r).min(2)
    return x, x.max(1)


def anchor_fitness(anchors, wh, thr):
    _, best = _metric(wh, anchors)
    return (best * (best > thr)).mean()


def dataset_wh(dataset, imgsz=640):
    """Collect label wh in pixels at train scale, with the reference's
    0.9-1.1 random size jitter (autoanchor.py:47)."""
    whs = []
    rng = np.random.default_rng(0)
    for labels in dataset.labels:
        if len(labels):
            s = imgsz * rng.uniform(0.9, 1.1)
            whs.append(labels[:, 3:5] * s)
    return np.concatenate(whs, 0) if whs else np.zeros((0, 2))


def check_anchors(dataset, model, thr=4.0, imgsz=640, verbose=True):
    """BPR check; re-evolve anchors if below 0.98 (reference autoanchor.py:26-74).
    Returns (possibly updated) anchors in pixel units as nested tuples."""
    anchors = np.array(model.anchors, np.float32).reshape(-1, 2)
    wh = dataset_wh(dataset, imgsz)
    if not len(wh):
        return model.anchors
    thr_inv = 1.0 / thr
    x, best = _metric(wh, anchors)
    aat = (x > thr_inv).sum(1).mean()  # anchors above threshold per label
    bpr = (best > thr_inv).mean()
    if verbose:
        print(f"autoanchor: {aat:.2f} anchors/target, {bpr:.3f} BPR")
    if bpr > 0.98:
        return model.anchors
    print("autoanchor: BPR < 0.98, evolving new anchors...")
    na = anchors.shape[0]
    new = kmean_anchors(wh, n=na, thr=thr, gen=1000, verbose=False)
    if anchor_fitness(new, wh, thr_inv) > anchor_fitness(anchors, wh, thr_inv):
        nl = len(model.anchors)
        new = new[np.argsort(new.prod(1))].reshape(nl, -1, 2)
        return tuple(tuple(map(tuple, lvl)) for lvl in new)
    print("autoanchor: original anchors kept (evolved fit no better)")
    return model.anchors


def kmean_anchors(wh, n=9, thr=4.0, gen=1000, verbose=True, seed=0):
    """kmeans + genetic mutation anchor search (reference autoanchor.py:77-162).
    wh in pixels. Returns (n, 2) anchors sorted by area."""
    from scipy.cluster.vq import kmeans

    thr_inv = 1.0 / thr
    rng = np.random.default_rng(seed)
    wh = wh[(wh >= 2.0).any(1)]  # drop tiny degenerate labels
    s = wh.std(0)
    try:
        k, _ = kmeans(wh / s, n, iter=30, seed=seed)
        assert k.shape == (n, 2)
        k *= s
    except Exception:
        # kmeans can fail on degenerate data: fall back to size quantiles
        q = np.linspace(0.05, 0.95, n)
        k = np.quantile(wh, q, axis=0)

    f = anchor_fitness(k, wh, thr_inv)
    shape = k.shape
    mp, sigma = 0.9, 0.1  # mutation prob, scale
    for _ in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = ((rng.random(shape) < mp) * rng.random() *
                 rng.standard_normal(shape) * sigma + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = anchor_fitness(kg, wh, thr_inv)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        print(f"autoanchor: evolved n={n} fitness={f:.4f}")
    return k
