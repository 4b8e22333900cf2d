"""Hyperparameter evolution: a genetic search over the hyp space.

The port of ``yolov5_tpu/train/evolve.py`` (the reference's --evolve,
train.py:674-903): each generation mutates a parent drawn from the five
best results so far (weighted by fitness), trains a short run, and appends
(fitness, hyps) to ``evolve.csv``; an existing ``evolve.csv`` resumes the
search. Draws come from ``np.random.default_rng(seed)`` in the JAX module's
order, so equal seeds mutate equal hyps. ``evolve.png`` (``utils.plots``)
scatters each hyp against fitness after the search.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import yaml

from yolov5_tpu_torch.utils.hyp import load_hyp

# (mutation scale, lower, upper) per hyp: reference train.py:683-713
META = {
    "lr0": (1, 1e-5, 1e-1), "lrf": (1, 0.01, 1.0), "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001), "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95), "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2), "cls": (1, 0.2, 4.0), "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0), "obj_pw": (1, 0.5, 2.0), "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0), "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1), "hsv_s": (1, 0.0, 0.9), "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0), "translate": (1, 0.0, 0.9), "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0), "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0), "fliplr": (0, 0.0, 1.0), "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0), "copy_paste": (1, 0.0, 1.0),
}


def mutate(parent: dict, rng, mp=0.8, sigma=0.2) -> dict:
    """Mutate hyps within their bounds; keys with mutation scale 0 stay."""
    child = dict(parent)
    keys = [k for k in META if META[k][0] > 0]
    g = np.array([META[k][0] for k in keys])
    while True:
        active = rng.random(len(keys)) < mp
        factors = (g * active * rng.standard_normal(len(keys)) * rng.random() * sigma
                   + 1).clip(0.3, 3.0)
        if (factors != 1).any():
            break
    for k, f in zip(keys, factors):
        lo, hi = META[k][1], META[k][2]
        child[k] = float(np.clip(parent.get(k, lo) * f, lo, hi))
    return child


def select_parent(history, rng, n=5):
    """A fitness-weighted pick among the n best generations so far."""
    if not history:
        return None
    top = sorted(history, key=lambda r: -r[0])[:n]
    w = np.array([max(r[0], 1e-9) for r in top])
    return top[rng.choice(len(top), p=w / w.sum())][1]


def run_evolve(data, cfg="yolov5n", hyp=None, generations=30, epochs=10, batch_size=16,
               imgsz=320, save_dir="runs/evolve/exp", seed=0, train_kwargs=None):
    """The search; each generation is ``train.run.run`` with ``nosave``.
    Returns (best hyp, best fitness)."""
    from yolov5_tpu_torch.train.run import run as train_run

    rng = np.random.default_rng(seed)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    csv_path = save_dir / "evolve.csv"
    base = load_hyp(hyp)
    history = []  # (fitness, hyp)
    if csv_path.exists():  # resume the search
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                fit = float(row.pop("fitness"))
                history.append((fit, {k: float(v) for k, v in row.items() if k in META}))

    for gen in range(len(history), generations):
        parent = select_parent(history, rng) or base
        child = mutate({**base, **parent}, rng) if history else dict(base)
        fitness, _, _ = train_run(data=data, cfg=cfg, hyp=child, epochs=epochs,
                                  batch_size=batch_size, imgsz=imgsz,
                                  save_dir=save_dir / f"gen{gen}", nosave=True,
                                  **(train_kwargs or {}))
        history.append((fitness, child))
        write_header = not csv_path.exists()
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["fitness"] + list(META))
            if write_header:
                w.writeheader()
            w.writerow({"fitness": fitness, **{k: child.get(k, "") for k in META}})
        print(f"evolve gen {gen}: fitness {fitness:.4f} "
              f"(best {max(h[0] for h in history):.4f})")

    best_fit, best_hyp = max(history, key=lambda r: r[0])
    (save_dir / "hyp_evolve.yaml").write_text(yaml.safe_dump(best_hyp))
    from yolov5_tpu_torch.utils.plots import plot_evolve

    plot_evolve(csv_path)  # evolve.png scatter panel (reference plots.py:247)
    return best_hyp, best_fit
