"""Plotting: training curves, label stats, PR/F1 curves, batch mosaics,
confusion matrix (reference utils/plots.py:30-304, utils/metrics.py plots).

A copy of ``yolov5_tpu/utils/plots.py``, which imports no JAX; its images
are tested pixel for pixel against the JAX module's
(``tests/test_torch_plots.py``). matplotlib (and OpenCV, for
``plot_images``) is imported inside the functions, so importing this module
loads neither. All plotting is soft-fail (the reference wraps these in
TryExcept): a broken plot, or a machine without matplotlib, never kills a
training run.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np


def soft_fail(fn):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        try:
            return fn(*a, **k)
        except Exception as e:  # pragma: no cover
            print(f"plot {fn.__name__} failed: {e}")

    return wrapper


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


@soft_fail
def plot_results(csv_path, out=None):
    """results.csv -> results.png grid of train/val curves."""
    import csv as csvmod

    plt = _plt()
    csv_path = Path(csv_path)
    with open(csv_path) as f:
        rows = list(csvmod.DictReader(f))
    if not rows:
        return
    keys = [k for k in rows[0] if k != "step" and rows[0][k] not in ("", None)]
    xs = [float(r["step"]) for r in rows]
    n = len(keys)
    cols = min(5, n)
    r_ = (n + cols - 1) // cols
    fig, axes = plt.subplots(r_, cols, figsize=(4 * cols, 3 * r_), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ys = [float(r[k]) if r[k] else np.nan for r in rows]
        ax.plot(xs, ys, marker=".", linewidth=1, markersize=3)
        ax.set_title(k, fontsize=9)
    for j in range(n, r_ * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    fig.savefig(out or csv_path.with_name("results.png"), dpi=120)
    plt.close(fig)


@soft_fail
def plot_study(txt_files, out="study.png"):
    """study_*.txt rows (imgsz, P, R, mAP50, mAP50-95, fwd_ms, nms_ms,
    host_ms) -> speed-accuracy curve (reference utils/plots.py
    plot_val_study: mAP50-95 vs device latency, one line per weights,
    annotated with the image size at each point)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(8, 5))
    for f in txt_files:
        y = np.loadtxt(f, ndmin=2)
        lat = y[:, 5] + y[:, 6]  # forward + NMS ms/img
        ax.plot(lat, y[:, 4], marker=".", linewidth=2, markersize=8,
                label=Path(f).stem.replace("study_", ""))
        for xi, yi, s in zip(lat, y[:, 4], y[:, 0]):
            ax.annotate(f"{int(s)}", (xi, yi), fontsize=7,
                        textcoords="offset points", xytext=(4, 4))
    ax.set_xlabel("latency ms/img (forward + NMS)")
    ax.set_ylabel("mAP50-95")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)


@soft_fail
def plot_evolve(evolve_csv):
    """evolve.csv -> evolve.png: per-hyperparameter scatter of value vs
    fitness with the best generation marked (reference utils/plots.py:247
    plot_evolve; adapted to this repo's fitness-first csv schema)."""
    import csv as csvmod

    plt = _plt()
    evolve_csv = Path(evolve_csv)
    with open(evolve_csv) as f:
        rows = list(csvmod.DictReader(f))
    if not rows:
        return
    fit = np.array([float(r["fitness"]) for r in rows])
    j = int(np.argmax(fit))
    keys = [k for k in rows[0] if k != "fitness" and rows[0][k] not in ("", None)]
    n = len(keys)
    cols = 5
    r_ = (n + cols - 1) // cols
    fig, axes = plt.subplots(r_, cols, figsize=(2.4 * cols, 2.2 * r_),
                             squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        v = np.array([float(r[k]) if r[k] else np.nan for r in rows])
        ax.scatter(v, fit, c=fit, cmap="viridis", alpha=0.8, edgecolors="none",
                   s=14)
        ax.plot(v[j], fit[j], "k+", markersize=12)
        ax.set_title(f"{k} = {v[j]:.3g}", fontsize=8)
        if i % cols:
            ax.set_yticks([])
        ax.tick_params(labelsize=6)
    for m in range(n, r_ * cols):
        axes[m // cols][m % cols].axis("off")
    fig.tight_layout()
    out = evolve_csv.with_suffix(".png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


@soft_fail
def plot_labels(labels_list, names, save_dir="."):
    """Class histogram + box wh/xy scatter (reference plots.py:55-112)."""
    plt = _plt()
    all_labels = np.concatenate([l for l in labels_list if len(l)], 0)
    cls, boxes = all_labels[:, 0], all_labels[:, 1:5]
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    nc = int(cls.max()) + 1 if len(cls) else 1
    axes[0].hist(cls, bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    axes[0].set_xlabel("class")
    axes[1].scatter(boxes[:, 0], boxes[:, 1], s=2, alpha=0.3)
    axes[1].set_xlabel("x center"); axes[1].set_ylabel("y center")
    axes[2].scatter(boxes[:, 2], boxes[:, 3], s=2, alpha=0.3)
    axes[2].set_xlabel("width"); axes[2].set_ylabel("height")
    fig.tight_layout()
    fig.savefig(Path(save_dir) / "labels.png", dpi=120)
    plt.close(fig)


@soft_fail
def plot_pr_curve(px, py, ap, names=(), save_path="pr_curve.png"):
    """Per-class PR curves + mean (reference: ultralytics plot_pr_curve)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    py = np.asarray(py)
    if py.ndim == 1:
        py = py[None]
    for i, y in enumerate(py):
        label = f"{names[i] if i < len(names) else i} {ap[i]:.3f}" if len(ap) > i else None
        ax.plot(px, y, linewidth=1, label=label)
    ax.plot(px, py.mean(0), linewidth=2.5, color="black",
            label=f"all classes {np.mean(ap):.3f} mAP@0.5")
    ax.set_xlabel("Recall"); ax.set_ylabel("Precision")
    ax.set_xlim(0, 1); ax.set_ylim(0, 1)
    ax.legend(fontsize=7)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


@soft_fail
def plot_mc_curve(px, py, save_path="mc_curve.png", xlabel="Confidence",
                  ylabel="Metric", names=()):
    """Metric-vs-confidence curves (F1/P/R, reference plot_mc_curve)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    py = np.asarray(py)
    if py.ndim == 1:
        py = py[None]
    for i, y in enumerate(py):
        ax.plot(px, y, linewidth=1,
                label=str(names[i]) if i < len(names) else None)
    m = py.mean(0)
    ax.plot(px, m, linewidth=2.5, color="black",
            label=f"all classes {m.max():.2f} at {px[m.argmax()]:.3f}")
    ax.set_xlabel(xlabel); ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1); ax.set_ylim(0, 1)
    ax.legend(fontsize=7)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


@soft_fail
def plot_confusion_matrix(matrix, names=(), save_path="confusion_matrix.png",
                          normalize=True):
    plt = _plt()
    m = matrix.copy().astype(np.float64)
    if normalize:
        m /= (m.sum(0, keepdims=True) + 1e-9)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(m, cmap="Blues")
    ticks = list(names) + ["background"]
    ax.set_xticks(range(len(ticks)), ticks, rotation=90, fontsize=7)
    ax.set_yticks(range(len(ticks)), ticks, fontsize=7)
    ax.set_xlabel("True"); ax.set_ylabel("Predicted")
    for i in range(m.shape[0]):
        for j in range(m.shape[1]):
            if m[i, j] > 0.005:
                ax.text(j, i, f"{m[i, j]:.2f}", ha="center", va="center", fontsize=6)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


@soft_fail
def plot_images(images, targets=None, valid=None, save_path="batch.png",
                max_images=16, names=None):
    """Tile a training batch with its boxes (reference plot_images,
    plots.py:115-190). images (bs, h, w, 3) uint8 RGB; targets normalized."""
    import cv2

    bs = min(len(images), max_images)
    cols = int(np.ceil(np.sqrt(bs)))
    rows = int(np.ceil(bs / cols))
    h, w = images.shape[1:3]
    canvas = np.full((rows * h, cols * w, 3), 255, np.uint8)
    for i in range(bs):
        r, c = divmod(i, cols)
        im = images[i][..., ::-1].copy()  # RGB->BGR for cv2 text
        if targets is not None:
            t = targets[i][valid[i]] if valid is not None else targets[i]
            for cls, x, y, bw, bh in t:
                x1, y1 = int((x - bw / 2) * w), int((y - bh / 2) * h)
                x2, y2 = int((x + bw / 2) * w), int((y + bh / 2) * h)
                cv2.rectangle(im, (x1, y1), (x2, y2), (0, 255, 80), 1)
                label = str(names.get(int(cls), int(cls))) if names else str(int(cls))
                cv2.putText(im, label, (x1, max(y1 - 2, 8)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.35, (0, 255, 80), 1)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    cv2.imwrite(str(save_path), canvas)
