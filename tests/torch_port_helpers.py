"""Shared inputs and comparisons for the tests that hold yolov5_tpu_torch
against the JAX package (tests/test_torch_*.py). Every input is drawn with
numpy from a seed and handed to both packages."""

import numpy as np
import torch


def random_state_dict(module: torch.nn.Module, rng: np.random.Generator) -> dict:
    """Numpy values for every entry of ``module.state_dict()``: conv weights
    U(±1/sqrt(fan_in)), biases U(±0.5), and non-trivial BN affine parameters
    and running statistics so that BN folding is exercised."""
    sd = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_mean"):
            a = rng.normal(0.0, 0.2, shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif ".bn." in f".{k}" and k.endswith("weight"):
            a = rng.uniform(0.5, 1.5, shape)
        elif ".bn." in f".{k}" and k.endswith("bias"):
            a = rng.normal(0.0, 0.1, shape)
        elif k.endswith("weight"):
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            a = rng.uniform(-bound, bound, shape)
        else:
            a = rng.uniform(-0.5, 0.5, shape)
        sd[k] = a.astype(np.float32)
    return sd


def load_numpy_state_dict(module: torch.nn.Module, sd: dict) -> None:
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)


def random_sorted_boxes(rng, k, span=200.0):
    """k xyxy boxes and descending scores in (0.01, 1), as tests/test_nms.py."""
    xy = rng.uniform(0, span, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1.0, k).astype(np.float32))[::-1].copy()
    return boxes, scores


def truncate_after(keep: np.ndarray, max_det: int) -> np.ndarray:
    """A keep mask with every entry after its max_det-th True cleared (the
    early exit of the port's greedy suppression)."""
    keep = np.array(keep, bool)
    for row in keep.reshape(-1, keep.shape[-1]):
        kept = np.flatnonzero(row)
        row[kept[max_det:]] = False
    return keep


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype != torch.bool else x.cpu().numpy()
    return np.asarray(x)


def assert_same_detections(a, b, atol=1e-4):
    """Two padded Detections agree on every valid entry (the semantics of
    tests/test_nms.py::_assert_same_detections)."""
    va, vb = to_numpy(a.valid), to_numpy(b.valid)
    assert (va == vb).all(), "valid masks differ"
    for field in ("boxes", "scores", "classes", "masks"):
        xa, xb = to_numpy(getattr(a, field)), to_numpy(getattr(b, field))
        assert xa.shape == xb.shape, field
        np.testing.assert_allclose(xa[va], xb[va], atol=atol, err_msg=field)


def assert_same_detection_sets(a, b, atol=1e-3):
    """Per image, the same valid count and a one-to-one match of detections
    (same class, box and score within atol). For two packages whose scores
    agree only to a few ulps: near-equal scores may swap places."""
    va, vb = to_numpy(a.valid), to_numpy(b.valid)
    assert (va == vb).all(), "valid masks differ"
    for i in range(va.shape[0]):
        rows = [np.concatenate([to_numpy(d.boxes)[i], to_numpy(d.scores)[i][:, None],
                                to_numpy(d.classes)[i][:, None]], 1)[v[i]]
                for d, v in ((a, va), (b, vb))]
        free = np.ones(len(rows[1]), bool)
        for r in rows[0]:
            hit = free & (rows[1][:, 5] == r[5]) & (np.abs(rows[1][:, :5] - r[:5]) <= atol).all(1)
            assert hit.any(), f"image {i}: no match for detection {r}"
            free[np.flatnonzero(hit)[0]] = False
