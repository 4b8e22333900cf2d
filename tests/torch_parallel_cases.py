"""The cases of tests/test_torch_parallel.py: small training steps of the
port, each run by two gloo ranks on the CPU (this module's ``__main__``)
and by one process at the global batch (the test itself), on the same
inputs drawn with numpy from fixed seeds.

A case reads the rank and the world from ``yolov5_tpu_torch.parallel`` and
returns a dict of numpy arrays: rank r feeds rows r, r + world, ... of each
global batch (or, with the device cache, the global index batch), as the
port's loaders shard an epoch.

    python -m tests.torch_parallel_cases bn,detect_host out.npz   # under RANK/WORLD_SIZE
"""

import sys

import numpy as np
import torch

from tests.torch_port_helpers import load_numpy_state_dict, random_state_dict, small_cfg
from yolov5_tpu_torch.parallel.distributed import init_distributed, world
from yolov5_tpu_torch.parallel.mesh import rank_rows

IMGSZ = 64
BATCH = 4  # the global batch
STEPS = 4
JAX_STEPS = 10  # the host detection case, held against the JAX package's mesh
SEED = 0


def det_cfg():
    return small_cfg("yolov5n")


def seg_cfg():
    return small_cfg("yolov5n-seg")


def hyp():
    from yolov5_tpu_torch.train.trainer import scale_hyp
    from yolov5_tpu_torch.utils.hyp import SCRATCH_LOW

    return scale_hyp(SCRATCH_LOW, nl=3, nc=3, imgsz=IMGSZ)


def labels(rng, n_images, m=6):
    """(targets (n, m, 5), valid (n, m)): 1-5 boxes an image."""
    t = np.zeros((n_images, m, 5), np.float32)
    v = np.zeros((n_images, m), bool)
    for b in range(n_images):
        n = int(rng.integers(1, m))
        t[b, :n, 0] = rng.integers(0, 3, n)
        t[b, :n, 1:3] = rng.uniform(0.25, 0.75, (n, 2))
        t[b, :n, 3:5] = rng.uniform(0.1, 0.45, (n, 2))
        v[b, :n] = True
    return t, v


def global_batch(i, masks=False):
    """Step i's global batch: uint8 images, labels, raw content sizes and,
    for segmentation, overlap index masks of each box."""
    rng = np.random.default_rng(1000 + i)
    t, v = labels(rng, BATCH)
    out = {"images": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8),
           "hw": np.full((BATCH, 2), IMGSZ, np.int32), "targets": t, "valid": v}
    if masks:
        out["masks"] = box_masks(t, v, IMGSZ // 4)
    return out


def box_masks(t, v, s):
    """Overlap index maps (label row j filled as j + 1) of the boxes."""
    m = np.zeros((len(t), s, s), np.int32)
    for b in range(len(t)):
        for j in np.flatnonzero(v[b]):
            _, x, y, w, h = t[b, j]
            x0, x1 = int((x - w / 2) * s), int(np.ceil((x + w / 2) * s))
            y0, y1 = int((y - h / 2) * s), int(np.ceil((y + h / 2) * s))
            m[b, max(y0, 0):y1, max(x0, 0):x1] = j + 1
    return m


def device_cache(n=8, segments=False):
    """A device cache of n images, with rectangle polygons for segmentation."""
    rng = np.random.default_rng(77)
    t, v = labels(rng, n)
    out = {"images": rng.integers(0, 256, (n, IMGSZ, IMGSZ, 3), dtype=np.uint8),
           "hw": np.full((n, 2), IMGSZ, np.int32), "targets": t, "valid": v}
    if segments:
        x, y, w, h = (t[..., k] for k in range(1, 5))
        corners = [(x - w / 2, y - h / 2), (x + w / 2, y - h / 2), (x + w / 2, y + h / 2),
                   (x - w / 2, y + h / 2)]
        out["segments"] = np.stack([np.stack(c, -1) for c in corners], 2).astype(np.float16)
    return {k: torch.from_numpy(a) for k, a in out.items()}


def index_batch(i, n=8):
    return torch.from_numpy(np.random.default_rng(2000 + i).permutation(n)[:BATCH])


def _local(batch):
    """This rank's rows of a global batch (all of it in one process)."""
    return {k: rank_rows(torch.from_numpy(a)) for k, a in batch.items()}


def _state(model, opt_batch=BATCH):
    from yolov5_tpu_torch.train.optim import Optimizer
    from yolov5_tpu_torch.train.trainer import init_train_state

    opt = Optimizer(dict(model.named_parameters()), hyp(), epochs=3, steps_per_epoch=5,
                    batch_size=opt_batch, nbs=opt_batch)
    return init_train_state(model, opt)


def _snapshot(state, prefix):
    out = {f"{prefix}model/{k}": v.detach().numpy().copy()
           for k, v in state.model.state_dict().items() if not k.endswith("num_batches_tracked")}
    out.update({f"{prefix}ema/{k}": v.numpy().copy()
                for k, v in {**state.ema.params, **state.ema.batch_stats}.items()})
    return out


def detector_weights():
    """The detection case's weights (random_state_dict of seed SEED)."""
    from yolov5_tpu_torch.models.yolo import DetectionModel

    return random_state_dict(DetectionModel(det_cfg()), np.random.default_rng(SEED))


def case_bn():
    """batch_norm_train on (8, 4, 5, 5) float32: its output, the gradients
    of x, weight and bias under a random cotangent, and the running
    statistics (from a nonzero running mean)."""
    from yolov5_tpu_torch.models.layers import batch_norm, batch_norm_train

    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(0, 3, (8, 4, 5, 5)) + 1).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (8, 4, 5, 5)).astype(np.float32))
    bn = batch_norm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 4).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 1, 4).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(1, 0.5, 4).astype(np.float32)))
    x = rank_rows(x).clone().requires_grad_(True)
    y = batch_norm_train(x, bn)
    gx, gw, gb = torch.autograd.grad((y * rank_rows(g)).sum(), (x, bn.weight, bn.bias))
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "gw": gw.numpy(), "gb": gb.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


def _detect(mode, steps):
    from yolov5_tpu_torch.models.yolo import DetectionModel
    from yolov5_tpu_torch.train.loss import ComputeLoss
    from yolov5_tpu_torch.train.trainer import make_train_step

    model = DetectionModel(det_cfg())
    load_numpy_state_dict(model, detector_weights())
    model = model.to(memory_format=torch.channels_last)
    state = _state(model)
    aug = hyp() if mode in ("cache", "raw") else None
    step = make_train_step(ComputeLoss(model.anchors_per_stride, 3, hyp()), device_aug_hyp=aug,
                           dtype=torch.float32, seed=SEED)
    cache = device_cache() if mode == "cache" else None
    keys = ("images", "hw", "targets", "valid") if mode == "raw" else ("images", "targets",
                                                                         "valid")
    out, totals = {}, []
    for i in range(steps):
        if cache is not None:
            batch = {"idx": index_batch(i)}
        else:
            batch = _local({k: v for k, v in global_batch(i).items() if k in keys})
        state, m = step(state, batch, cache)
        totals.append([m[k].item() for k in ("total", "box", "obj", "cls")])
        if i + 1 == STEPS:
            out.update(_snapshot(state, f"step{STEPS}/"))
    out["losses"] = np.array(totals)
    return out


def case_detect_host():
    return _detect("host", JAX_STEPS)


def case_detect_cache():
    return _detect("cache", STEPS)


def case_detect_raw():
    return _detect("raw", STEPS)


def _segment(mode):
    from yolov5_tpu_torch.models.yolo import SegmentationModel
    from yolov5_tpu_torch.train.loss import ComputeSegmentLoss
    from yolov5_tpu_torch.train.trainer import make_train_step

    model = SegmentationModel(seg_cfg())
    load_numpy_state_dict(model, random_state_dict(model, np.random.default_rng(SEED + 1)))
    model = model.to(memory_format=torch.channels_last)
    state = _state(model)
    cache = device_cache(segments=True) if mode == "cache" else None
    step = make_train_step(ComputeSegmentLoss(model.anchors_per_stride, 3, hyp(), nm=model.nm),
                           device_aug_hyp=hyp() if cache is not None else None,
                           dtype=torch.float32, seed=SEED, has_masks=True,
                           mask_shape=(IMGSZ // 4,) * 2)
    losses = []
    for i in range(STEPS):
        if cache is not None:
            batch = {"idx": index_batch(i)}
        else:
            batch = _local({k: v for k, v in global_batch(i, masks=True).items() if k != "hw"})
        state, m = step(state, batch, cache)
        losses.append([m[k].item() for k in ("total", "box", "obj", "cls", "seg")])
    return {"losses": np.array(losses), **_snapshot(state, f"step{STEPS}/")}


def case_segment_host():
    return _segment("host")


def case_segment_cache():
    return _segment("cache")


def _classify(mode):
    from yolov5_tpu_torch.models.yolo import ClassificationModel
    from yolov5_tpu_torch.train.run_classify import make_classify_step

    model = ClassificationModel(det_cfg(), nc=3)
    load_numpy_state_dict(model, random_state_dict(model, np.random.default_rng(SEED + 2)))
    model = model.to(memory_format=torch.channels_last)
    state = _state(model, opt_batch=64)  # run_classify builds it at 64
    n = 8
    rng = np.random.default_rng(99)
    images = torch.from_numpy(rng.integers(0, 256, (n, IMGSZ, IMGSZ, 3), dtype=np.uint8))
    labels_ = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    cache = {"images": images, "labels": labels_} if mode == "cache" else None
    step = make_classify_step(0.1, torch.float32, SEED, device_aug=cache is not None)
    losses = []
    for i in range(STEPS):
        idx = index_batch(i)
        batch = ({"idx": idx} if cache is not None
                 else {"images": rank_rows(images[idx]), "labels": rank_rows(labels_[idx])})
        state, m = step(state, batch, cache)
        losses.append([m["loss"].item(), m["acc"].item()])
    return {"losses": np.array(losses), **_snapshot(state, f"step{STEPS}/")}


def case_classify_host():
    return _classify("host")


def case_classify_cache():
    return _classify("cache")


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def main(names, out):
    torch.set_num_threads(1)
    init_distributed("cpu")
    assert world() > 1, "run under RANK / WORLD_SIZE / MASTER_PORT"
    results = {}
    for name in names.split(","):
        results.update({f"{name}:{k}": v for k, v in CASES[name]().items()})
    np.savez(out, **results)


if __name__ == "__main__":
    main(*sys.argv[1:3])
