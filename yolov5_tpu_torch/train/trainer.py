"""The train step and the training state.

The port of ``yolov5_tpu/train/trainer.py``: one step does what the
reference's hot loop does (train.py:376-421): device augmentation keyed by
the step, uint8 -> [0, 1] on the device, the forward under bf16 autocast
with float32 master weights, the loss in float32, backward, the optimizer,
and an EMA tick on real updates only. Metrics stay tensors on the device,
so a step never waits for the host; ``run`` sums them per epoch.

When several processes train (``parallel``), a step is one rank's share of
the global batch: batch norm and the loss take their statistics and
normalisers over the global batch, and the gradients are summed over the
ranks in one all-reduce before the optimizer, so every rank takes the same
update. Device augmentation draws for the global batch: each rank augments
the whole global batch (gathered from the device cache by the global index
batch, or from the ranks' raw batches) with the shared generator, and keeps
its own rows, so a world-N run augments as one process at the global batch
does, mosaic partners included.

The JAX package's ``AutoLayoutStep`` (an input-layout work-around for the
TPU) and ``make_epoch_step`` (a ``lax.scan`` over the epoch, to save TPU
dispatches) have no counterpart: ``run`` loops over the index batches.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from yolov5_tpu_torch.data.device_aug import (aug_generator, device_augment,
                                              device_augment_seg, mosaic_in_batch)
from yolov5_tpu_torch.parallel.distributed import world
from yolov5_tpu_torch.parallel.mesh import all_reduce_grads, gather_rows, rank_rows
from yolov5_tpu_torch.train.optim import EMAState, Optimizer, ema_init, ema_update

GEOMETRY_KEYS = ("degrees", "translate", "scale", "shear", "perspective")


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BN statistics), the optimizer and its
    counters, the EMA, and the number of steps taken."""

    step: int
    model: torch.nn.Module
    opt: Optimizer
    ema: EMAState


def scale_hyp(hyp: dict, nl: int, nc: int, imgsz: int) -> dict:
    """Scale loss gains to layer count / class count / image size
    (reference train.py:325-328)."""
    out = dict(hyp)
    out["box"] = hyp.get("box", 0.05) * 3.0 / nl
    out["cls"] = hyp.get("cls", 0.5) * nc / 80.0 * 3.0 / nl
    out["obj"] = hyp.get("obj", 1.0) * (imgsz / 640.0) ** 2 * 3.0 / nl
    return out


def batch_stats(model: torch.nn.Module) -> dict:
    """The BN running statistics, by state_dict key."""
    return {k: v for k, v in model.named_buffers() if k.endswith(("running_mean", "running_var"))}


def init_train_state(model, opt: Optimizer) -> TrainState:
    return TrainState(0, model, opt, ema_init(dict(model.named_parameters()), batch_stats(model)))


def resize_batch(images, size):
    """(B, H, W, C) images resized to (B, size, size, C) bilinearly, as
    ``jax.image.resize(..., "linear")`` does (antialiased when it shrinks);
    uint8 rounds half up."""
    x = F.interpolate(images.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True).permute(0, 2, 3, 1)
    if images.dtype == torch.uint8:
        return (x + 0.5).clamp(0, 255).to(torch.uint8)
    return x.to(images.dtype)


def make_train_step(loss_fn, device_aug_hyp=None, dtype=torch.bfloat16, seed=0, ms_size=None,
                    has_masks=False, mask_shape=None, overlap=True):
    """The train step: ``step(state, batch, cache=None) -> (state, metrics)``.

    batch: {"images": (B, H, W, 3) uint8 or float in [0, 1], "targets"
    (B, M, 5), "valid" (B, M)}, plus "hw" (B, 2) for raw batches that the
    device mosaic composes; with ``cache`` (the device-resident dataset
    of ``data.device_cache``) batch is {"idx": (B,)} and the images and
    labels are gathered from it. ``device_aug_hyp``: when set, mosaic (raw
    batches), geometry, HSV and flips run on the device, drawn from
    ``aug_generator(seed, state.step)``. ``dtype`` bfloat16 runs the forward
    under autocast; float32 runs it in float32. ``ms_size``: the per-batch
    multi-scale size of device augmentation; the mosaic warps its canvas
    straight to it, and a batch without one (none is raw) is resized after
    augmentation as ``jax.image.resize(..., "linear")`` does (antialiased
    when it shrinks). The state is updated in place and returned.

    ``has_masks``: a segmentation step. The model returns (maps, proto) and
    the loss (``ComputeSegmentLoss``) takes ``batch["masks"]``; with device
    augmentation the batch (or the cache) also holds ``segments`` and
    ``device_augment_seg`` composes it and fills the masks at
    ``mask_shape`` (index maps with ``overlap``).

    With several ranks, ``batch`` is the rank's local batch, or, with
    ``cache``, the global index batch; the metrics are the rank's shares of
    the global batch's (their sum over ranks is the global value), and
    ``grad_norm`` is that of the summed gradients."""
    amp = dtype == torch.bfloat16

    def step(state: TrainState, batch, cache=None):
        model = state.model
        self_idx = None
        whole = world() > 1 and (cache is not None or device_aug_hyp is not None)
        if whole and cache is None:  # the ranks' raw batches make the global batch
            batch = {k: gather_rows(v) for k, v in batch.items()}
        if cache is not None:
            self_idx = batch["idx"]
            batch = {k: cache[k][self_idx] for k in ("images", "hw", "targets", "valid",
                                                     "segments") if k in cache}
        if device_aug_hyp is not None and has_masks:
            gen = aug_generator(seed, state.step, batch["images"].device)
            batch = device_augment_seg(batch, gen, dict(device_aug_hyp), mask_shape,
                                       overlap=overlap, pool=cache, self_idx=self_idx,
                                       out_size=ms_size)
        elif device_aug_hyp is not None:
            gen = aug_generator(seed, state.step, batch["images"].device)
            hyp = dict(device_aug_hyp)
            if "hw" in batch:  # raw batches: the mosaic composes and warps
                images, targets, valid = mosaic_in_batch(
                    batch["images"], batch["hw"], batch["targets"], batch["valid"], gen, hyp,
                    pool=cache, self_idx=self_idx, out_size=ms_size)
                batch = {"images": images, "targets": targets, "valid": valid}
                hyp.update({k: 0.0 for k in GEOMETRY_KEYS})  # warped once, not twice
            batch = device_augment(batch, gen, hyp)
            if ms_size is not None and batch["images"].shape[1] != ms_size:
                batch = dict(batch, images=resize_batch(batch["images"], ms_size))
        if whole:
            batch = {k: rank_rows(v) for k, v in batch.items()}
        images = batch["images"].permute(0, 3, 1, 2)  # NHWC storage = channels_last
        if images.dtype == torch.uint8:
            images = images.to(dtype) / 255.0

        model.train()
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=amp):
            maps = model(images.contiguous(memory_format=torch.channels_last))
        if has_masks:
            total, comps = loss_fn(maps, batch["targets"], batch["valid"], batch["masks"])
        else:
            total, comps = loss_fn(maps, batch["targets"], batch["valid"])
        grads = all_reduce_grads(torch.autograd.grad(total, state.opt.params))
        tick = state.opt.step(grads)
        # EMA ticks only on real optimizer updates (accumulation)
        state.ema = ema_update(state.ema, dict(model.named_parameters()), batch_stats(model),
                               tick=tick)
        state.step += 1
        with torch.no_grad():
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics.update(total=total.detach(), grad_norm=grad_norm)
        return state, metrics

    return step
