"""Detection training: ``run(**kwargs)``, the port of
``yolov5_tpu/train/run.py`` (the reference's train.py:105-528), on one
device or on one device per process under torchrun, through the setup and
epoch loop it shares with segmentation (``train/loop.py``).

Two ways to augment. By default, as in the JAX package, the host augments:
``data.dataset`` builds mosaic (copy-paste, mixup), random_perspective, HSV
and flips with numpy in a pool of worker processes, and ``train.prefetch``
copies the batches to the device two ahead of the step. With
``device_aug`` the training set is decoded once and kept in device memory
when it fits (``data.device_cache``), else streamed as raw batches; mosaic,
geometry, HSV and flips then run on the device (``data.device_aug``).
``rect`` (no mosaic, no shuffle), ``quad`` (2s batches, loss gain 4),
``multi_scale`` (a stride-aligned size per batch: resized on the host, or
folded into the device mosaic's warp) and ``image_weights`` (indices drawn
by per-image weights from the second epoch) are the JAX package's. The
model trains in bf16 autocast with float32 master weights. After each
epoch the EMA weights, with BN folded, are validated through
``eval.evaluator.evaluate`` (the stem kernel K2 and the suppression kernel
K1 on CUDA). ``last.ckpt`` keeps the optimizer state for ``--resume``;
``best.ckpt`` does not. Both are in the JAX package's format. Each epoch's
row goes to ``results.csv``, a TensorBoard event file and the cloud loggers
whose SDK imports (``utils.loggers``); ``--resume`` also takes ``comet://``
and ``wandb-artifact://`` runs. At the end,
``results.png`` and ``labels.png`` (``utils.plots``) unless ``noplots``.

Several processes (``WORLD_SIZE`` > 1, torchrun's environment): each rank
trains on ``cuda:LOCAL_RANK`` (``parallel.distributed``) with its shard of
each global batch; ``batch_size`` is the global batch, ``batch_size //
world`` a rank's. Batch norm and the loss take the global batch's
statistics and normalisers, and the gradients are summed over the ranks,
so an N-rank run takes the steps one process takes at the global batch.
Autoanchor, validation, checkpoints, logs and plots run on rank 0; its
anchors, fitness and results are broadcast, so that every rank stops,
reweighs images and resamples sizes alike.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolov5_tpu_torch.data.cv import resize
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.eval.evaluator import evaluate
from yolov5_tpu_torch.infer import Detector, resolve_device
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.parallel.distributed import (broadcast_object, init_distributed, is_main,
                                                   rank, rank_device)
from yolov5_tpu_torch.train.loop import Run, device_cache, ema_weights, resume_options
from yolov5_tpu_torch.train.loss import ComputeLoss
from yolov5_tpu_torch.train.trainer import make_train_step
from yolov5_tpu_torch.utils.callbacks import Callbacks
from yolov5_tpu_torch.utils.general import labels_to_class_weights
from yolov5_tpu_torch.utils.loggers import check_comet_resume, check_wandb_resume


def run(data, cfg="yolov5n", hyp=None, weights="", epochs=100, batch_size=16, imgsz=640,
        optimizer="sgd", cos_lr=False, seed=0, workers=8, max_labels=None, single_cls=False,
        patience=100, save_dir=None, project="runs/train", name="exp", exist_ok=False,
        nosave=False, noval=False, save_period=-1, dtype="bfloat16", val_batch_size=None,
        callbacks: Callbacks | None = None, resume="", freeze=None, multi_scale=False,
        image_weights=False, cache=None, noautoanchor=False, device_aug=False, quad=False,
        label_smoothing=0.0, noplots=False, rect=False, sync_bn=False, upload_dataset=False,
        device="cuda", _resume_ckpt=None):
    """Train a detector on ``device``. Returns (best_fitness, results of the
    last validation, save_dir)."""
    callbacks = callbacks or Callbacks()
    init_distributed(device)
    device_arg, device = device, resolve_device(str(rank_device(device)), "train.run")
    if resume and _resume_ckpt is None:
        # cloud runs first (rank 0 downloads): comet:// brings its opt.yaml
        # and newest checkpoint, wandb-artifact:// the model artifact's ckpt
        cloud = broadcast_object((check_comet_resume(resume, project),
                                  check_wandb_resume(resume, project)) if is_main() else None)
        if cloud[0] is not None:
            saved, ckpt_path = cloud[0]
            saved.pop("resume", None)
            print(f"resuming from {resume} -> {ckpt_path}")
            return run(**saved, _resume_ckpt=ckpt_path, save_dir=str(Path(ckpt_path).parent),
                       callbacks=callbacks, device=device_arg)
        saved, ckpt_path = resume_options(cloud[1] or resume, project)
        if saved is not None:
            return run(**saved, _resume_ckpt=str(ckpt_path), save_dir=str(ckpt_path.parent),
                       callbacks=callbacks, device=device_arg)
        _resume_ckpt, save_dir = str(ckpt_path), save_dir or str(ckpt_path.parent)
    r = Run(DetectionModel, device, dict(
        data=data, cfg=cfg, hyp=hyp, weights=weights, epochs=epochs, batch_size=batch_size,
        imgsz=imgsz, optimizer=optimizer, cos_lr=cos_lr, seed=seed, workers=workers,
        max_labels=max_labels, single_cls=single_cls, patience=patience, project=project,
        name=name, nosave=nosave, noval=noval, save_period=save_period, dtype=dtype,
        val_batch_size=val_batch_size, freeze=freeze, multi_scale=multi_scale,
        image_weights=image_weights, cache=cache, noautoanchor=noautoanchor,
        device_aug=device_aug, quad=quad, rect=rect, label_smoothing=label_smoothing,
        upload_dataset=upload_dataset,
    ), save_dir=save_dir, exist_ok=exist_ok, sync_bn=sync_bn, resume_ckpt=_resume_ckpt)
    if r.main:  # the run's config as assets: what a comet:// resume reads back
        r.loggers.log_asset(r.save_dir / "opt.yaml")
        r.loggers.log_asset(r.save_dir / "hyp.yaml")
        if upload_dataset:
            r.loggers.log_dataset(r.data, yaml_file=r.data.get("yaml_file"))
    nc, imgsz = r.nc, r.imgsz

    # data: host-augmented batches, or raw batches for the device mosaic
    if rect and (device_aug or image_weights):
        raise ValueError("--rect training needs the host loader without shuffle (reference "
                         "dataloaders.py:148); drop --device-aug/--image-weights or --rect")
    if quad and device_aug:
        raise ValueError("--quad composes batches on the host; it is redundant with the "
                         "--device-aug mosaic: drop one flag")
    train_ds, train_loader = create_loader(
        r.data["train"], img_size=imgsz, batch_size=r.rank_bs, augment=True,
        hyp=dict(r.hyp, mosaic=0.0) if rect else r.hyp,  # reference: rect turns the mosaic off
        workers=workers, max_labels=max_labels, seed=seed, single_cls=single_cls,
        cache=cache if cache in (None, False, "ram", "disk") else False,
        device_aug=device_aug, quad=quad, rect=rect, shuffle=not rect,
        shard=(rank(), r.n_ranks))
    max_labels = train_loader.max_labels
    r.autoanchor(train_ds)
    val_loader = None
    if r.data.get("val") and not noval and r.main:
        _, val_loader = create_loader(r.data["val"], img_size=imgsz,
                                      batch_size=val_batch_size or batch_size, workers=workers,
                                      max_labels=max_labels, single_cls=single_cls)
    loss_fn = r.build(train_loader, lambda h: ComputeLoss(r.model.anchors_per_stride, nc, h,
                                                          gain=4.0 if quad else 1.0))
    cache_dev = (device_cache(train_ds, max_labels, cache, device)
                 if device_aug and cache in (None, "device") else None)
    aug_hyp = r.hyp if device_aug else None

    def rescale(batch, size):  # quad batches are 2s
        t = size * (2 if quad else 1)
        batch["images"] = np.stack([resize(im, (t, t), "linear") for im in batch["images"]])
        return batch

    def reweigh(epoch, results):
        if image_weights and results.get("per_class") is not None:
            # resample images toward the classes with the worst AP (reference
            # train.py:359-362 + labels_to_image_weights)
            cw = labels_to_class_weights(train_ds.labels, nc)
            ap_per = results.get("per_class", {})
            err = np.array([cw[c] * (1.0 - ap_per.get(c, (0.0, 0.0))[1]) for c in range(nc)])
            iw = np.array([(err[lb[:, 0].astype(int)].sum() if len(lb) else 0.0)
                           for lb in train_ds.labels]) + 1e-6
            train_loader.set_image_weights(iw, epoch)

    def validate(state):
        det = Detector(*ema_weights(state), imgsz=imgsz, half=r.amp == torch.bfloat16,
                       device=device)
        results = evaluate(det.forward, val_loader, device)
        return ({f"val/{k}": results[k] for k in ("mp", "mr", "map50", "map")},
                results["fitness"], results)

    def log_model(path, epoch, fitness, best=True):  # the cloud model artifact
        r.loggers.log_model(path, epoch=epoch, fitness=fitness, best=best, opt=r.opt)

    return r.fit(
        f"training {cfg}", train_ds, train_loader,
        lambda size: make_train_step(loss_fn, device_aug_hyp=aug_hyp, dtype=r.amp, seed=seed,
                                     ms_size=size),
        ms_device=multi_scale and device_aug,  # the mosaic warps to the drawn size
        cache_dev=cache_dev, rescale=rescale,
        batch_keys=("images", "hw", "targets", "valid") if device_aug else ("images", "targets",
                                                                             "valid"),
        keys=("box", "obj", "cls", "total"), validate=validate if val_loader is not None else None,
        epoch_start=reweigh, log_period=log_model, log_final=log_model, callbacks=callbacks,
        noplots=noplots)
