"""The detection training loop: ``run(**kwargs)``, the port of
``yolov5_tpu/train/run.py`` (the reference's train.py:105-528) on one
explicit device.

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
``best.ckpt`` does not. Both are in the JAX package's format.

Not ported, and raising ``NotImplementedError``: the cloud loggers
(``upload_dataset``) and cloud resumes. Plots are not written.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from yolov5_tpu_torch.data.cv import resize
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.data.device_cache import (build_cache_arrays, cache_nbytes,
                                                device_memory_budget, index_batches, to_device)
from yolov5_tpu_torch.eval.evaluator import evaluate
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.models.weights import from_jax_variables, load_torch_state_dict, load_weights
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.train.loss import ComputeLoss
from yolov5_tpu_torch.train.optim import Optimizer
from yolov5_tpu_torch.train.prefetch import prefetch
from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
from yolov5_tpu_torch.utils.callbacks import Callbacks
from yolov5_tpu_torch.utils.checkpoint import (anchors_to_yaml, load_checkpoint,
                                               restore_train_state, save_checkpoint,
                                               variables_from_checkpoint)
from yolov5_tpu_torch.utils.general import (check_dataset, check_img_size, increment_path,
                                            init_seeds, labels_to_class_weights)
from yolov5_tpu_torch.utils.hyp import load_hyp
from yolov5_tpu_torch.utils.loggers import Loggers


def multiscale_sizes(imgsz, gs, n=None):
    """The stride-aligned sizes of multi-scale training: ``n`` (default 5, or
    ``YOLOV5_TPU_MS_BUCKETS``) evenly spaced multiples of ``gs`` over the
    reference's 0.5-1.5x range (train.py:393-398), as the JAX package bins
    it (run.py:42-57)."""
    if n is None:
        n = int(os.environ.get("YOLOV5_TPU_MS_BUCKETS", 5))
    lo = max(1, int(round(imgsz * 0.5 / gs)))
    hi = int(round(imgsz * 1.5 / gs))
    ks = np.unique(np.linspace(lo, hi, min(n, hi - lo + 1)).round().astype(int))
    return [int(k * gs) for k in ks]


def multiscale_epoch_plan(idx_epoch, sizes, rng):
    """The device-cached epoch's batches by size (the JAX package's
    run.py:60-80): each size gets a fixed share of the epoch's batches (the
    remainder to the first sizes), and which batches reshuffles each epoch.
    Yields (size, index rows)."""
    nb = len(idx_epoch)
    k = len(sizes)
    order = rng.permutation(nb)
    start = 0
    for i, sz in enumerate(sizes):
        n = nb // k + (1 if i < nb % k else 0)
        if n:
            yield int(sz), idx_epoch[order[start:start + n]]
        start += n


def find_resume_ckpt(resume, project="runs/train"):
    """--resume -> a checkpoint path: True/'auto' -> the newest last.ckpt
    under ``project``; a run dir -> its last.ckpt; else the path itself
    (reference get_latest_run, train.py:624)."""
    if resume is True or str(resume).lower() in ("auto", "true", "latest"):
        cands = sorted(Path(project).glob("**/last.ckpt"), key=lambda p: p.stat().st_mtime)
        if not cands:
            raise FileNotFoundError(f"--resume: no last.ckpt found under {project}")
        return cands[-1]
    p = Path(resume)
    if p.is_dir():
        p = p / "last.ckpt"
    if not p.exists():
        raise FileNotFoundError(f"--resume checkpoint not found: {p}")
    return p


def resume_options(resume, project):
    """--resume -> (the interrupted run's saved options with its hyp.yaml, or
    None when it left no opt.yaml; its last.ckpt). The reference
    (train.py:624-636) replaces opt wholesale from the run's directory."""
    ckpt_path = find_resume_ckpt(resume, project)
    run_dir = ckpt_path.parent
    opt_file, hyp_file = run_dir / "opt.yaml", run_dir / "hyp.yaml"
    if not opt_file.exists():
        return None, ckpt_path
    saved = yaml.safe_load(opt_file.read_text()) or {}
    saved.pop("resume", None)
    if hyp_file.exists():
        saved["hyp"] = str(hyp_file)
    print(f"resuming {run_dir}")
    return saved, ckpt_path


def load_initial_weights(model, weights):
    """Initial weights into ``model``: a reference ``.pt``, or a ``.ckpt``
    (its EMA weights when it has them)."""
    if str(weights).endswith(".pt"):
        sd = load_torch_state_dict(weights)
    else:
        payload, _ = load_checkpoint(weights)
        sd = from_jax_variables(variables_from_checkpoint(payload, prefer_ema=True))
    missed = load_weights(model, sd)
    if missed:
        print(f"weight import: {len(missed)} unmatched entries")


class EarlyStopper:
    """Fitness-patience early stop (reference torch_utils.py:315-340)."""

    def __init__(self, patience=100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch, fi):
        if fi >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fi
        return (epoch - self.best_epoch) >= self.patience


def ema_detector(state, imgsz, half, device):
    """A ``Detector`` (BN folded) of the EMA weights, with the live anchors
    rounded as the checkpoint meta stores them: ``val.run`` on the saved
    ``best.ckpt`` rebuilds exactly this model."""
    model = state.model
    cfg = dict(model.cfg, nc=model.nc, anchors=anchors_to_yaml(model.anchors))
    return Detector({**state.ema.params, **state.ema.batch_stats}, cfg=cfg, imgsz=imgsz,
                    half=half, device=device)


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
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train.run(device={str(device)!r}): no CUDA device is available")
    if resume and _resume_ckpt is None:
        if str(resume).startswith(("comet://", "wandb-artifact://")):
            raise NotImplementedError(f"train.run: cloud resume {resume} is not ported")
        saved, ckpt_path = resume_options(resume, project)
        if saved is not None:
            return run(**saved, _resume_ckpt=str(ckpt_path), save_dir=str(ckpt_path.parent),
                       callbacks=callbacks, device=device)
        _resume_ckpt = str(ckpt_path)
        save_dir = save_dir or str(ckpt_path.parent)
    if upload_dataset:
        raise NotImplementedError("train.run: --upload-dataset (cloud loggers) is not ported")
    if sync_bn:
        print("--sync-bn: one device, nothing to synchronise")
    init_seeds(seed)
    data_dict = check_dataset(data)
    nc = 1 if single_cls else int(data_dict["nc"])
    opt_dict = {k: (str(v) if isinstance(v, Path) else v) for k, v in dict(
        data=data, cfg=cfg, hyp=hyp, weights=weights, epochs=epochs, batch_size=batch_size,
        imgsz=imgsz, optimizer=optimizer, cos_lr=cos_lr, seed=seed, workers=workers,
        max_labels=max_labels, single_cls=single_cls, patience=patience, project=project,
        name=name, nosave=nosave, noval=noval, save_period=save_period, dtype=dtype,
        val_batch_size=val_batch_size, freeze=freeze, multi_scale=multi_scale,
        image_weights=image_weights, cache=cache, noautoanchor=noautoanchor,
        device_aug=device_aug, quad=quad, rect=rect, label_smoothing=label_smoothing,
    ).items()}
    hyp = load_hyp(hyp)
    if label_smoothing:
        hyp["label_smoothing"] = float(label_smoothing)
    amp = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]

    save_dir = Path(save_dir) if save_dir else increment_path(Path(project) / name,
                                                              exist_ok=exist_ok)
    save_dir.mkdir(parents=True, exist_ok=True)
    (save_dir / "hyp.yaml").write_text(yaml.safe_dump(hyp, sort_keys=False))
    (save_dir / "opt.yaml").write_text(yaml.safe_dump(opt_dict, sort_keys=False))
    loggers = Loggers(save_dir)
    last, best = save_dir / "last.ckpt", save_dir / "best.ckpt"

    # model: unfused, float32 master weights
    start_epoch, best_fitness, resume_payload = 0, 0.0, None
    anchors = None
    if _resume_ckpt:
        resume_payload, meta = load_checkpoint(_resume_ckpt)
        anchors = meta.get("anchors")  # autoanchor may have evolved them
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_fitness = float(meta.get("best_fitness", 0.0))
        if start_epoch <= 0:
            raise ValueError(f"{_resume_ckpt}: training is finished, nothing to resume")
        if epochs < start_epoch:
            print(f"{_resume_ckpt} has been trained for {start_epoch - 1} epochs; "
                  f"fine-tuning for {epochs} more epochs")
            epochs += start_epoch - 1
    model = DetectionModel(cfg, nc=nc, seed=seed, anchors=anchors)
    if data_dict.get("names"):
        model.names = {int(k): v for k, v in data_dict["names"].items()}
    if weights and not _resume_ckpt:
        load_initial_weights(model, weights)
    imgsz = check_img_size(imgsz, s=max(model.stride))

    # data: host-augmented batches, or raw batches for the device mosaic
    if rect and (device_aug or image_weights):
        raise ValueError("--rect training needs the host loader without shuffle (reference "
                         "dataloaders.py:148); drop --device-aug/--image-weights or --rect")
    if quad and device_aug:
        raise ValueError("--quad composes batches on the host; it is redundant with the "
                         "--device-aug mosaic: drop one flag")
    if rect:
        hyp = dict(hyp, mosaic=0.0)  # reference: rect turns the mosaic off
    train_ds, train_loader = create_loader(
        data_dict["train"], img_size=imgsz, batch_size=batch_size, augment=True, hyp=hyp,
        workers=workers, max_labels=max_labels, seed=seed, single_cls=single_cls,
        cache=cache if cache in (None, False, "ram", "disk") else False,
        device_aug=device_aug, quad=quad, rect=rect, shuffle=not rect)
    max_labels = train_loader.max_labels
    if not noautoanchor and not _resume_ckpt and not weights:
        from yolov5_tpu_torch.utils.autoanchor import check_anchors

        new_anchors = check_anchors(train_ds, model, thr=hyp.get("anchor_t", 4.0), imgsz=imgsz)
        if new_anchors != model.anchors:
            model.anchors = new_anchors
            model.cfg["anchors"] = anchors_to_yaml(new_anchors)
            print("autoanchor: anchors updated")
    val_loader = None
    if data_dict.get("val") and not noval:
        _, val_loader = create_loader(data_dict["val"], img_size=imgsz,
                                      batch_size=val_batch_size or batch_size, workers=workers,
                                      max_labels=max_labels, single_cls=single_cls)
    nb = len(train_loader)
    if nb == 0:
        raise ValueError(f"train loader is empty for {data_dict.get('train')}")

    model = model.to(device).to(memory_format=torch.channels_last)
    ms_sizes, ms_rng = [], None
    if multi_scale:
        ms_sizes = multiscale_sizes(imgsz, max(model.stride))
        ms_rng = np.random.default_rng(seed + 0x5CA1E)
        print(f"multi-scale: per-batch sizes {ms_sizes}")
    ms_device = multi_scale and device_aug  # the mosaic warps to the drawn size
    hyp_scaled = scale_hyp(hyp, nl=len(model.stride), nc=nc, imgsz=imgsz)
    loss_fn = ComputeLoss(model.anchors_per_stride, nc, hyp_scaled, gain=4.0 if quad else 1.0)
    opt = Optimizer(dict(model.named_parameters()), hyp_scaled, epochs=epochs,
                    steps_per_epoch=nb, batch_size=batch_size, name=optimizer, cos_lr=cos_lr,
                    freeze=freeze)
    state = init_train_state(model, opt)
    if resume_payload is not None:
        # momentum, accumulation, schedule position and EMA: the loss curve
        # continues as if never interrupted
        restore_train_state(state, resume_payload)
        resume_payload = None

    cache_dev = None
    if device_aug and cache in (None, "device"):
        need = cache_nbytes(train_ds, max_labels)
        if cache == "device" or need <= device_memory_budget(device):
            train_ds.cache = None  # no host RAM copy beside the device's
            cache_dev = to_device(build_cache_arrays(train_ds, max_labels), device)
            print(f"device cache: {len(train_ds)} images ({need / 1e6:.0f} MB) on {device}")
    aug_hyp = hyp if device_aug else None
    step_fns = {sz: make_train_step(loss_fn, device_aug_hyp=aug_hyp, dtype=amp, seed=seed,
                                    ms_size=sz) for sz in (ms_sizes if ms_device else [None])}
    batch_keys = ("images", "hw", "targets", "valid") if device_aug else ("images", "targets",
                                                                          "valid")

    def host_prep(batch):
        """The batch's arrays for the step; a host multi-scale size drawn per
        batch resizes its images (quad batches are 2s)."""
        batch = {k: batch[k] for k in batch_keys}
        s_b = int(ms_rng.choice(ms_sizes)) if multi_scale and not ms_device else imgsz
        if s_b != imgsz:
            t = s_b * (2 if quad else 1)
            batch["images"] = np.stack([resize(im, (t, t), "linear")
                                        for im in batch["images"]])
        return batch

    def step_size():  # the device mosaic's size for the next batch
        return int(ms_rng.choice(ms_sizes)) if ms_device else None

    stopper = EarlyStopper(patience)
    callbacks.run("on_train_start")
    print(f"training {cfg} on {data_dict.get('train')}: {len(train_ds)} imgs, {nb} steps/epoch, "
          f"{device}, imgsz {imgsz}")

    results = {}
    t_start = time.time()
    epoch = start_epoch
    try:
        for epoch in range(start_epoch, epochs):
            callbacks.run("on_train_epoch_start")
            train_loader.set_epoch(epoch)
            if image_weights and results.get("per_class") is not None:
                # resample images toward the classes with the worst AP (reference
                # train.py:359-362 + labels_to_image_weights)
                cw = labels_to_class_weights(train_ds.labels, nc)
                ap_per = results.get("per_class", {})
                err = np.array([cw[c] * (1.0 - ap_per.get(c, (0.0, 0.0))[1])
                                for c in range(nc)])
                iw = np.array([(err[lb[:, 0].astype(int)].sum() if len(lb) else 0.0)
                               for lb in train_ds.labels]) + 1e-6
                train_loader.set_image_weights(iw, epoch)
            t0 = time.time()
            if cache_dev is not None:
                # one upload of the epoch's index batches; each step slices its row
                idx_epoch = np.stack([b["idx"] for b in index_batches(train_loader)])
                plan = (multiscale_epoch_plan(idx_epoch, ms_sizes, ms_rng) if ms_device
                        else [(None, idx_epoch)])  # with ms_device, a share per size
                feed = (({"idx": idx}, size) for size, rows in plan
                        for idx in torch.from_numpy(rows).to(device))
            else:  # host batches, prepared and copied two steps ahead
                feed = ((batch, step_size()) for batch in
                        prefetch(iter(train_loader), device, depth=2, transform=host_prep))
            agg = None
            for batch, size in feed:
                _, metrics = step_fns[size](state, batch, cache_dev)
                agg = metrics if agg is None else {k: agg[k] + v for k, v in metrics.items()}
                callbacks.run("on_train_batch_end")
            agg = {k: v.item() for k, v in agg.items()}  # the epoch's one wait for the device
            dt = time.time() - t0
            row = {f"train/{k}": agg[k] / nb for k in ("box", "obj", "cls", "total")}
            row["train/imgs_per_sec"] = nb * batch_size / dt
            callbacks.run("on_train_epoch_end", epoch=epoch)

            # validate the EMA weights (the reference validates ema, train.py:446)
            fi = 0.0
            if val_loader is not None:
                det = ema_detector(state, imgsz, amp == torch.bfloat16, device)
                results = evaluate(det.forward, val_loader, device)
                row.update({f"val/{k}": results[k] for k in ("mp", "mr", "map50", "map")})
                fi = results["fitness"]
            row["fitness"] = fi
            loggers.log_metrics(row, epoch)
            print(f"epoch {epoch + 1}/{epochs}  "
                  + "  ".join(f"{k.split('/')[-1]} {v:.4g}" for k, v in row.items()))

            best_fitness = max(best_fitness, fi)
            if not nosave:
                save_checkpoint(last, state, epoch, best_fitness, include_opt=True)
                if val_loader is not None and best_fitness == fi:
                    save_checkpoint(best, state, epoch, best_fitness)
                if save_period > 0 and epoch % save_period == 0:
                    save_checkpoint(save_dir / f"epoch{epoch}.ckpt", state, epoch,
                                    best_fitness)
                callbacks.run("on_model_save", epoch=epoch)
            callbacks.run("on_fit_epoch_end", epoch=epoch, fitness=fi)
            if stopper(epoch, fi):
                print(f"early stopping at epoch {epoch + 1} "
                      f"(no fitness gain in {patience} epochs)")
                break
    finally:
        train_loader.close()

    print(f"done in {(time.time() - t_start) / 3600:.3f}h, best fitness {best_fitness:.4f}")
    callbacks.run("on_train_end")
    return best_fitness, results, save_dir
