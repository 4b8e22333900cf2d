"""The training run that detection (``train/run.py``) and segmentation
(``train/run_segment.py``) share: the setup, the epoch loop and the end,
written once.

A head builds a ``Run`` from its model class and its options (what its
``opt.yaml`` records), makes its loaders, and calls ``autoanchor``,
``build`` and ``fit`` in turn. It passes in what is its own: the loss, the
device-cache rule, the step for each size, the host batch's keys and
rescale, the summed metrics, the validation, and the hooks at an epoch's
start and end and at a model artifact. Nothing here asks which head it
serves.

Classification (``train/run_classify.py``) keeps a loop of its own: it
writes best.ckpt during validation and last.ckpt once at the end, and does
not resume.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from yolov5_tpu_torch.data.device_cache import (build_cache_arrays, cache_nbytes,
                                                device_memory_budget, index_batches, to_device)
from yolov5_tpu_torch.models.weights import from_jax_variables, load_torch_state_dict, load_weights
from yolov5_tpu_torch.parallel.distributed import (all_reduce_sum, broadcast_object, is_main,
                                                   rank_batch, world)
from yolov5_tpu_torch.parallel.mesh import replicate
from yolov5_tpu_torch.train.optim import Optimizer
from yolov5_tpu_torch.train.prefetch import prefetch
from yolov5_tpu_torch.train.trainer import init_train_state, scale_hyp
from yolov5_tpu_torch.utils.callbacks import Callbacks
from yolov5_tpu_torch.utils.checkpoint import (anchors_to_yaml, load_checkpoint,
                                               restore_train_state, save_checkpoint,
                                               variables_from_checkpoint)
from yolov5_tpu_torch.utils.general import check_dataset, check_img_size, init_seeds, run_dir
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


def device_cache(train_ds, max_labels, cache, device, segments_v=0):
    """The training set (and with ``segments_v`` its polygons) decoded into
    device memory when ``cache`` is "device", or None and it fits the
    device's budget; else None."""
    need = cache_nbytes(train_ds, max_labels, segments_v=segments_v)
    if cache != "device" and need > device_memory_budget(device):
        return None
    train_ds.cache = None  # no host RAM copy beside the device's
    arrays = to_device(build_cache_arrays(train_ds, max_labels, segments_v), device)
    what = "images + segments" if segments_v else "images"
    print(f"device cache: {len(train_ds)} {what} ({need / 1e6:.0f} MB) on {device}")
    return arrays


def ema_weights(state):
    """The EMA weights and the model's cfg with the live anchors as the
    checkpoint meta stores them: a model built from the saved ``best.ckpt``
    (``val``, ``segment val``) is exactly the one validated in training."""
    model = state.model
    return ({**state.ema.params, **state.ema.batch_stats},
            dict(model.cfg, nc=model.nc, anchors=anchors_to_yaml(model.anchors)))


def _nothing(*args, **kwargs):
    return None


class Run:
    """One training run of a ``model_cls`` on ``device`` with the options
    ``opt``, as ``opt.yaml`` records them: reads ``resume_ckpt``, writes the
    run's directory and opens its loggers on rank 0, and builds the model,
    unfused with float32 master weights."""

    def __init__(self, model_cls, device, opt, save_dir=None, exist_ok=False, sync_bn=False,
                 resume_ckpt=None):
        self.device, self.resume_ckpt = device, resume_ckpt
        self.n_ranks, self.main = world(), is_main()
        self.batch_size, self.rank_bs = opt["batch_size"], rank_batch(opt["batch_size"])
        if sync_bn:
            print("--sync-bn: cross-device BN stats are always on")
        init_seeds(opt["seed"])
        self.data = check_dataset(opt["data"])
        self.nc = 1 if opt["single_cls"] else int(self.data["nc"])
        self.opt = {k: (str(v) if isinstance(v, Path) else v) for k, v in opt.items()}
        self.hyp = load_hyp(opt["hyp"])
        if opt["label_smoothing"]:
            self.hyp["label_smoothing"] = float(opt["label_smoothing"])
        self.amp = {"bfloat16": torch.bfloat16, "float32": torch.float32}[opt["dtype"]]

        self.save_dir = run_dir(save_dir, opt["project"], opt["name"], exist_ok)
        self.loggers = None
        if self.main:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            (self.save_dir / "hyp.yaml").write_text(yaml.safe_dump(self.hyp, sort_keys=False))
            (self.save_dir / "opt.yaml").write_text(yaml.safe_dump(self.opt, sort_keys=False))
            self.loggers = Loggers(self.save_dir)

        self.epochs, self.start_epoch, self.best_fitness = opt["epochs"], 0, 0.0
        self.payload = anchors = None
        if resume_ckpt:
            self.payload, meta = load_checkpoint(resume_ckpt)
            anchors = meta.get("anchors")  # autoanchor may have evolved them
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.best_fitness = float(meta.get("best_fitness", 0.0))
            if self.start_epoch <= 0:
                raise ValueError(f"{resume_ckpt}: training is finished, nothing to resume")
            if self.epochs < self.start_epoch:
                print(f"{resume_ckpt} has been trained for {self.start_epoch - 1} epochs; "
                      f"fine-tuning for {self.epochs} more epochs")
                self.epochs += self.start_epoch - 1
        self.model = model_cls(opt["cfg"], nc=self.nc, seed=opt["seed"], anchors=anchors)
        if self.data.get("names"):
            self.model.names = {int(k): v for k, v in self.data["names"].items()}
        if opt["weights"] and not resume_ckpt:
            load_initial_weights(self.model, opt["weights"])
        self.imgsz = check_img_size(opt["imgsz"], s=max(self.model.stride))

    def autoanchor(self, train_ds):
        """Anchors fitted to the training labels, for a run from scratch."""
        if self.opt["noautoanchor"] or self.resume_ckpt or self.opt["weights"]:
            return
        from yolov5_tpu_torch.utils.autoanchor import check_anchors

        # drawn at random: rank 0 draws, every rank trains its anchors
        new_anchors = broadcast_object(check_anchors(
            train_ds, self.model, thr=self.hyp.get("anchor_t", 4.0), imgsz=self.imgsz)
            if self.main else None)
        if new_anchors != self.model.anchors:
            self.model.anchors = new_anchors
            self.model.cfg["anchors"] = anchors_to_yaml(new_anchors)
            print("autoanchor: anchors updated")

    def build(self, train_loader, make_loss):
        """The model on the device, the multi-scale sizes and the training
        state (resumed when the run resumes). make_loss: the scaled hyp ->
        the head's loss. Returns the loss."""
        self.nb = len(train_loader)
        if self.nb == 0:
            raise ValueError(f"train loader is empty for {self.data.get('train')}")
        opt, model = self.opt, self.model.to(self.device).to(memory_format=torch.channels_last)
        self.model, self.ms_sizes, self.ms_rng = model, [], None
        if opt["multi_scale"]:
            self.ms_sizes = multiscale_sizes(self.imgsz, max(model.stride))
            self.ms_rng = np.random.default_rng(opt["seed"] + 0x5CA1E)
            print(f"multi-scale: per-batch sizes {self.ms_sizes}")
        hyp_scaled = scale_hyp(self.hyp, nl=len(model.stride), nc=self.nc, imgsz=self.imgsz)
        loss_fn = make_loss(hyp_scaled)
        optimizer = Optimizer(dict(model.named_parameters()), hyp_scaled, epochs=self.epochs,
                              steps_per_epoch=self.nb, batch_size=self.batch_size,
                              name=opt["optimizer"], cos_lr=opt["cos_lr"], freeze=opt["freeze"])
        self.state = init_train_state(model, optimizer)
        if self.payload is not None:
            # momentum, accumulation, schedule position and EMA: the loss curve
            # continues as if never interrupted
            restore_train_state(self.state, self.payload)
            self.payload = None
        replicate(self.state)
        return loss_fn

    def fit(self, title, train_ds, train_loader, make_step, *, ms_device, cache_dev, batch_keys,
            rescale, keys, counters=(), validate=None, epoch_start=_nothing, epoch_end=_nothing,
            log_period=_nothing, log_final=_nothing, callbacks=None, noplots=False):
        """Train from ``start_epoch`` to ``epochs``; returns (best_fitness,
        results of the last validation, save_dir). make_step(size or None)
        -> the step; ms_device: sizes drawn on the device, a step each;
        cache_dev: the device cache fed index batches, or None for host
        batches of ``batch_keys``, rescale(batch, size) at a host multi-scale
        size. keys: the ``train/*`` row's sums, counters: summed beside
        them, both seen by epoch_end(sums). On rank 0: validate(state) ->
        (row entries, fitness, results) (None: no best.ckpt) after
        epoch_start(epoch, results) and the epoch's steps, and
        log_period(path, epoch, fitness, best) on each ``epoch{n}.ckpt``,
        log_final(path, epoch, fitness) on best.ckpt at the end."""
        callbacks = callbacks or Callbacks()
        device, nb, main, imgsz = self.device, self.nb, self.main, self.imgsz
        ms_sizes, ms_rng, multi_scale = self.ms_sizes, self.ms_rng, self.opt["multi_scale"]
        step_fns = {sz: make_step(sz) for sz in (ms_sizes if ms_device else [None])}

        def host_prep(batch):
            """The batch's arrays for the step, rescaled to a host
            multi-scale size drawn per batch."""
            batch = {k: batch[k] for k in batch_keys}
            s_b = int(ms_rng.choice(ms_sizes)) if multi_scale and not ms_device else imgsz
            return rescale(batch, s_b) if s_b != imgsz else batch

        def step_size():  # the device mosaic's size for the next batch
            return int(ms_rng.choice(ms_sizes)) if ms_device else None

        save_dir, opt, loggers = self.save_dir, self.opt, self.loggers
        last, best = save_dir / "last.ckpt", save_dir / "best.ckpt"
        stopper = EarlyStopper(opt["patience"])
        callbacks.run("on_train_start")
        if main:
            print(f"{title} on {self.data.get('train')}: {len(train_ds)} imgs, {nb} "
                  f"steps/epoch, {device}" + (f" x {self.n_ranks} ranks" if self.n_ranks > 1
                                              else "") + f", imgsz {imgsz}")

        results = {}
        t_start = time.time()
        epoch = self.start_epoch
        try:
            for epoch in range(self.start_epoch, self.epochs):
                callbacks.run("on_train_epoch_start")
                train_loader.set_epoch(epoch)
                epoch_start(epoch, results)
                t0 = time.time()
                if cache_dev is not None:
                    # one upload of the epoch's index batches; each step slices
                    # its row. With several ranks, the global batches: each
                    # rank augments the global batch and keeps its rows
                    idx_epoch = np.stack([b["idx"] for b in index_batches(
                        train_loader, whole=self.n_ranks > 1)])
                    plan = (multiscale_epoch_plan(idx_epoch, ms_sizes, ms_rng) if ms_device
                            else [(None, idx_epoch)])  # with ms_device, a share per size
                    feed = (({"idx": idx}, size) for size, rows in plan
                            for idx in torch.from_numpy(rows).to(device))
                else:  # host batches, prepared and copied two steps ahead
                    feed = ((batch, step_size()) for batch in
                            prefetch(iter(train_loader), device, depth=2, transform=host_prep))
                agg = None
                for batch, size in feed:
                    _, metrics = step_fns[size](self.state, batch, cache_dev)
                    agg = metrics if agg is None else {k: agg[k] + v for k, v in metrics.items()}
                    callbacks.run("on_train_batch_end")
                # the epoch's one wait for the device: the ranks' shares summed
                summed = keys + counters
                sums = dict(zip(summed, all_reduce_sum(torch.stack([agg[k] for k in summed]))
                                .tolist()))
                dt = time.time() - t0
                row = {f"train/{k}": sums[k] / nb for k in keys}
                row["train/imgs_per_sec"] = nb * self.batch_size / dt
                epoch_end(sums)
                callbacks.run("on_train_epoch_end", epoch=epoch)

                fi, stop = 0.0, False
                if main:  # the other ranks wait for its fitness below
                    if validate is not None:  # the EMA weights (reference train.py:446)
                        entries, fi, results = validate(self.state)
                        row.update(entries)
                    row["fitness"] = fi
                    loggers.log_metrics(row, epoch)
                    print(f"epoch {epoch + 1}/{self.epochs}  "
                          + "  ".join(f"{k.split('/')[-1]} {v:.4g}" for k, v in row.items()))

                    self.best_fitness = max(self.best_fitness, fi)
                    if not opt["nosave"]:
                        save_checkpoint(last, self.state, epoch, self.best_fitness,
                                        include_opt=True)
                        if validate is not None and self.best_fitness == fi:
                            save_checkpoint(best, self.state, epoch, self.best_fitness)
                        if opt["save_period"] > 0 and epoch % opt["save_period"] == 0:
                            save_checkpoint(save_dir / f"epoch{epoch}.ckpt", self.state, epoch,
                                            self.best_fitness)
                            log_period(last, epoch, fi, self.best_fitness == fi)
                        callbacks.run("on_model_save", epoch=epoch)
                    stop = stopper(epoch, fi)
                    if stop:
                        print(f"early stopping at epoch {epoch + 1} "
                              f"(no fitness gain in {opt['patience']} epochs)")
                fi, self.best_fitness, stop, results = broadcast_object(
                    (fi, self.best_fitness, stop, results))
                callbacks.run("on_fit_epoch_end", epoch=epoch, fitness=fi)
                if stop:
                    break
        finally:
            train_loader.close()

        if main:
            print(f"done in {(time.time() - t_start) / 3600:.3f}h, "
                  f"best fitness {self.best_fitness:.4f}")
            if not noplots:
                from yolov5_tpu_torch.utils.plots import plot_labels, plot_results

                plot_results(save_dir / "results.csv")
                plot_labels(train_ds.labels, self.model.names, save_dir)
        callbacks.run("on_train_end")
        if main:
            if best.exists():
                log_final(best, epoch, self.best_fitness)
            loggers.close()
        return self.best_fitness, results, save_dir
