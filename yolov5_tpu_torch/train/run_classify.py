"""Classification training and validation: ``run`` and
``validate_classify``, the port of ``yolov5_tpu/train/run_classify.py`` (the
reference's classify/train.py and classify/val.py) on one explicit device.

The model is the detection backbone cut at ``cutoff`` with a Classify head
(``models.yolo.ClassificationModel``), trained unfused with train-mode BN,
cross entropy with label smoothing, the 3-group optimizer (Adam by default,
no warmup, cosine lr) and the EMA. When the decoded set fits the device's
budget it lives in device memory and each step gathers its batch there and
augments it on the device (``classify_device_augment``, drawn from
``aug_generator(seed, step)``); otherwise the host ``ImageFolder`` crops and
flips each batch. Each epoch the EMA weights, BN folded (so the stem runs
K2 on CUDA), score the val split's center crops: top-1 and top-5.
``last.ckpt`` and ``best.ckpt`` are the JAX package's format without
optimizer state, with cfg, nc, names and imgsz in their meta.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolov5_tpu_torch.data.classify import ImageFolder, build_cls_cache, normalize
from yolov5_tpu_torch.data.device_aug import aug_generator, classify_device_augment
from yolov5_tpu_torch.data.device_cache import device_memory_budget
from yolov5_tpu_torch.infer import resolve_device
from yolov5_tpu_torch.models.weights import (from_jax_variables, fuse_conv_bn,
                                             load_torch_state_dict, load_weights)
from yolov5_tpu_torch.models.yolo import ClassificationModel
from yolov5_tpu_torch.train.loss import classification_loss
from yolov5_tpu_torch.train.optim import Optimizer, ema_update
from yolov5_tpu_torch.train.trainer import batch_stats, init_train_state
from yolov5_tpu_torch.utils.checkpoint import (load_checkpoint, save_checkpoint,
                                               variables_from_checkpoint)
from yolov5_tpu_torch.utils.general import increment_path, init_seeds
from yolov5_tpu_torch.utils.loggers import Loggers


def fused_classifier(state_dict, cfg="yolov5s", nc=1000, cutoff=10, device="cuda"):
    """An eval-mode ``ClassificationModel`` with BN folded from a state_dict
    (fused or not), channels_last on ``device``: the card unless the caller
    asks for the CPU."""
    dev = resolve_device(device, "fused_classifier")
    model = ClassificationModel(cfg, nc=nc, cutoff=cutoff, fused=True)
    missed = load_weights(model, fuse_conv_bn(state_dict))
    if missed:
        print(f"weight import: {len(missed)} unmatched entries")
    return model.to(dev).to(memory_format=torch.channels_last).eval()


def load_classifier(weights, cfg="yolov5s", nc=None, cutoff=10, device="cuda"):
    """(BN-folded classifier on ``device``, class names, checkpoint meta).

    ``weights``: a ``.ckpt`` of either package (its EMA weights; cfg, nc,
    names and cutoff from its meta), or a ``.pt`` state_dict in the port's
    key layout (nc from its head unless given)."""
    dev = resolve_device(device, "load_classifier")
    meta, names = {}, None
    if str(weights).endswith(".ckpt"):
        payload, meta = load_checkpoint(weights)
        names = {int(k): v for k, v in (meta.get("names") or {}).items()}
        cfg, cutoff = meta.get("cfg", cfg), int(meta.get("cutoff", cutoff))
        nc = meta.get("nc", len(names) or nc)
        sd = from_jax_variables(variables_from_checkpoint(payload, prefer_ema=True))
    elif str(weights).endswith(".pt"):
        sd = load_torch_state_dict(Path(weights))
    else:
        raise ValueError(f"load_classifier: weights must be a .ckpt or .pt path, got {weights!r}")
    if nc is None:
        head = sd.get(f"model.{cutoff}.linear.weight")
        nc = int(head.shape[0]) if head is not None else 1000
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    return fused_classifier(sd, cfg, nc, cutoff, dev), names or None, meta


@torch.no_grad()
def classify_logits(model, images):
    """(B, H, W, 3) uint8 RGB on the model's device -> (B, nc) float32
    logits of an eval-mode model."""
    x = normalize(images.permute(0, 3, 1, 2), torch.float32)
    return model(x.contiguous(memory_format=torch.channels_last)).float()


def make_classify_step(label_smoothing=0.0, dtype=torch.float32, seed=0, device_aug=False):
    """``step(state, batch, cache=None) -> (state, metrics)``: batch is
    {"images": (B, s, s, 3) uint8 RGB, "labels": (B,)} on the device, or
    {"idx": (B,)} into ``cache`` ({"images", "labels"} on the device);
    ``device_aug`` crops, flips and jitters on the device, drawn from
    ``aug_generator(seed, state.step)``. ``dtype`` bfloat16 runs the forward
    under autocast. Metrics (loss, acc) stay on the device."""
    amp = dtype == torch.bfloat16

    def step(state, batch, cache=None):
        model = state.model
        if cache is not None:
            batch = {k: cache[k][batch["idx"]] for k in ("images", "labels")}
        images, labels = batch["images"], batch["labels"].long()
        if device_aug:
            images = classify_device_augment(images,
                                             aug_generator(seed, state.step, images.device))
        x = normalize(images.permute(0, 3, 1, 2), torch.float32)
        model.train()
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=amp):
            logits = model(x.contiguous(memory_format=torch.channels_last))
        loss = classification_loss(logits, labels, label_smoothing)
        grads = torch.autograd.grad(loss, state.opt.params)
        tick = state.opt.step(grads)
        state.ema = ema_update(state.ema, dict(model.named_parameters()), batch_stats(model),
                               tick=tick)
        state.step += 1
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return state, {"loss": loss.detach(), "acc": acc}

    return step


def run(data, cfg="yolov5s", epochs=10, batch_size=64, imgsz=224, lr0=0.001, optimizer="adam",
        label_smoothing=0.1, seed=0, project="runs/train-cls", name="exp", exist_ok=False,
        dtype="float32", verbose=True, save_dir=None, nosave=False, device_aug=True,
        device="cuda"):
    """Train a classifier on ``device``; returns (best_top1, save_dir).

    ``data`` is an ImageFolder root with train/ (or the classes itself) and
    optionally val/. Validation drops the val split's partial last batch, as
    the JAX package's does; ``best.ckpt`` is written on a tie."""
    dev = resolve_device(device, "run_classify.run")
    init_seeds(seed)
    data = Path(data)
    train_dir = data / "train" if (data / "train").exists() else data
    val_dir = data / "val" if (data / "val").exists() else None
    train_ds = ImageFolder(train_dir, imgsz, augment=True)
    val_ds = ImageFolder(val_dir, imgsz) if val_dir else None
    nc = len(train_ds.classes)

    save_dir = Path(save_dir) if save_dir else increment_path(Path(project) / name,
                                                              exist_ok=exist_ok)
    save_dir.mkdir(parents=True, exist_ok=True)
    loggers = Loggers(save_dir)

    amp = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    model = ClassificationModel(cfg, nc=nc, seed=seed)
    model.names = dict(enumerate(train_ds.classes))
    model = model.to(dev).to(memory_format=torch.channels_last)
    nb = max(len(train_ds) // batch_size, 1)
    hyp = {"lr0": lr0, "lrf": 0.01, "momentum": 0.9, "weight_decay": 5e-5,
           "warmup_epochs": 0.0, "warmup_bias_lr": 0.0, "warmup_momentum": 0.9}
    # batch_size=64 whatever the batch, as the JAX package builds it
    opt = Optimizer(dict(model.named_parameters()), hyp, epochs=epochs, steps_per_epoch=nb,
                    batch_size=64, name=optimizer, cos_lr=True)
    state = init_train_state(model, opt)

    cache = None
    if device_aug:
        need = len(train_ds) * imgsz * imgsz * 3
        if need <= device_memory_budget(dev):
            images, labels = build_cls_cache(train_ds)
            cache = {"images": torch.from_numpy(images).to(dev),
                     "labels": torch.from_numpy(labels).to(dev)}
            if verbose:
                print(f"device cache: {len(train_ds)} images ({need / 1e6:.0f} MB) resident "
                      f"on {dev}")
    step = make_classify_step(label_smoothing, amp, seed, device_aug=cache is not None)

    val_batches = None
    if val_ds:  # decoded once, kept on the device
        val_batches = [(torch.from_numpy(b["images"]).to(dev), b["labels"])
                       for b in val_ds.batches(batch_size)]
    best_top1, best_epoch = 0.0, -1
    last, best = save_dir / "last.ckpt", save_dir / "best.ckpt"
    for epoch in range(epochs):
        t0 = time.time()
        agg, n = None, 0
        if cache is not None:
            idx = np.random.default_rng(seed + epoch).permutation(len(train_ds))
            k = len(idx) // batch_size
            idx = torch.from_numpy(idx[:k * batch_size].reshape(k, batch_size)).to(dev)
            batches = ({"idx": i} for i in idx)
        else:
            batches = ({"images": torch.from_numpy(b["images"]).to(dev),
                        "labels": torch.from_numpy(b["labels"]).to(dev)}
                       for b in train_ds.batches(batch_size, shuffle=True, seed=seed,
                                                 epoch=epoch))
        for batch in batches:
            state, m = step(state, batch, cache)
            agg = m if agg is None else {k: agg[k] + m[k] for k in agg}
            n += 1
        agg = {k: float(v) for k, v in agg.items()} if agg else {"loss": 0.0, "acc": 0.0}
        row = {"train/loss": agg["loss"] / max(n, 1), "train/acc": agg["acc"] / max(n, 1),
               "train/imgs_per_sec": n * batch_size / (time.time() - t0)}
        if val_batches is not None:
            ema = fused_classifier({**state.ema.params, **state.ema.batch_stats}, cfg, nc,
                                   model.cutoff, dev)
            top1 = top5 = total = 0
            for images, labels in val_batches:
                rank = np.argsort(-classify_logits(ema, images).cpu().numpy(), axis=-1)
                top1 += int((rank[:, 0] == labels).sum())
                top5 += int((rank[:, :5] == labels[:, None]).any(1).sum())
                total += len(labels)
            row["val/top1"] = top1 / max(total, 1)
            row["val/top5"] = top5 / max(total, 1)
            if row["val/top1"] >= best_top1:
                best_top1, best_epoch = row["val/top1"], epoch
                if not nosave:
                    save_checkpoint(best, state, epoch, best_top1, extra={"imgsz": imgsz})
        loggers.log_metrics(row, epoch)
        if verbose:
            print(f"epoch {epoch + 1}/{epochs}  " +
                  "  ".join(f"{k.split('/')[-1]} {v:.4g}" for k, v in row.items()))
    if not nosave:
        save_checkpoint(last, state, epochs - 1, best_top1, extra={"imgsz": imgsz})
        if best_epoch < 0:  # no val split: best is last
            save_checkpoint(best, state, epochs - 1, best_top1, extra={"imgsz": imgsz})
    return best_top1, save_dir


def _val_root(data):
    """The ImageFolder root of ``data``: its val/ or test/ split if it has
    one with class folders, else ``data`` itself."""
    root = Path(data)
    for sub in ("val", "test", ""):
        cand = root / sub if sub else root
        if cand.is_dir() and any(d.is_dir() for d in cand.iterdir()):
            return cand
    return root


def validate_classify(weights, data, imgsz=None, batch_size=64, verbose=True, device="cuda"):
    """Top-1/top-5 accuracy and cross entropy of a checkpoint over an
    ImageFolder (reference classify/val.py), BN folded (K2 on the stem). The
    last batch is padded to ``batch_size`` with black images, which are not
    counted. Returns {"top1", "top5", "loss", "images", "per_class": {name:
    (n, top1, top5)}}."""
    model, names, meta = load_classifier(weights, device=device)
    names = names or {}
    dev = next(model.parameters()).device
    if imgsz is None:
        imgsz = int(meta.get("imgsz", 224))
    ds = ImageFolder(_val_root(data), img_size=imgsz)
    nc = len(ds.classes)
    n = len(ds)
    top1 = np.zeros(nc, np.int64)
    top5 = np.zeros(nc, np.int64)
    count = np.zeros(nc, np.int64)
    loss_sum = 0.0
    for b0 in range(0, n, batch_size):
        sel = list(range(b0, min(b0 + batch_size, n)))
        ims, labels = zip(*(ds.load(i) for i in sel))
        images = np.stack(ims)
        labels = np.array(labels, np.int64)
        if len(sel) < batch_size:
            pad = np.zeros((batch_size - len(sel), *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad])
        logits = classify_logits(model, torch.from_numpy(images).to(dev))[:len(sel)].cpu()
        loss_sum += float(F.cross_entropy(logits, torch.from_numpy(labels), reduction="sum"))
        rank = np.argsort(-logits.numpy(), axis=1)
        for lab, r in zip(labels, rank):
            count[lab] += 1
            top1[lab] += int(r[0] == lab)
            top5[lab] += int((r[:5] == lab).any())
    tot = max(int(count.sum()), 1)
    out = {
        "top1": float(top1.sum() / tot),
        "top5": float(top5.sum() / tot),
        "loss": loss_sum / tot,
        "images": int(count.sum()),
        "per_class": {(names.get(c) or ds.classes[c]): (int(count[c]),
                                                        float(top1[c] / max(count[c], 1)),
                                                        float(top5[c] / max(count[c], 1)))
                      for c in range(nc)},
    }
    if verbose:
        print(f"{'Class':>20s} {'Images':>7s} {'top1_acc':>9s} {'top5_acc':>9s}")
        print(f"{'all':>20s} {out['images']:7d} {out['top1']:9.3g} "
              f"{out['top5']:9.3g}   loss {out['loss']:.4g}")
        for cname, (cn, t1, t5) in out["per_class"].items():
            print(f"{cname:>20s} {cn:7d} {t1:9.3g} {t5:9.3g}")
    return out
