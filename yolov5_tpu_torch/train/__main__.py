"""Detection training CLI of the port (the root ``train.py`` with ``--device``),
the ``__main__`` of the ``train`` package.

    python -m yolov5_tpu_torch.train --data shapes.yaml --cfg yolov5s --imgsz 640 \\
        --batch-size 32
    python -m yolov5_tpu_torch.train --device cpu --data shapes.yaml --cfg yolov5n \\
        --imgsz 128 --batch-size 4 --epochs 2 --dtype float32

By default the host augments (mosaic, copy-paste, mixup, geometry, HSV and
flips in worker processes); ``--device-aug`` moves it to the device.
Writes ``results.csv``, ``last.ckpt`` and ``best.ckpt`` (the JAX package's
checkpoint format) under ``<project>/<name>``, and prints, last, one JSON
line: best fitness, the last validation's metrics and the run directory.
``--evolve N`` instead runs N generations of hyperparameter evolution under
``runs/evolve/<name>`` (``evolve.csv``, ``hyp_evolve.yaml``) and prints the
best hyps and fitness. ``--device`` defaults to ``cuda`` and raises when no
CUDA device is there. ``--upload-dataset`` (cloud loggers) raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.train")
    p.add_argument("--weights", default="", help="initial weights (.ckpt or torch .pt)")
    p.add_argument("--cfg", default="yolov5n", help="model config name/path")
    p.add_argument("--data", default="",
                   help="dataset yaml (optional with --resume: the saved opt.yaml supplies it)")
    p.add_argument("--hyp", default=None, help="hyp preset name or yaml")
    p.add_argument("--label-smoothing", type=float, default=0.0, help="cls BCE eps")
    p.add_argument("--noplots", action="store_true", help="no plots (none are written yet)")
    p.add_argument("--rect", action="store_true",
                   help="rectangular training (no mosaic, no shuffle)")
    p.add_argument("--sync-bn", action="store_true", help="no-op on one device")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--imgsz", "--img", type=int, default=640)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam", "adamw"])
    p.add_argument("--cos-lr", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--project", default="runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--noval", action="store_true")
    p.add_argument("--save-period", type=int, default=-1)
    p.add_argument("--resume", nargs="?", const=True, default="",
                   help="resume the most recent (or the given) run from its last.ckpt; "
                        "the run's saved opt.yaml overrides other train flags")
    p.add_argument("--upload-dataset", action="store_true", help="cloud loggers (not ported)")
    p.add_argument("--max-labels", type=int, default=None,
                   help="fixed label capacity per image (default: auto from dataset)")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="bfloat16: autocast with float32 master weights")
    p.add_argument("--evolve", type=int, nargs="?", const=30, default=0,
                   help="evolve hyperparameters for N generations")
    p.add_argument("--freeze", type=int, default=0, help="freeze first N layers")
    p.add_argument("--multi-scale", action="store_true",
                   help="a stride-aligned size in 0.5-1.5x imgsz per batch")
    p.add_argument("--image-weights", action="store_true",
                   help="draw images by the AP of their classes, from the second epoch")
    p.add_argument("--cache", default=None, choices=[None, "ram", "disk", "device", "none"],
                   help="image cache: auto (default: on the device when it fits), ram, disk, "
                        "device, or none")
    p.add_argument("--noautoanchor", action="store_true")
    p.add_argument("--quad", action="store_true",
                   help="quad batches: every 4 samples -> one 2x-size image")
    p.add_argument("--device-aug", action="store_true",
                   help="mosaic, geometry, HSV and flips on the device")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_opt(argv)
    if not opt.data and not opt.resume:
        raise SystemExit("error: --data is required unless --resume is given")
    if opt.evolve:
        from yolov5_tpu_torch.train.evolve import run_evolve

        best_hyp, best_fitness = run_evolve(
            data=opt.data, cfg=opt.cfg, hyp=opt.hyp, generations=opt.evolve,
            epochs=opt.epochs, batch_size=opt.batch_size, imgsz=opt.imgsz,
            save_dir=f"{opt.project.replace('train', 'evolve')}/{opt.name}", seed=opt.seed,
            train_kwargs=dict(device=opt.device, dtype=opt.dtype, workers=opt.workers,
                              device_aug=opt.device_aug))
        print(json.dumps({"best_fitness": best_fitness, "hyp": best_hyp}))
        return
    from yolov5_tpu_torch.train.run import run

    best_fitness, results, save_dir = run(
        data=opt.data, cfg=opt.cfg, hyp=opt.hyp, weights=opt.weights,
        label_smoothing=opt.label_smoothing, noplots=opt.noplots, rect=opt.rect,
        sync_bn=opt.sync_bn, epochs=opt.epochs, batch_size=opt.batch_size, imgsz=opt.imgsz,
        optimizer=opt.optimizer, cos_lr=opt.cos_lr, seed=opt.seed, workers=opt.workers,
        single_cls=opt.single_cls, patience=opt.patience, project=opt.project, name=opt.name,
        exist_ok=opt.exist_ok, nosave=opt.nosave, noval=opt.noval,
        save_period=opt.save_period, resume=opt.resume, max_labels=opt.max_labels,
        dtype=opt.dtype, freeze=opt.freeze or None, multi_scale=opt.multi_scale,
        image_weights=opt.image_weights, cache=False if opt.cache == "none" else opt.cache,
        noautoanchor=opt.noautoanchor, device_aug=opt.device_aug, quad=opt.quad,
        upload_dataset=opt.upload_dataset, device=opt.device)
    summary = {"best_fitness": best_fitness, "save_dir": str(save_dir)}
    summary.update({k: v for k, v in results.items() if k in ("mp", "mr", "map50", "map",
                                                               "fitness", "images")})
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
