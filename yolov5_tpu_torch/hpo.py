"""Hyperparameter sweep CLI of the port: the counterpart of ``tools/hpo.py``
(the JAX package's, unchanged), the reference's Comet/ClearML HPO driver
analog (utils/loggers/comet/hpo.py, utils/loggers/clearml/hpo.py).

    python -m yolov5_tpu_torch.hpo --data data.yaml --sweep sweep.json --epochs 10
    python -m yolov5_tpu_torch.hpo ... --backend comet    # params from Comet Optimizer
    python -m yolov5_tpu_torch.hpo ... --backend clearml  # trials as ClearML Tasks
    python -m yolov5_tpu_torch.hpo --device cpu ...

The sweep config uses the Comet Optimizer schema (see
``yolov5_tpu/train/sweep_example.json``); with ``--backend local`` (the
default) a built-in random/grid sampler drives it, so sweeps run without a
network. Each trial is one ``train.run`` under ``<project>/<name>/trial<t>``;
the sweep writes ``hpo.csv`` (one row a trial) and ``hyp_hpo.yaml`` (the
best hyps) there and prints, last, one JSON line with the best objective
and its parameters.
"""

from __future__ import annotations

import argparse
import json


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.hpo")
    p.add_argument("--data", required=True, help="dataset yaml")
    p.add_argument("--sweep", required=True,
                   help="sweep config (Comet optimizer_config.json schema)")
    p.add_argument("--cfg", default="yolov5n", help="model config")
    p.add_argument("--hyp", default=None, help="base hyp preset/yaml")
    p.add_argument("--epochs", type=int, default=10,
                   help="epochs per trial (a sweep 'epochs' param overrides)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--imgsz", type=int, default=320)
    p.add_argument("--project", default="runs/hpo")
    p.add_argument("--name", default="exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=("local", "comet", "clearml"), default="local")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device-aug", action="store_true",
                   help="mosaic, geometry, HSV and flips on the device")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_opt(argv)
    from yolov5_tpu_torch.train.hpo import run_sweep

    best_params, best_obj = run_sweep(
        data=opt.data, sweep=opt.sweep, cfg=opt.cfg, hyp=opt.hyp, epochs=opt.epochs,
        batch_size=opt.batch_size, imgsz=opt.imgsz, save_dir=f"{opt.project}/{opt.name}",
        seed=opt.seed, backend=opt.backend,
        train_kwargs=dict(device=opt.device, dtype=opt.dtype, workers=opt.workers,
                          device_aug=opt.device_aug))
    print(f"best objective {best_obj:.4f} with {best_params}")
    print(json.dumps({"best_objective": best_obj, "best_params": best_params}))
    return best_params, best_obj


if __name__ == "__main__":
    main()
