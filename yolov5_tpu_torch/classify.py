"""Classification CLI of the port (the root ``classify.py`` with ``--device``).

    python -m yolov5_tpu_torch.classify train --data imagenet10 --cfg yolov5s --epochs 10
    python -m yolov5_tpu_torch.classify val --data imagenet10 --weights runs/train-cls/exp/best.ckpt
    python -m yolov5_tpu_torch.classify predict --weights best.ckpt --source images/

``train`` (``train/run_classify.run``) writes ``results.csv``, ``last.ckpt``
and ``best.ckpt`` under ``--project/--name`` and prints, last, one JSON line
with the best top-1 and the run directory; the decoded set lives in device
memory and is augmented there unless ``--no-device-aug``. ``val``
(``validate_classify``) prints the per-class table and then its result as
one JSON line. ``predict`` letterboxes each image to ``--imgsz`` and prints
its path and top-5 classes with their softmax probabilities. Every model is
BN folded for inference, so the stem runs K2 on CUDA. ``--device`` defaults
to ``cuda`` and raises when no CUDA device is there.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.classify")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--data", required=True, help="ImageFolder root with train/[val]")
    t.add_argument("--model", "--cfg", dest="cfg", default="yolov5s")
    t.add_argument("--epochs", type=int, default=10)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--imgsz", "--img", type=int, default=224)
    t.add_argument("--lr0", type=float, default=0.001)
    t.add_argument("--optimizer", default="adam")
    t.add_argument("--label-smoothing", type=float, default=0.1)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--project", default="runs/train-cls")
    t.add_argument("--name", default="exp")
    t.add_argument("--exist-ok", action="store_true")
    t.add_argument("--no-device-aug", action="store_true",
                   help="the host ImageFolder loop instead of the device-resident set")
    t.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")

    v = sub.add_parser("val")
    v.add_argument("--data", required=True,
                   help="ImageFolder root (val/ or test/ subdir, or itself)")
    v.add_argument("--weights", required=True)
    v.add_argument("--imgsz", "--img", type=int, default=None,
                   help="default: the checkpoint's training size")
    v.add_argument("--batch-size", type=int, default=64)
    v.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")

    d = sub.add_parser("predict")
    d.add_argument("--weights", required=True)
    d.add_argument("--source", required=True)
    d.add_argument("--imgsz", "--img", type=int, default=224)
    d.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p.parse_args(argv)


def train(opt):
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("classify train: several processes (WORLD_SIZE > 1) need the "
                                  "multi-GPU port (ROADMAP Open items 1, item 6)")
    from yolov5_tpu_torch.train.run_classify import run

    best_top1, save_dir = run(
        data=opt.data, cfg=opt.cfg, epochs=opt.epochs, batch_size=opt.batch_size,
        imgsz=opt.imgsz, lr0=opt.lr0, optimizer=opt.optimizer,
        label_smoothing=opt.label_smoothing, seed=opt.seed, project=opt.project, name=opt.name,
        exist_ok=opt.exist_ok, device_aug=not opt.no_device_aug, device=opt.device)
    out = {"best_top1": best_top1, "save_dir": str(save_dir)}
    print(json.dumps(out))
    return out


def val(opt):
    from yolov5_tpu_torch.train.run_classify import validate_classify

    out = validate_classify(opt.weights, opt.data, imgsz=opt.imgsz, batch_size=opt.batch_size,
                            verbose=True, device=opt.device)
    print(json.dumps(out))
    return out


def predict(opt):
    """Top-5 classes of each image: a list of (path, [(class, probability)])."""
    import numpy as np
    import torch

    from yolov5_tpu_torch.data.sources import LoadImages
    from yolov5_tpu_torch.train.run_classify import classify_logits, load_classifier

    model, names, _ = load_classifier(opt.weights, device=opt.device)
    names = names or {}
    dev = next(model.parameters()).device
    out = []
    for path, im, _, _ in LoadImages(opt.source, img_size=opt.imgsz):
        logits = classify_logits(model, torch.from_numpy(im[None]).to(dev)).cpu().numpy()
        prob = np.exp(logits - logits.max()) / np.exp(logits - logits.max()).sum()
        top5 = np.argsort(-prob[0])[:5]
        out.append((path, [(names.get(int(i), int(i)), float(prob[0, i])) for i in top5]))
        print(path, " ".join(f"{c} {p:.2f}" for c, p in out[-1][1]))
    return out


def main(argv=None):
    opt = parse_opt(argv)
    return {"train": train, "val": val, "predict": predict}[opt.cmd](opt)


if __name__ == "__main__":
    main()
