"""Segmentation CLI of the port (the root ``segment.py`` with ``--device``).

    python -m yolov5_tpu_torch.segment train --data shapes-seg.yaml --cfg yolov5s-seg \\
        --imgsz 640 --batch-size 16
    python -m yolov5_tpu_torch.segment val --data shapes-seg.yaml \\
        --weights runs/train-seg/exp/best.ckpt --save-json seg.json
    python -m yolov5_tpu_torch.segment predict --weights best.ckpt --source images/

``train`` (``train/run_segment.run``) writes ``results.csv``, ``last.ckpt``
and ``best.ckpt`` under ``--project/--name`` and prints, last, one JSON
line: best fitness, the last validation's box and mask metrics and the run
directory; by default the host augments, ``--device-aug`` moves the
mosaic, HSV, flips and the GT masks to the device. ``val`` scores a
checkpoint's box and mask mAP (``evaluate_segment``) and prints its JSON
line; ``--save-json`` also writes the COCO segm rows and scores them in
both COCO modes, bbox and segm. ``predict`` writes the images with mask
overlays and boxes (and with ``--save-txt`` one polygon per instance).
``--device`` defaults to ``cuda`` and raises when no CUDA device is there.
``--noplots`` is accepted; no plots are written.
"""

from __future__ import annotations

import argparse
import json


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.segment")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--data", default="",
                   help="dataset yaml (optional with --resume: the saved opt.yaml supplies it)")
    t.add_argument("--cfg", default="yolov5n-seg")
    t.add_argument("--hyp", default=None)
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--imgsz", "--img", type=int, default=640)
    t.add_argument("--optimizer", default="sgd")
    t.add_argument("--cos-lr", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--workers", type=int, default=8)
    t.add_argument("--single-cls", action="store_true")
    t.add_argument("--mask-ratio", type=int, default=4)
    t.add_argument("--seg-k", type=int, default=256,
                   help="per-level mask-loss candidate capacity; overflow is counted and "
                        "warned, raise it if crowded images overflow")
    t.add_argument("--no-overlap", action="store_true")
    t.add_argument("--project", default="runs/train-seg")
    t.add_argument("--name", default="exp")
    t.add_argument("--exist-ok", action="store_true")
    t.add_argument("--noval", action="store_true")
    t.add_argument("--nosave", action="store_true")
    t.add_argument("--device-aug", action="store_true",
                   help="device-resident set + mosaic, HSV, flips and GT masks on the device")
    t.add_argument("--cache", default=None, choices=["ram", "disk", "device"])
    t.add_argument("--weights", default="", help="initial weights: .ckpt or reference .pt")
    t.add_argument("--resume", nargs="?", const=True, default="",
                   help="resume the most recent (or the given) run; its saved opt.yaml "
                        "overrides the other flags")
    t.add_argument("--patience", type=int, default=100)
    t.add_argument("--freeze", type=int, default=0, help="freeze the first N layers")
    t.add_argument("--label-smoothing", type=float, default=0.0)
    t.add_argument("--save-period", type=int, default=-1)
    t.add_argument("--noautoanchor", action="store_true")
    t.add_argument("--multi-scale", action="store_true",
                   help="a stride-aligned 0.5-1.5x size per batch")
    t.add_argument("--noplots", action="store_true", help="no plots (none are written)")
    t.add_argument("--sync-bn", action="store_true", help="no-op on one device")
    t.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="forward under bf16 autocast (float32 master weights) or in float32")
    t.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")

    v = sub.add_parser("val")
    v.add_argument("--data", required=True)
    v.add_argument("--weights", required=True, help=".ckpt or .pt weights")
    v.add_argument("--cfg", default="yolov5n-seg", help="model config when weights lack meta")
    v.add_argument("--imgsz", "--img", type=int, default=640)
    v.add_argument("--batch-size", type=int, default=16)
    v.add_argument("--workers", type=int, default=8)
    v.add_argument("--mask-ratio", type=int, default=4)
    v.add_argument("--no-overlap", action="store_true")
    v.add_argument("--half", action="store_true", help="bfloat16 model")
    v.add_argument("--save-json", default=None,
                   help="write COCO segm rows (bbox + RLE masks) and score them bbox and "
                        "segm against the dataset's labels")
    v.add_argument("--coco91", action="store_true",
                   help="remap class ids to the 91-id COCO annotation space")
    v.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")

    d = sub.add_parser("predict")
    d.add_argument("--weights", required=True, help=".ckpt or .pt weights")
    d.add_argument("--source", required=True)
    d.add_argument("--cfg", default="yolov5n-seg", help="model config when weights lack meta")
    d.add_argument("--imgsz", "--img", type=int, default=640)
    d.add_argument("--conf-thres", type=float, default=0.25)
    d.add_argument("--iou-thres", type=float, default=0.45)
    d.add_argument("--save-txt", action="store_true", help="one polygon txt per image")
    d.add_argument("--project", default="runs/predict-seg")
    d.add_argument("--name", default="exp")
    d.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    opt = p.parse_args(argv)
    if opt.cmd == "train" and not opt.data and not opt.resume:
        p.error("--data is required unless --resume is given")
    return opt


def train(opt):
    from yolov5_tpu_torch.train.run_segment import run

    best_fitness, results, save_dir = run(
        data=opt.data, cfg=opt.cfg, hyp=opt.hyp, epochs=opt.epochs, batch_size=opt.batch_size,
        imgsz=opt.imgsz, optimizer=opt.optimizer, cos_lr=opt.cos_lr, seed=opt.seed,
        workers=opt.workers, single_cls=opt.single_cls, mask_ratio=opt.mask_ratio,
        seg_k=opt.seg_k, no_overlap=opt.no_overlap, project=opt.project, name=opt.name,
        exist_ok=opt.exist_ok, noval=opt.noval, nosave=opt.nosave, device_aug=opt.device_aug,
        cache=opt.cache, weights=opt.weights, resume=opt.resume, patience=opt.patience,
        freeze=opt.freeze or None, label_smoothing=opt.label_smoothing,
        save_period=opt.save_period, noautoanchor=opt.noautoanchor, noplots=opt.noplots,
        sync_bn=opt.sync_bn, multi_scale=opt.multi_scale, dtype=opt.dtype, device=opt.device)
    out = {"best_fitness": best_fitness, "save_dir": str(save_dir),
           **{k: results[k] for k in ("box", "mask", "fitness") if k in results}}
    print(json.dumps(out))
    return out


def val(opt):
    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.eval.coco import (gt_from_dataset, gt_from_dataset_segm,
                                            score_detections_json)
    from yolov5_tpu_torch.infer_segment import Segmenter
    from yolov5_tpu_torch.train.run_segment import evaluate_segment
    from yolov5_tpu_torch.utils.general import check_dataset, check_img_size

    data = check_dataset(opt.data)
    seg = Segmenter(opt.weights, cfg=opt.cfg, device=opt.device, half=opt.half)
    imgsz = check_img_size(opt.imgsz, s=max(seg.stride))
    _, loader = create_loader(data["val"], img_size=imgsz, batch_size=opt.batch_size,
                              workers=opt.workers, masks=True, mask_ratio=opt.mask_ratio,
                              overlap=not opt.no_overlap)
    out = evaluate_segment(seg.forward, loader, seg.device, seg.nc,
                           overlap=not opt.no_overlap, verbose=True, save_json=opt.save_json,
                           coco91=opt.coco91)
    if opt.save_json:
        # both COCO modes on the written rows (reference segment/val.py:366-382)
        out["coco_bbox"] = score_detections_json(
            opt.save_json, gt_from_dataset(loader.ds, coco91=opt.coco91), iou_type="bbox")
        out["coco_segm"] = score_detections_json(
            opt.save_json, gt_from_dataset_segm(loader.ds, coco91=opt.coco91), iou_type="segm")
        sb, ss = out["coco_bbox"], out["coco_segm"]
        print(f"COCO bbox: mAP {sb['map']:.4f} mAP50 {sb['map50']:.4f} | "
              f"COCO segm: mAP {ss['map']:.4f} mAP50 {ss['map50']:.4f}")
    print(json.dumps(out))
    return out


def predict(opt):
    from yolov5_tpu_torch.infer_segment import run

    return run(weights=opt.weights, source=opt.source, cfg=opt.cfg, imgsz=opt.imgsz,
               conf_thres=opt.conf_thres, iou_thres=opt.iou_thres, save_txt=opt.save_txt,
               project=opt.project, name=opt.name, device=opt.device)


def main(argv=None):
    opt = parse_opt(argv)
    return {"train": train, "val": val, "predict": predict}[opt.cmd](opt)


if __name__ == "__main__":
    main()
