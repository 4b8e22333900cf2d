"""Validation CLI of the port (the root ``val.py`` with ``--device``).

    python -m yolov5_tpu_torch.val --data shapes.yaml --weights best.ckpt
    python -m yolov5_tpu_torch.val --device cpu --data shapes.yaml --weights best.ckpt

Prints the per-class table and, last, one JSON line of the results (as the
root ``val.py`` does). ``--device`` defaults to ``cuda`` and raises when no
CUDA device is there.
"""

from __future__ import annotations

import argparse
import json


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.val")
    p.add_argument("--data", required=True)
    p.add_argument("--weights", default=None,
                   help=".ckpt or .pt weights (default: seeded random weights)")
    p.add_argument("--cfg", default="yolov5s")
    p.add_argument("--imgsz", "--img", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--task", default="val",
                   choices=["train", "val", "test", "speed", "study"],
                   help="split to evaluate, or the reference benchmark "
                        "protocols (val.py:450,474-528): speed = b1 conf "
                        "0.25 iou 0.45 latency run; study = mAP-vs-latency "
                        "sweep over imgsz 256..1536 step 128")
    p.add_argument("--study-imgsz", type=int, nargs=3, default=(256, 1536, 128),
                   metavar=("LO", "HI", "STEP"),
                   help="--task study sweep range (reference: 256 1536 128)")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--half", action="store_true", help="bfloat16 forward")
    p.add_argument("--save-json", default=None, help="write COCO-format detections json")
    p.add_argument("--augment", action="store_true", help="TTA validation")
    p.add_argument("--save-txt", action="store_true", help="per-image label txts")
    p.add_argument("--save-conf", action="store_true", help="append confidence in --save-txt")
    p.add_argument("--save-hybrid", action="store_true",
                   help="inject GT boxes as unit-confidence NMS candidates (autolabelling)")
    p.add_argument("--verbose", action=argparse.BooleanOptionalAction, default=True,
                   help="print per-class AP table")
    p.add_argument("--project", default="runs/val")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--rect", action=argparse.BooleanOptionalAction, default=True,
                   help="aspect-ratio-sorted batches, pad 0.5 — the reference "
                        "protocol (--no-rect for square letterbox)")
    p.add_argument("--native-space", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="match predictions in original image coordinates "
                        "(reference val.py behavior); --no-native-space "
                        "matches in letterbox space")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_opt(argv)
    from yolov5_tpu_torch.eval.evaluator import run, run_speed, run_study

    common = dict(
        data=opt.data, weights=opt.weights, cfg=opt.cfg,
        max_det=opt.max_det, single_cls=opt.single_cls, workers=opt.workers,
        half=opt.half, rect=opt.rect, native_space=opt.native_space,
        verbose=opt.verbose, device=opt.device,
    )
    if opt.task == "speed":
        results = run_speed(batch_size=opt.batch_size, imgsz=opt.imgsz, **common)
    elif opt.task == "study":
        results = run_study(imgsz_range=tuple(opt.study_imgsz),
                            batch_size=opt.batch_size,
                            conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
                            project=opt.project, name=opt.name, **common)
        results = results[-1]  # print the largest-size row below
    else:
        results = run(
            imgsz=opt.imgsz, batch_size=opt.batch_size,
            conf_thres=opt.conf_thres, iou_thres=opt.iou_thres, task=opt.task,
            save_json=opt.save_json, augment=opt.augment,
            save_txt=opt.save_txt, save_conf=opt.save_conf,
            save_hybrid=opt.save_hybrid, project=opt.project, name=opt.name,
            exist_ok=opt.exist_ok, **common,
        )
    print(json.dumps({k: v for k, v in results.items() if k != "per_class"}))


if __name__ == "__main__":
    main()
