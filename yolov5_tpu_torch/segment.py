"""Segmentation CLI of the port (the root ``segment.py`` with ``--device``).

    python -m yolov5_tpu_torch.segment predict --weights best.ckpt --source images/
    python -m yolov5_tpu_torch.segment predict --device cpu --weights best.ckpt --source images/

``predict`` writes the images with mask overlays and boxes (and with
``--save-txt`` one polygon per instance) under ``--project/--name``.
``--device`` defaults to ``cuda`` and raises when no CUDA device is there.
``train`` and ``val`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.segment")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("train", help="not ported yet")
    sub.add_parser("val", help="not ported yet")
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
    opt, rest = p.parse_known_args(argv)
    if opt.cmd in ("train", "val"):
        raise NotImplementedError(
            f"segment {opt.cmd}: segmentation training and validation are not ported yet "
            "(ROADMAP Open items 1, item 7)")
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return opt


def main(argv=None):
    opt = parse_opt(argv)
    from yolov5_tpu_torch.infer_segment import run

    run(weights=opt.weights, source=opt.source, cfg=opt.cfg, imgsz=opt.imgsz,
        conf_thres=opt.conf_thres, iou_thres=opt.iou_thres, save_txt=opt.save_txt,
        project=opt.project, name=opt.name, device=opt.device)


if __name__ == "__main__":
    main()
