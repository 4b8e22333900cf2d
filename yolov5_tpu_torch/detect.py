"""Detect CLI of the port (the root ``detect.py`` with ``--device``).

    python -m yolov5_tpu_torch.detect --weights best.ckpt --source images/
    python -m yolov5_tpu_torch.detect --device cpu --weights best.ckpt --source images/
    python -m yolov5_tpu_torch.detect --weights best.onnx --source images/

Writes annotated images (and with ``--save-txt`` / ``--save-csv`` /
``--save-crop`` labels, a CSV and crops) under ``--project/--name``.
``--device`` defaults to ``cuda`` and raises when no CUDA device is there.
Without OpenCV only 24-bit BMP images are read and written.
"""

from __future__ import annotations

import argparse


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.detect")
    p.add_argument("--weights", default="",
                   help=".ckpt or .pt weights, or an exported model (.onnx, "
                        "triton+http://host:port/model, the JAX package's TF exports); "
                        "default: seeded random weights")
    p.add_argument("--cfg", default="yolov5s", help="model config when weights lack meta")
    p.add_argument("--source", required=True, help="file/dir/glob/video")
    p.add_argument("--imgsz", "--img", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=1000)
    p.add_argument("--classes", nargs="+", type=int, default=None)
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--save-crop", action="store_true", help="save cropped detection boxes")
    p.add_argument("--save-csv", action="store_true", help="save predictions.csv")
    p.add_argument("--augment", action="store_true", help="TTA inference")
    p.add_argument("--data", default=None, help="dataset yaml for class names")
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--vid-stride", type=int, default=1, help="video frame-rate stride")
    p.add_argument("--view-img", action="store_true", help="show results (needs a display)")
    p.add_argument("--update", action="store_true", help="strip optimizer state from --weights")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--project", default="runs/detect")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--line-thickness", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--half", action="store_true", help="bfloat16 forward")
    p.add_argument("--dnn", action="store_true",
                   help="run .onnx weights via OpenCV DNN instead of the port's ONNX runtime "
                        "(raises ImportError where OpenCV is not installed)")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_opt(argv)
    from yolov5_tpu_torch.infer import run

    run(
        weights=opt.weights, source=opt.source, cfg=opt.cfg, imgsz=opt.imgsz,
        conf_thres=opt.conf_thres, iou_thres=opt.iou_thres, max_det=opt.max_det,
        classes=opt.classes, agnostic_nms=opt.agnostic_nms,
        save_txt=opt.save_txt, save_conf=opt.save_conf, save_img=not opt.nosave,
        project=opt.project, name=opt.name, exist_ok=opt.exist_ok,
        line_thickness=opt.line_thickness, batch_size=opt.batch_size,
        half=opt.half, augment=opt.augment, data=opt.data,
        hide_labels=opt.hide_labels, hide_conf=opt.hide_conf,
        save_crop=opt.save_crop, save_csv=opt.save_csv,
        vid_stride=opt.vid_stride, view_img=opt.view_img, dnn=opt.dnn,
        device=opt.device,
    )
    if opt.update:
        from yolov5_tpu_torch.utils.checkpoint import strip_optimizer

        strip_optimizer(opt.weights)


if __name__ == "__main__":
    main()
