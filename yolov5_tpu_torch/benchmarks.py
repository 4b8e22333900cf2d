"""Benchmark every export format of the port, with optional mAP floors: the
port's counterpart of the root ``benchmarks.py`` (the JAX package's,
unchanged; the reference benchmarks.py:51-210).

    python -m yolov5_tpu_torch.benchmarks --weights best.ckpt --imgsz 640
    python -m yolov5_tpu_torch.benchmarks --data data.yaml --hard-fail 0.1
    python -m yolov5_tpu_torch.benchmarks --device cpu --cfg yolov5n --imgsz 64

For each format that ``export.export_formats()`` marks available (ckpt, pt2,
onnx, and saved_model, pb and tflite where TensorFlow is installed) it
exports ``--weights`` (seeded random ``--cfg`` weights when none are given)
at batch 1, checks the file's decoded predictions against the native
``Detector.forward`` on one seeded uint8 image (``fp_gate``: largest
difference under 3 and correlation above 0.99), and times it on
``--device`` (CUDA events on the card, ``utils/profile.chain_time``; the
TensorFlow files run on the host, so their time includes the copies). The
``.onnx`` runs through the port's runtime and through OpenCV's DNN module
where OpenCV has one. An int8 TFLite file (calibrated on ``--data``'s train
images where given) is held to the objectness correlation above 0.9, as
the JAX package's benchmarks.py holds it: its quantized boxes are coarse by
design. The other formats are listed as unavailable, with the reason. With ``--data`` every file that ``Detector`` opens is
validated at b1 and the native model at b32; ``--hard-fail`` then asserts
the mAP50-95 floor and every parity gate. Prints the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# the largest difference an exported file's predictions may show against the
# native forward: f32 convolutions of other algorithms (TF32, FFT) drift by
# a fraction of a pixel; a graph bug decorrelates the outputs instead
MAX_ABS_DIFF = 3.0
MIN_CORR = 0.99


def fp_gate(out, ref):
    """(ok, largest difference, correlation) of ``out`` against ``ref``, both
    numpy arrays: the root ``benchmarks.py``'s parity gate."""
    if out.shape != ref.shape:
        return False, -1.0, -1.0
    diff = float(np.abs(out - ref).max())
    corr = float(np.corrcoef(out.ravel(), ref.ravel())[0, 1])
    return diff < MAX_ABS_DIFF and corr > MIN_CORR, diff, corr


def load_pt2(path, device):
    """A ``.pt2`` program as a callable module on ``device`` for inference:
    loaded with ``torch.export.load`` alone (nothing of this package), its
    constants moved to the device by ``torch.export.passes.move_to_device_pass``."""
    program = torch.export.load(str(path))
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program.module().requires_grad_(False)


def _row(fmt, fn, images, ref):
    """A format's row: its gate against ``ref`` and its ms per call."""
    from yolov5_tpu_torch.utils.profile import chain_time

    with torch.inference_mode():
        out = fn(images)
    ok, diff, corr = fp_gate(out.float().cpu().numpy(), ref)
    ms = chain_time(fn, (images,), k=5) * 1e3
    return {"format": fmt, "ok": ok, "ms": ms, "max_abs_diff": diff, "corr": corr}


# the row names of the TensorFlow files (the JAX package's benchmarks.py)
TF_ROWS = {"saved_model": "saved_model", "pb": "pb (frozen graph)", "tflite": "tflite"}
MIN_INT8_OBJ_CORR = 0.9


def _int8_row(fn, images, ref):
    """``tflite-int8``: ok where the objectness correlates with ``ref``."""
    from yolov5_tpu_torch.utils.profile import chain_time

    with torch.inference_mode():
        out = fn(images).float().cpu().numpy()
    ok, diff, corr = fp_gate(out, ref)
    obj_corr = (float(np.corrcoef(out[..., 4].ravel(), ref[..., 4].ravel())[0, 1])
                if out.shape == ref.shape else -1.0)
    ms = chain_time(fn, (images,), k=5) * 1e3
    return {"format": "tflite-int8", "ok": obj_corr > MIN_INT8_OBJ_CORR, "ms": ms,
            "max_abs_diff": diff, "corr": corr, "obj_corr": obj_corr}


def _cv2_row(onnx_path, images_np, ref):
    """``onnx (cv2.dnn)``: OpenCV's DNN module on the host, or a row that
    says why it is unavailable."""
    try:
        import cv2

        net = cv2.dnn.readNetFromONNX(str(onnx_path))
        net.setInput(images_np)
        t0 = time.perf_counter()
        out = net.forward().astype(np.float32)
        ms = (time.perf_counter() - t0) * 1e3
    except Exception as e:  # an optional backend: report and go on
        return {"format": "onnx (cv2.dnn)", "ok": False, "note": f"unavailable: {e}"}
    ok, diff, corr = fp_gate(out, ref)
    return {"format": "onnx (cv2.dnn)", "ok": ok, "ms": ms, "max_abs_diff": diff, "corr": corr}


def run(weights="", cfg="yolov5n", imgsz=320, data=None, hard_fail=None,
        output_dir="runs/benchmarks", device="cuda"):
    """Export, check and time every available format; validate with
    ``data``. Returns the rows; with ``hard_fail`` a format below the mAP
    floor or a failed parity gate raises AssertionError."""
    from yolov5_tpu_torch.export import export_formats
    from yolov5_tpu_torch.export import run as export_run
    from yolov5_tpu_torch.infer import Detector, resolve_device

    dev = resolve_device(device, "benchmarks")
    det = Detector(weights or None, cfg=cfg, imgsz=imgsz, device=dev)
    images_np = np.random.default_rng(0).integers(0, 255, (1, imgsz, imgsz, 3), dtype=np.uint8)
    images = torch.from_numpy(images_np).to(dev)
    with torch.inference_mode():
        ref = det.forward(images).cpu().numpy()

    table = export_formats()
    arts = export_run(weights=weights, cfg=cfg, imgsz=imgsz,
                      include=tuple(n for n, _, ok, _ in table if ok),
                      output_dir=output_dir, device=dev)
    rows = [dict(_row("torch (native)", det.forward, images, ref), max_abs_diff=0.0)]
    if arts.get("ckpt"):
        rows.append(_row("ckpt (fused)", Detector(str(arts["ckpt"]), imgsz=imgsz,
                                                  device=dev).forward, images, ref))
    if arts.get("pt2"):
        rows.append(_row("pt2", load_pt2(arts["pt2"], dev), images, ref))
    if arts.get("onnx"):
        rows.append(_row("onnx (port runtime)", Detector(str(arts["onnx"]),
                                                         device=dev).forward, images, ref))
        rows.append(_cv2_row(arts["onnx"], images_np, ref))
    for fmt, row_name in TF_ROWS.items():
        if arts.get(fmt):
            rows.append(_row(row_name, Detector(str(arts[fmt]), device=dev).forward, images,
                             ref))
    if arts.get("tflite"):
        int8 = export_run(weights=weights, cfg=cfg, imgsz=imgsz, include=("tflite",),
                          int8=True, data=data, output_dir=output_dir, device=dev)
        if int8.get("tflite"):
            rows.append(_int8_row(Detector(str(int8["tflite"]), device=dev).forward, images,
                                  ref))
    rows += [{"format": n, "ok": False, "note": f"unavailable: {note}"}
             for n, _, ok, note in table if not ok]

    floor_failures = []
    if data:
        from yolov5_tpu_torch.eval.evaluator import run as val_run

        # every file that Detector opens, at b1 (an exported graph's batch),
        # and the native model at b32, against one absolute mAP floor
        # (reference benchmarks.py:139-142, ci-testing.yml:41-44)
        targets = {"native": None, **{k: str(arts[k]) for k in ("ckpt", "onnx")
                                      if arts.get(k)}}
        for fmt, w in targets.items():
            r = val_run(data=data, weights=(weights or None) if w is None else w, cfg=cfg,
                        imgsz=imgsz, batch_size=32 if w is None else 1, verbose=False,
                        device=dev)
            ok = hard_fail is None or r["map"] > hard_fail
            rows.append({"format": f"val ({fmt})", "ok": ok, "map50_95": r["map"],
                         "map50": r["map50"]})
            if not ok:
                floor_failures.append((fmt, r["map"]))

    print(json.dumps(rows, indent=1))
    if hard_fail is not None:
        assert not floor_failures, (
            f"formats below the mAP floor {hard_fail}: {floor_failures}")
        # parity gates are hard failures too, but for backends that reported
        # themselves unavailable rather than wrong
        parity_bad = [r["format"] for r in rows
                      if not r.get("ok") and "unavailable" not in str(r.get("note", ""))]
        assert not parity_bad, f"format parity gates failed: {parity_bad}"
        n_val = sum(1 for r in rows if r["format"].startswith("val ("))
        print(f"mAP floor {hard_fail} passed for all {n_val} validated formats")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.benchmarks")
    p.add_argument("--weights", default="", help=".ckpt or .pt (else seeded random --cfg)")
    p.add_argument("--cfg", default="yolov5n")
    p.add_argument("--imgsz", type=int, default=320)
    p.add_argument("--data", default=None, help="dataset yaml for the mAP check")
    p.add_argument("--hard-fail", type=float, default=None, help="min mAP50-95")
    p.add_argument("--output-dir", default="runs/benchmarks")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    opt = p.parse_args(argv)
    return run(**vars(opt))


if __name__ == "__main__":
    main()
