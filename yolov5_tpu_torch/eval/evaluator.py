"""Validation loop: device forward + decode + NMS, host matching + AP.

The port of ``yolov5_tpu/eval/evaluator.py`` (reference val.py:112-393). Per
batch, the decoded predictions go through multi-label NMS at the
30 720-candidate cap (kernel K1 on CUDA, the stem K2 in the forward); the
matching and AP stay in numpy. Predictions and labels are compared in
ORIGINAL image coordinates by default (the reference's native-space
protocol, val.py:282-310); ``native_space=False`` matches in letterbox space.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from yolov5_tpu_torch.eval.coco import COCO80_TO_COCO91, gt_from_dataset, score_detections_json
from yolov5_tpu_torch.eval.metrics import ap_per_class, fitness, process_batch
from yolov5_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression
from yolov5_tpu_torch.utils.profile import recording, span


def _scale_to_native(boxes, lb_hw, native_hw):
    """letterbox-space xyxy -> native-space xyxy (numpy)."""
    gain = min(lb_hw[0] / native_hw[0], lb_hw[1] / native_hw[1])
    pad_x = (lb_hw[1] - native_hw[1] * gain) / 2
    pad_y = (lb_hw[0] - native_hw[0] * gain) / 2
    out = boxes.copy()
    out[:, [0, 2]] = ((boxes[:, [0, 2]] - pad_x) / gain).clip(0, native_hw[1])
    out[:, [1, 3]] = ((boxes[:, [1, 3]] - pad_y) / gain).clip(0, native_hw[0])
    return out


def _xywhn_to_xyxy(lab, w, h):
    """(n, 5) [cls, x, y, w, h] normalized -> (n, 5) [cls, x1, y1, x2, y2] px."""
    if not len(lab):
        return np.zeros((0, 5), np.float32)
    xyxy = np.empty((len(lab), 4), np.float32)
    xyxy[:, 0] = (lab[:, 1] - lab[:, 3] / 2) * w
    xyxy[:, 1] = (lab[:, 2] - lab[:, 4] / 2) * h
    xyxy[:, 2] = (lab[:, 1] + lab[:, 3] / 2) * w
    xyxy[:, 3] = (lab[:, 2] + lab[:, 4] / 2) * h
    return np.concatenate([lab[:, 0:1].astype(np.float32), xyxy], 1)


@torch.inference_mode()
def evaluate(forward, loader, device, conf_thres=0.001, iou_thres=0.6,
             max_det=300, max_nms=30720, multi_label=True, verbose=False,
             save_json=None, coco91=False, native_space=True, save_txt_dir=None,
             save_conf=False, save_hybrid=False, names=None):
    """Returns a dict: mp, mr, map50, map, fitness, per-class ap, speeds.

    forward: (bs, h, w, 3) uint8 tensor on ``device`` -> decoded predictions
    (bs, N, 5 + nc) float32 (``Detector.forward``, ``Detector.forward_tta``,
    ``Ensemble.forward``).
    save_json: path to write COCO-format detections (xywh top-left, native
    image space; image_id from the filename stem like the reference
    save_one_json, val.py:65-108), then scored by ``eval.coco``. coco91
    remaps class ids to annotation ids.
    native_space (default True, matching the reference): match predictions
    against labels in ORIGINAL image coordinates; False matches in letterbox
    space (a similarity transform: the two differ only by boundary clipping).
    save_hybrid: inject the labels as unit-confidence candidates before NMS
    (the reference's autolabelling path, val.py lb=).
    speed_ms: ms per image of forward (from the batch on the device to the
    decoded predictions), NMS (with the copy of the detections to the host)
    and host matching, read from the pass's spans (``val.forward`` and
    ``val.nms`` on the device's clock, ``val.match`` on the host's); the
    first batch, which builds the kernels, is left out when there are more.
    The pass's one synchronization is that copy.
    """
    device = torch.device(device)
    json_rows = []
    shapes = loader.ds.shapes
    if save_txt_dir is not None:
        save_txt_dir = Path(save_txt_dir)
        save_txt_dir.mkdir(parents=True, exist_ok=True)
    iouv = np.linspace(0.5, 0.95, 10)

    stats = []
    n_images = 0
    with recording() as spans:
        it = iter(loader)
        while True:
            with span("val.load"):
                batch = next(it, None)
            if batch is None:
                break
            im_np = batch["images"]
            bh, bw = int(im_np.shape[1]), int(im_np.shape[2])
            images = torch.from_numpy(im_np).to(device)
            bs = int(batch.get("real", images.shape[0]))  # skip pad duplicates
            n_images += bs
            with span("val.forward", device=device, images=bs):
                preds = forward(images)
                if save_hybrid:
                    tgt = torch.from_numpy(batch["targets"]).to(device)  # (bs, M, 5)
                    vmask = torch.from_numpy(batch["valid"]).to(device)
                    nc = preds.shape[-1] - 5
                    lab_xywh = tgt[..., 1:5] * torch.tensor([bw, bh, bw, bh],
                                                            dtype=torch.float32, device=device)
                    # one-hot that leaves a class id outside [0, nc) all zero
                    onehot = (tgt[..., 0:1].long()
                              == torch.arange(nc, device=device)).float()
                    conf1 = vmask[..., None].float()
                    lab_rows = torch.cat([lab_xywh, conf1, onehot * conf1], -1)
                    preds = torch.cat([preds, lab_rows], 1)
            with span("val.nms", device=device):
                dets = non_max_suppression(preds, conf_thres=conf_thres, iou_thres=iou_thres,
                                           multi_label=multi_label, max_det=max_det,
                                           max_nms=max_nms)
                dets = detections_to_numpy(dets)
            with span("val.match"):
                targets, valid = batch["targets"], batch["valid"]
                for b in range(bs):
                    pred = dets[b]  # (n, 6) xyxy+conf+cls in letterbox px
                    idx = int(batch["indices"][b])
                    nh, nw = (int(x) for x in shapes[idx])
                    if native_space:
                        # reference val.py:282-310: un-letterbox predictions, take
                        # labels straight from the dataset in original coordinates
                        pred = pred.copy()
                        pred[:, :4] = _scale_to_native(pred[:, :4], (bh, bw), (nh, nw))
                        labels = _xywhn_to_xyxy(loader.ds.labels[idx], nw, nh)
                    else:
                        labels = _xywhn_to_xyxy(targets[b][valid[b]], bw, bh)
                    correct = process_batch(pred, labels, iouv)
                    stats.append((correct, pred[:, 4], pred[:, 5], labels[:, 0]))
                    if save_txt_dir is None and not (save_json and len(pred)):
                        continue
                    nb_ = (pred[:, :4] if native_space
                           else _scale_to_native(pred[:, :4], (bh, bw), (nh, nw)))
                    stem = Path(batch["paths"][b]).stem
                    if save_txt_dir is not None:
                        lines = []
                        for (x1, y1, x2, y2), row in zip(nb_, pred):
                            rec = [int(row[5]), (x1 + x2) / 2 / nw, (y1 + y2) / 2 / nh,
                                   (x2 - x1) / nw, (y2 - y1) / nh]
                            if save_conf:
                                rec.append(row[4])
                            lines.append(" ".join(f"{v:.6g}" for v in rec))
                        (save_txt_dir / f"{stem}.txt").write_text(
                            "\n".join(lines) + ("\n" if lines else ""))
                    if save_json and len(pred):
                        image_id = int(stem) if stem.isnumeric() else stem
                        for (x1, y1, x2, y2), row in zip(nb_, pred):
                            cid = int(row[5])
                            if coco91 and cid < len(COCO80_TO_COCO91):
                                cid = COCO80_TO_COCO91[cid]
                            json_rows.append({
                                "image_id": image_id,
                                "category_id": cid,
                                "bbox": [round(float(x1), 3), round(float(y1), 3),
                                         round(float(x2 - x1), 3), round(float(y2 - y1), 3)],
                                "score": round(float(row[4]), 5),
                            })

    with span("val.ap"):
        tp = np.concatenate([s[0] for s in stats]) if stats else np.zeros((0, 10), bool)
        conf = np.concatenate([s[1] for s in stats]) if stats else np.zeros(0)
        pred_cls = np.concatenate([s[2] for s in stats]) if stats else np.zeros(0)
        target_cls = np.concatenate([s[3] for s in stats]) if stats else np.zeros(0)

        if tp.shape[0] and target_cls.shape[0]:
            res = ap_per_class(tp, conf, pred_cls, target_cls)
            ap50 = res["ap"][:, 0]
            ap = res["ap"].mean(1)
            mp, mr = res["p"].mean(), res["r"].mean()
            map50, mean_ap = ap50.mean(), ap.mean()
            per_class = {int(c): (float(a50), float(a)) for c, a50, a in
                         zip(res["classes"], ap50, ap)}
        else:
            mp = mr = map50 = mean_ap = 0.0
            per_class = {}

    forwards = [sp for sp in spans if sp.name == "val.forward"]
    skip = 1 if len(forwards) > 1 else 0  # the first batch builds the kernels
    n_timed = max(sum(sp.counts["images"] for sp in forwards[skip:]), 1)

    def ms(name, clock):
        return sum([getattr(sp, clock) for sp in spans if sp.name == name][skip:]) / n_timed

    out = {
        "mp": float(mp), "mr": float(mr), "map50": float(map50),
        "map": float(mean_ap),
        "fitness": fitness([mp, mr, map50, mean_ap]),
        "per_class": per_class,
        "speed_ms": {"forward": ms("val.forward", "device_ms"), "nms": ms("val.nms", "device_ms"),
                     "host": ms("val.match", "host_ms")},
        "images": n_images,
    }
    if save_json:
        Path(save_json).parent.mkdir(parents=True, exist_ok=True)
        Path(save_json).write_text(json.dumps(json_rows))
        out["json"] = str(save_json)
        # score with the COCO protocol: cross-checks ap_per_class
        # (reference val.py:368-383)
        try:
            out["coco"] = score_detections_json(json_rows, gt_from_dataset(loader.ds,
                                                                           coco91=coco91))
            if verbose:
                c = out["coco"]
                print(f"COCO eval: mAP {c['map']:.4f}  mAP50 {c['map50']:.4f} "
                      f"mAP75 {c['map75']:.4f} (in-house mAP {mean_ap:.4f})")
        except Exception as e:  # scoring must never kill a val run; "coco" stays absent
            print(f"COCO scoring failed: {type(e).__name__}: {e}")
    if verbose:
        print(f"val: {n_images} imgs  P {mp:.3f}  R {mr:.3f}  mAP50 {map50:.3f} "
              f"mAP50-95 {mean_ap:.3f}  ({out['speed_ms']})")
        if names and per_class and len(per_class) > 1:
            # per-class AP table (reference val.py:252-259 verbose block)
            for c, (a50, a) in sorted(per_class.items()):
                n_t = int((target_cls == c).sum())
                print(f"  {str(names.get(c, c)):>20s} {n_t:6d}  "
                      f"mAP50 {a50:.3f}  mAP50-95 {a:.3f}")
    return out


def run(data, weights=None, cfg="yolov5s", imgsz=640, batch_size=32,
        conf_thres=0.001, iou_thres=0.6, max_det=300, single_cls=False,
        workers=8, half=False, verbose=True, task="val", save_json=None,
        coco91=None, rect=True, native_space=True, augment=False,
        save_txt=False, save_conf=False, save_hybrid=False,
        project="runs/val", name="exp", exist_ok=False, device="cuda", dnn=False):
    """Standalone validation entry (reference val.py:112-440) on ``device``;
    a CUDA device that is not there raises. ``weights`` as ``Detector``
    takes them (None, .pt, .ckpt, a state_dict, or an exported model: .onnx,
    with ``dnn`` through OpenCV, ``triton+http://``, the JAX package's
    TensorFlow exports).

    Defaults match the reference protocol: rect batching (pad 0.5,
    val.py:196) and native-space matching (val.py:240). An exported model
    (the JAX evaluator's branch, evaluator.py:295-334) has a fixed input:
    its export size overrides ``imgsz`` with a warning, its batches are
    square (no rect), and TTA is ignored with a warning; its graph's batch
    is fixed too, so ``batch_size`` must be the export's (else the runtime
    raises, as the JAX package's does)."""
    from yolov5_tpu_torch.data.dataset import create_loader
    from yolov5_tpu_torch.infer import Detector, export_size
    from yolov5_tpu_torch.utils.general import check_dataset, check_img_size, increment_path

    data_dict = check_dataset(data)
    det = Detector(weights, cfg=cfg, imgsz=imgsz, half=half, device=device, dnn=dnn)
    if det.model is None:
        stride = 32
        imgsz = export_size(det, imgsz, weights)
        if augment:
            print("WARNING: --augment (TTA) is unsupported for exported backends, ignoring")
            augment = False
    else:
        stride = max(det.stride)
    imgsz = check_img_size(imgsz, s=stride)
    split = data_dict.get(task) or data_dict.get("val") or data_dict["train"]
    _, loader = create_loader(split, img_size=imgsz, batch_size=batch_size,
                              workers=workers, single_cls=single_cls,
                              rect=rect and det.model is not None, stride=stride)
    if coco91 is None:  # auto: coco remap when the dataset looks like COCO
        coco91 = "coco" in str(data_dict.get("yaml_file", "")).lower()
    save_txt_dir = None
    if save_txt:
        save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
        save_txt_dir = save_dir / "labels"
    results = evaluate(det.forward_tta if augment else det.forward, loader, det.device,
                       conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                       verbose=verbose, save_json=save_json, coco91=coco91,
                       native_space=native_space, save_txt_dir=save_txt_dir,
                       save_conf=save_conf, save_hybrid=save_hybrid,
                       names=det.names if verbose else None)
    if save_txt_dir is not None:
        results["save_dir"] = str(save_txt_dir.parent)
    return results


def run_speed(data, weights=None, batch_size=1, conf_thres=0.25, iou_thres=0.45,
              **kwargs):
    """``--task speed`` (reference val.py:450): the published speed-table
    protocol — batch 1, conf 0.25, iou 0.45, no JSON scoring. Prints the
    steady-state ms/img split (forward / NMS / host) and returns the results
    dict."""
    kwargs.pop("save_json", None)
    res = run(data, weights=weights, batch_size=batch_size,
              conf_thres=conf_thres, iou_thres=iou_thres, save_json=None,
              **kwargs)
    s = res["speed_ms"]
    total = s["forward"] + s["nms"] + s["host"]
    print(f"speed: {s['forward']:.1f} ms forward, {s['nms']:.1f} ms NMS, "
          f"{s['host']:.1f} ms host per image at batch {batch_size} "
          f"({total:.1f} ms total)")
    res["speed_total_ms"] = total
    return res


def run_study(data, weights=None, imgsz_range=(256, 1536, 128), project="runs/val",
              name="study", exist_ok=True, **kwargs):
    """``--task study`` (reference val.py:474-528): mAP-vs-latency sweep over
    image sizes 256..1536 step 128. Writes ``study_{data}_{weights}.txt``
    (one row per size: imgsz, P, R, mAP50, mAP50-95, fwd/nms/host ms) next to
    a ``study.png`` speed-accuracy curve, mirroring the reference's
    ``plot_val_study``. Returns the list of per-size result dicts."""
    from yolov5_tpu_torch.utils.general import increment_path

    lo, hi, step = imgsz_range
    sizes = list(range(lo, hi + step, step))
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
    stem_d = Path(str(data)).stem
    cfgv = kwargs.get("cfg", "")
    stem_w = (Path(str(weights)).stem if isinstance(weights, (str, Path))
              else (cfgv if isinstance(cfgv, str) else "cfg"))
    out_txt = save_dir / f"study_{stem_d}_{stem_w}.txt"
    rows, results = [], []
    kwargs.pop("save_json", None)
    for s in sizes:
        res = run(data, weights=weights, imgsz=s, save_json=None, **kwargs)
        sp = res["speed_ms"]
        rows.append([s, res["mp"], res["mr"], res["map50"], res["map"],
                     sp["forward"], sp["nms"], sp["host"]])
        results.append(dict(res, imgsz=s))
        print(f"study @{s}: mAP50-95 {res['map']:.4f}  "
              f"{sp['forward'] + sp['nms']:.1f} ms/img device")
    np.savetxt(out_txt, np.array(rows), fmt="%10.4g",
               header="imgsz P R mAP50 mAP50-95 fwd_ms nms_ms host_ms")
    from yolov5_tpu_torch.utils.plots import plot_study

    plot_study([out_txt], save_dir / "study.png")  # soft-fail: never kills the sweep
    print(f"study saved to {out_txt}")
    return results
