"""Segmentation training and validation: ``run(**kwargs)`` and
``evaluate_segment``, the port of ``yolov5_tpu/train/run_segment.py`` (the
reference's segment/train.py and segment/val.py), on one device or on one
device per process under torchrun.

Training is ``train/loop.py``'s run with masks: the loader fills each
batch's GT masks from its polygons (``data.dataset.rasterize_masks``), the
model returns (maps, proto) and ``ComputeSegmentLoss`` adds the mask term.
By default the host augments; with ``device_aug`` (separable geometry, a
mosaic, no copy-paste) the set and its polygons live in device memory
(``data.device_cache``) and ``device_augment_seg`` composes each batch and
fills its masks on the device. Each epoch the EMA weights, BN folded (the
stem runs K2 on CUDA), are validated by ``evaluate_segment``: multi-label NMS
at conf 0.001, IoU 0.6, max_det 300 (K1), box mAP against the labels and
mask mAP against the GT masks at image resolution, the mask IoUs counted in
float32 on the device image by image. ``last.ckpt`` keeps the optimizer;
both files carry the model's cfg and live anchors, so that ``segment val``
rebuilds the model. Loggers and plots (``results.png``, ``labels.png``
unless ``noplots``) as in detection training; several ranks as there too:
each trains on its shard of the global batch (``batch_size``), the mask
loss's normaliser is the global batch's, and rank 0 validates, saves and
logs.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolov5_tpu_torch.data.cv import resize
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.eval.coco import COCO80_TO_COCO91
from yolov5_tpu_torch.eval.evaluator import _scale_to_native, _xywhn_to_xyxy
from yolov5_tpu_torch.eval.metrics import ap_per_class, process_batch
from yolov5_tpu_torch.eval.rle import mask_to_rle
from yolov5_tpu_torch.infer import resolve_device
from yolov5_tpu_torch.infer_segment import Segmenter
from yolov5_tpu_torch.models.yolo import SegmentationModel
from yolov5_tpu_torch.ops.masks import process_mask
from yolov5_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression
from yolov5_tpu_torch.parallel.distributed import init_distributed, rank, rank_device
from yolov5_tpu_torch.train.loop import Run, device_cache, ema_weights, resume_options
from yolov5_tpu_torch.train.loss import ComputeSegmentLoss
from yolov5_tpu_torch.train.trainer import make_train_step
from yolov5_tpu_torch.utils.profile import span

IOUV = np.linspace(0.5, 0.95, 10)


def _segm_json_rows(pred, proto_b, im_file, native_hw, lb_hw, coco91):
    """COCO segm rows of one image (reference segment/val.py:72-101
    save_one_json). pred (n, 6 + nm) [xyxy, conf, cls, coeffs] in letterbox
    pixels, proto_b (hm, wm, nm) float32. Masks: sigmoid(coeffs @ proto) at
    proto resolution, cropped to the box, bilinear to the letterbox, > 0.5,
    the padding cut, bilinear to the native size, > 0.5, RLE."""
    nh, nw = native_hw
    bh, bw = lb_hw
    hm, wm, nm = proto_b.shape
    n = pred.shape[0]
    coeff = pred[:, 6:6 + nm].astype(np.float32)
    masks = 1.0 / (1.0 + np.exp(-(coeff @ proto_b.reshape(hm * wm, nm).T)))
    masks = masks.reshape(n, hm, wm)
    bx = pred[:, :4] * np.array([wm / bw, hm / bh, wm / bw, hm / bh], np.float32)
    xg = np.arange(wm, dtype=np.float32)[None, None, :]
    yg = np.arange(hm, dtype=np.float32)[None, :, None]
    inside = ((xg >= bx[:, 0, None, None]) & (xg < bx[:, 2, None, None])
              & (yg >= bx[:, 1, None, None]) & (yg < bx[:, 3, None, None]))
    masks *= inside

    gain = min(bh / nh, bw / nw)
    pad_x, pad_y = (bw - nw * gain) / 2, (bh - nh * gain) / 2
    top, left = int(round(pad_y - 0.1)), int(round(pad_x - 0.1))
    bottom, right = int(round(bh - pad_y + 0.1)), int(round(bw - pad_x + 0.1))

    box_n = _scale_to_native(pred[:, :4].astype(np.float64), lb_hw, native_hw)
    stem = Path(im_file).stem
    image_id = int(stem) if stem.isnumeric() else stem
    rows = []
    for i in range(n):
        ml = resize(masks[i].astype(np.float32), (bw, bh), "linear")
        mb = (ml > 0.5).astype(np.float32)[top:bottom, left:right]
        mn = resize(mb, (nw, nh), "linear") > 0.5
        cid = int(pred[i, 5])
        if coco91 and cid < len(COCO80_TO_COCO91):
            cid = COCO80_TO_COCO91[cid]
        x1, y1, x2, y2 = box_n[i]
        rows.append({
            "image_id": image_id,
            "category_id": cid,
            "bbox": [round(float(x1), 3), round(float(y1), 3),
                     round(float(x2 - x1), 3), round(float(y2 - y1), 3)],
            "score": round(float(pred[i, 4]), 5),
            "segmentation": mask_to_rle(mn),
        })
    return rows


def _mask_ious(proto, dets, gt_masks, n_pred, n_gt, s, overlap):
    """(bs, max(n_gt), max(n_pred)) GT x prediction mask IoUs of a batch at
    image resolution s, one host copy: per image, the predictions'
    ``process_mask(upsample=True)`` > 0.5 and the GT masks resized
    bilinearly to s > 0.5, as float32 0/1 rows whose product counts the
    intersections exactly (sums below 2^24). Images run one at a time, so
    at most one image's (n, s, s) masks are alive."""
    bs = len(n_pred)
    out = torch.zeros((bs, max(n_gt, default=0), max(n_pred, default=0)),
                      device=proto.device)
    for b, (n, g) in enumerate(zip(n_pred, n_gt)):
        if not n or not g:
            continue
        pm = process_mask(proto[b], dets.masks[b, :n], dets.boxes[b, :n], (s, s),
                          upsample=True)
        pmf = (pm > 0.5).reshape(n, -1).float()
        gm = gt_masks[b]
        if overlap:
            inst = torch.arange(1, g + 1, dtype=gm.dtype, device=gm.device)
            gt = (gm[None] == inst[:, None, None]).float()
        else:
            gt = gm[:g].float()
        gt = F.interpolate(gt[None], size=(s, s), mode="bilinear", align_corners=False)[0]
        gtf = (gt > 0.5).reshape(g, -1).float()
        inter = gtf @ pmf.T
        union = gtf.sum(1)[:, None] + pmf.sum(1)[None, :] - inter
        out[b, :g, :n] = inter / union.clamp(min=1e-9)
    return out.cpu().numpy()


def _summarize(stats):
    """P, R, mAP50 and mAP50-95 over the classes of accumulated stats."""
    if stats:
        tp, conf, cls, tcls = (np.concatenate([x[i] for x in stats]) for i in range(4))
        if tp.shape[0] and tcls.shape[0]:
            r = ap_per_class(tp, conf, cls, tcls)
            return {"p": float(r["p"].mean()), "r": float(r["r"].mean()),
                    "map50": float(r["ap"][:, 0].mean()), "map": float(r["ap"].mean())}
    return {"p": 0.0, "r": 0.0, "map50": 0.0, "map": 0.0}


@torch.inference_mode()
def evaluate_segment(forward, loader, device, nc, conf_thres=0.001, iou_thres=0.6,
                     max_det=300, overlap=True, verbose=False, save_json=None, coco91=False):
    """Box and mask mAP of ``forward`` on a mask loader (reference
    segment/val.py:160-320). forward: (bs, s, s, 3) uint8 tensor on
    ``device`` -> (decoded predictions (bs, N, 5 + nc + nm) float32, proto
    (bs, hm, wm, nm)) (``Segmenter.forward``). Predictions and labels are
    matched in letterbox pixels; masks at image resolution. save_json: a
    path for COCO rows with RLE masks (``_segm_json_rows``). Returns
    {"box": {p, r, map50, map}, "mask": {...}, "images", "fitness",
    "speed_ms" (ms per image of the whole loop, host clock)}.

    Spans (``utils/profile.span``, recorded only under a recorder): per
    batch ``segval.load`` (the loader's ``next()``, host), ``segval.forward``
    (count ``images``), ``segval.nms`` (NMS and the copy of the detections
    to the host) and ``segval.masks`` (``_mask_ious``; counts ``masks``, the
    predicted masks assembled, and ``gt``, the GT instances they meet) on
    the device's clock, ``segval.match`` (box and mask matching, json rows,
    host); ``segval.ap`` once a pass (both summaries, host)."""
    device = torch.device(device)
    s = loader.ds.img_size
    json_rows = [] if save_json is not None else None
    stats_box, stats_mask = [], []
    n_images = 0
    t0 = time.perf_counter()
    it = iter(loader)
    while True:
        with span("segval.load"):
            batch = next(it, None)
        if batch is None:
            break
        images = torch.from_numpy(batch["images"]).to(device)
        bs = int(batch.get("real", images.shape[0]))  # skip pad duplicates
        n_images += bs
        with span("segval.forward", device=device, images=bs):
            preds, proto = forward(images)
        with span("segval.nms", device=device):
            dets = non_max_suppression(preds, conf_thres=conf_thres, iou_thres=iou_thres,
                                       multi_label=True, max_det=max_det, nc=nc)
            rows = detections_to_numpy(dets)
        valid = batch["valid"]
        n_pred = [len(rows[b]) for b in range(bs)]
        n_gt = [int(valid[b].sum()) for b in range(bs)]
        both = [(n, g) for n, g in zip(n_pred, n_gt) if n and g]
        with span("segval.masks", device=device, masks=sum(n for n, _ in both),
                  gt=sum(g for _, g in both)):
            ious = _mask_ious(proto, dets, torch.from_numpy(batch["masks"]).to(device), n_pred,
                              n_gt, s, overlap)
        with span("segval.match"):
            for b in range(bs):
                pred = rows[b]
                labels = _xywhn_to_xyxy(batch["targets"][b][valid[b]], s, s)
                correct = process_batch(pred[:, :6], labels, IOUV)
                stats_box.append((correct, pred[:, 4], pred[:, 5], labels[:, 0]))
                if n_pred[b] and n_gt[b]:
                    correct = process_batch(pred[:, :6], labels, IOUV,
                                            iou=ious[b, :n_gt[b], :n_pred[b]])
                else:
                    correct = np.zeros((n_pred[b], len(IOUV)), bool)
                stats_mask.append((correct, pred[:, 4], pred[:, 5], labels[:, 0]))
                if json_rows is not None and n_pred[b]:
                    idx = int(batch["indices"][b])
                    json_rows.extend(_segm_json_rows(
                        pred, proto[b].float().cpu().numpy(), loader.ds.im_files[idx],
                        tuple(int(x) for x in loader.ds.shapes[idx]), (s, s), coco91))
    dt = time.perf_counter() - t0

    with span("segval.ap"):
        box, mask = _summarize(stats_box), _summarize(stats_mask)
    out = {"box": box, "mask": mask, "images": n_images,
           "fitness": 0.9 * (box["map"] + mask["map"]) / 2
           + 0.1 * (box["map50"] + mask["map50"]) / 2,
           "speed_ms": 1e3 * dt / max(n_images, 1)}
    if json_rows is not None:
        Path(save_json).parent.mkdir(parents=True, exist_ok=True)
        Path(save_json).write_text(json.dumps(json_rows))
        out["json"] = str(save_json)
        print(f"saved {len(json_rows)} segm rows to {save_json}")
    if verbose:
        print(f"seg val: box mAP50 {box['map50']:.3f} mAP {box['map']:.3f} | "
              f"mask mAP50 {mask['map50']:.3f} mAP {mask['map']:.3f}")
    return out


def _resample_masks(masks, size):
    """GT masks (..., h, w) to (..., size, size) by nearest pixel, as the
    JAX package follows a host multi-scale resize."""
    yi = (np.arange(size) * (masks.shape[-2] / size)).astype(int)
    xi = (np.arange(size) * (masks.shape[-1] / size)).astype(int)
    return masks[..., yi[:, None], xi[None, :]]


def run(data, cfg="yolov5n-seg", hyp=None, epochs=100, batch_size=16, imgsz=640,
        optimizer="sgd", cos_lr=False, seed=0, workers=8, max_labels=128, single_cls=False,
        mask_ratio=4, no_overlap=False, seg_k=256, project="runs/train-seg", name="exp",
        exist_ok=False, nosave=False, noval=False, save_dir=None, dtype="bfloat16",
        device_aug=False, cache=None, segments_v=32, weights="", resume="", patience=100,
        freeze=None, label_smoothing=0.0, save_period=-1, noautoanchor=False, noplots=False,
        sync_bn=False, multi_scale=False, device="cuda", _resume_ckpt=None):
    """Train an instance-segmentation model on ``device``. Returns
    (best_fitness, results of the last validation, save_dir)."""
    init_distributed(device)
    device_arg, device = device, resolve_device(str(rank_device(device)), "run_segment.run")
    if resume and _resume_ckpt is None:
        saved, ckpt_path = resume_options(resume, project)
        if saved is not None:
            return run(**saved, _resume_ckpt=str(ckpt_path), save_dir=str(ckpt_path.parent),
                       device=device_arg)
        _resume_ckpt, save_dir = str(ckpt_path), save_dir or str(ckpt_path.parent)
    r = Run(SegmentationModel, device, dict(
        data=data, cfg=cfg, hyp=hyp, epochs=epochs, batch_size=batch_size, imgsz=imgsz,
        optimizer=optimizer, cos_lr=cos_lr, seed=seed, workers=workers,
        max_labels=max_labels, single_cls=single_cls, mask_ratio=mask_ratio,
        no_overlap=no_overlap, seg_k=seg_k, project=project, name=name, nosave=nosave,
        noval=noval, dtype=dtype, device_aug=device_aug, cache=cache,
        segments_v=segments_v, weights=weights, patience=patience, freeze=freeze,
        label_smoothing=label_smoothing, save_period=save_period,
        noautoanchor=noautoanchor, noplots=noplots, multi_scale=multi_scale,
    ), save_dir=save_dir, exist_ok=exist_ok, sync_bn=sync_bn, resume_ckpt=_resume_ckpt)
    nc, imgsz, hyp, overlap = r.nc, r.imgsz, r.hyp, not no_overlap

    train_ds, train_loader = create_loader(
        r.data["train"], img_size=imgsz, batch_size=r.rank_bs, augment=True,
        hyp=hyp, workers=workers, max_labels=max_labels, seed=seed, single_cls=single_cls,
        cache=cache if cache in ("ram", "disk") else None, masks=True,
        mask_ratio=mask_ratio, overlap=overlap, shard=(rank(), r.n_ranks))
    r.autoanchor(train_ds)
    val_loader = None
    if r.data.get("val") and not noval and r.main:
        _, val_loader = create_loader(
            r.data["val"], img_size=imgsz, batch_size=batch_size, workers=workers,
            max_labels=max_labels, single_cls=single_cls, masks=True, mask_ratio=mask_ratio,
            overlap=overlap)
    loss_fn = r.build(train_loader, lambda h: ComputeSegmentLoss(
        r.model.anchors_per_stride, nc, h, nm=r.model.nm, overlap=overlap, seg_k=seg_k))

    # the device path: the set and its polygons in device memory, mosaic,
    # HSV, flips and the GT masks in the step (separable geometry, no
    # copy-paste); else the host augments and fills the masks
    separable = not any(hyp.get(k, 0) for k in ("degrees", "shear", "perspective",
                                                  "copy_paste"))
    cache_dev = (device_cache(train_ds, max_labels, cache, device, segments_v)
                 if device_aug and separable and hyp.get("mosaic", 0) > 0
                 and cache in (None, "device") else None)
    aug_hyp = hyp if cache_dev is not None else None

    def rescale(batch, size):  # images bilinear, masks nearest
        batch["images"] = np.stack([resize(im, (size, size), "linear")
                                    for im in batch["images"]])
        batch["masks"] = _resample_masks(batch["masks"], size // mask_ratio)
        return batch

    def overflow(sums):  # no silent caps: candidates past seg_k trained no mask
        if sums["seg_overflow"] > 0 and r.main:
            print(f"WARNING: {sums['seg_overflow']:.0f} mask-loss candidates exceeded "
                  f"--seg-k {seg_k} this epoch and were dropped; raise --seg-k to "
                  "restore full mask supervision")

    def validate(state):
        seg = Segmenter(*ema_weights(state), device=device, half=r.amp == torch.bfloat16)
        results = evaluate_segment(seg.forward, val_loader, device, nc, overlap=overlap)
        return ({f"val/{part}_{k}": results[part][k] for part in ("box", "mask")
                 for k in ("map50", "map")}, results["fitness"], results)

    return r.fit(
        f"seg training {cfg}", train_ds, train_loader,
        lambda size: make_train_step(loss_fn, device_aug_hyp=aug_hyp, dtype=r.amp, seed=seed,
                                     ms_size=size, has_masks=True, overlap=overlap,
                                     mask_shape=((size or imgsz) // mask_ratio,) * 2),
        ms_device=multi_scale and cache_dev is not None, cache_dev=cache_dev, rescale=rescale,
        batch_keys=("images", "targets", "valid", "masks"),
        keys=("box", "obj", "cls", "seg", "total"), counters=("seg_overflow",),
        validate=validate if val_loader is not None else None, epoch_end=overflow,
        log_final=lambda path, *_: r.loggers.log_model(path), noplots=noplots)
