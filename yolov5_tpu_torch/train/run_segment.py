"""Segmentation training and validation: ``run(**kwargs)`` and
``evaluate_segment``, the port of ``yolov5_tpu/train/run_segment.py`` (the
reference's segment/train.py and segment/val.py), on one device or on one
device per process under torchrun.

Training is ``train/run.py``'s loop with masks: the loader fills each
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
unless ``noplots``) as in ``train/run.py``; several ranks as there too:
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
import yaml

from yolov5_tpu_torch.data.cv import resize
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.data.device_cache import (build_cache_arrays, cache_nbytes,
                                                device_memory_budget, index_batches, to_device)
from yolov5_tpu_torch.eval.coco import COCO80_TO_COCO91
from yolov5_tpu_torch.eval.evaluator import _scale_to_native, _xywhn_to_xyxy
from yolov5_tpu_torch.eval.metrics import ap_per_class, process_batch
from yolov5_tpu_torch.eval.rle import mask_to_rle
from yolov5_tpu_torch.infer_segment import Segmenter
from yolov5_tpu_torch.models.yolo import SegmentationModel
from yolov5_tpu_torch.ops.masks import process_mask
from yolov5_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression
from yolov5_tpu_torch.parallel.distributed import (all_reduce_sum, broadcast_object,
                                                   init_distributed, is_main, rank, rank_batch,
                                                   rank_device, world)
from yolov5_tpu_torch.parallel.mesh import replicate
from yolov5_tpu_torch.train.loss import ComputeSegmentLoss
from yolov5_tpu_torch.train.optim import Optimizer
from yolov5_tpu_torch.train.prefetch import prefetch
from yolov5_tpu_torch.train.run import (EarlyStopper, load_initial_weights, multiscale_epoch_plan,
                                        multiscale_sizes, resume_options)
from yolov5_tpu_torch.train.trainer import init_train_state, make_train_step, scale_hyp
from yolov5_tpu_torch.utils.checkpoint import (anchors_to_yaml, load_checkpoint,
                                               restore_train_state, save_checkpoint)
from yolov5_tpu_torch.utils.general import check_dataset, check_img_size, init_seeds, run_dir
from yolov5_tpu_torch.utils.hyp import load_hyp
from yolov5_tpu_torch.utils.loggers import Loggers
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


def ema_segmenter(state, half, device):
    """A ``Segmenter`` (BN folded) of the EMA weights with the live anchors
    as the checkpoint meta stores them: ``segment val`` on the saved
    ``best.ckpt`` rebuilds exactly this model."""
    model = state.model
    cfg = dict(model.cfg, nc=model.nc, anchors=anchors_to_yaml(model.anchors))
    return Segmenter({**state.ema.params, **state.ema.batch_stats}, cfg=cfg, device=device,
                     half=half)


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
    device_arg, device = device, rank_device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"run_segment.run(device={str(device)!r}): no CUDA device is "
                           "available")
    if resume and _resume_ckpt is None:
        saved, ckpt_path = resume_options(resume, project)
        if saved is not None:
            return run(**saved, _resume_ckpt=str(ckpt_path), save_dir=str(ckpt_path.parent),
                       device=device_arg)
        _resume_ckpt = str(ckpt_path)
        save_dir = save_dir or str(ckpt_path.parent)
    n_ranks, main = world(), is_main()
    rank_bs = rank_batch(batch_size)
    if sync_bn:
        print("--sync-bn: cross-device BN stats are always on")
    init_seeds(seed)
    data_dict = check_dataset(data)
    nc = 1 if single_cls else int(data_dict["nc"])
    opt_dict = {k: (str(v) if isinstance(v, Path) else v) for k, v in dict(
        data=data, cfg=cfg, hyp=hyp, epochs=epochs, batch_size=batch_size, imgsz=imgsz,
        optimizer=optimizer, cos_lr=cos_lr, seed=seed, workers=workers,
        max_labels=max_labels, single_cls=single_cls, mask_ratio=mask_ratio,
        no_overlap=no_overlap, seg_k=seg_k, project=project, name=name, nosave=nosave,
        noval=noval, dtype=dtype, device_aug=device_aug, cache=cache,
        segments_v=segments_v, weights=weights, patience=patience, freeze=freeze,
        label_smoothing=label_smoothing, save_period=save_period,
        noautoanchor=noautoanchor, noplots=noplots, multi_scale=multi_scale,
    ).items()}
    hyp = load_hyp(hyp)
    if label_smoothing:
        hyp["label_smoothing"] = float(label_smoothing)
    amp = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    overlap = not no_overlap

    save_dir = run_dir(save_dir, project, name, exist_ok)
    loggers = None
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
        (save_dir / "hyp.yaml").write_text(yaml.safe_dump(hyp, sort_keys=False))
        (save_dir / "opt.yaml").write_text(yaml.safe_dump(opt_dict, sort_keys=False))
        loggers = Loggers(save_dir)
    last, best = save_dir / "last.ckpt", save_dir / "best.ckpt"

    start_epoch, best_fitness, resume_payload, anchors = 0, 0.0, None, None
    if _resume_ckpt:
        resume_payload, meta = load_checkpoint(_resume_ckpt)
        anchors = meta.get("anchors")  # autoanchor may have evolved them
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_fitness = float(meta.get("best_fitness", 0.0))
        if start_epoch <= 0:
            raise ValueError(f"{_resume_ckpt}: training is finished, nothing to resume")
        if epochs < start_epoch:
            print(f"{_resume_ckpt} has been trained for {start_epoch - 1} epochs; "
                  f"fine-tuning for {epochs} more epochs")
            epochs += start_epoch - 1
    model = SegmentationModel(cfg, nc=nc, seed=seed, anchors=anchors)
    if data_dict.get("names"):
        model.names = {int(k): v for k, v in data_dict["names"].items()}
    if weights and not _resume_ckpt:
        load_initial_weights(model, weights)
    imgsz = check_img_size(imgsz, s=max(model.stride))

    train_ds, train_loader = create_loader(
        data_dict["train"], img_size=imgsz, batch_size=rank_bs, augment=True,
        hyp=hyp, workers=workers, max_labels=max_labels, seed=seed, single_cls=single_cls,
        cache=cache if cache in ("ram", "disk") else None, masks=True,
        mask_ratio=mask_ratio, overlap=overlap, shard=(rank(), n_ranks))
    if not noautoanchor and not _resume_ckpt and not weights:
        from yolov5_tpu_torch.utils.autoanchor import check_anchors

        new_anchors = broadcast_object(check_anchors(
            train_ds, model, thr=hyp.get("anchor_t", 4.0), imgsz=imgsz) if main else None)
        if new_anchors != model.anchors:
            model.anchors = new_anchors
            model.cfg["anchors"] = anchors_to_yaml(new_anchors)
            print("autoanchor: anchors updated")
    val_loader = None
    if data_dict.get("val") and not noval and main:
        _, val_loader = create_loader(
            data_dict["val"], img_size=imgsz, batch_size=batch_size, workers=workers,
            max_labels=max_labels, single_cls=single_cls, masks=True, mask_ratio=mask_ratio,
            overlap=overlap)
    nb = len(train_loader)
    if nb == 0:
        raise ValueError(f"train loader is empty for {data_dict.get('train')}")

    model = model.to(device).to(memory_format=torch.channels_last)
    ms_sizes, ms_rng = [], None
    if multi_scale:
        ms_sizes = multiscale_sizes(imgsz, max(model.stride))
        ms_rng = np.random.default_rng(seed + 0x5CA1E)
        print(f"multi-scale: per-batch sizes {ms_sizes}")
    hyp_scaled = scale_hyp(hyp, nl=len(model.stride), nc=nc, imgsz=imgsz)
    loss_fn = ComputeSegmentLoss(model.anchors_per_stride, nc, hyp_scaled, nm=model.nm,
                                 overlap=overlap, seg_k=seg_k)
    opt = Optimizer(dict(model.named_parameters()), hyp_scaled, epochs=epochs,
                    steps_per_epoch=nb, batch_size=batch_size, name=optimizer, cos_lr=cos_lr,
                    freeze=freeze)
    state = init_train_state(model, opt)
    if resume_payload is not None:
        restore_train_state(state, resume_payload)
        resume_payload = None
    replicate(state)

    # the device path: the set and its polygons in device memory, mosaic,
    # HSV, flips and the GT masks in the step (separable geometry, no
    # copy-paste); else the host augments and fills the masks
    cache_dev = None
    separable = not any(hyp.get(k, 0) for k in ("degrees", "shear", "perspective",
                                                  "copy_paste"))
    if device_aug and separable and hyp.get("mosaic", 0) > 0 and cache in (None, "device"):
        need = cache_nbytes(train_ds, max_labels, segments_v=segments_v)
        if cache == "device" or need <= device_memory_budget(device):
            train_ds.cache = None
            cache_dev = to_device(build_cache_arrays(train_ds, max_labels, segments_v),
                                  device)
            print(f"device cache: {len(train_ds)} images + segments ({need / 1e6:.0f} MB) "
                  f"on {device}")
    aug_hyp = hyp if cache_dev is not None else None
    sizes = ms_sizes if multi_scale and cache_dev is not None else [None]
    step_fns = {sz: make_train_step(loss_fn, device_aug_hyp=aug_hyp, dtype=amp, seed=seed,
                                    ms_size=sz, has_masks=True, overlap=overlap,
                                    mask_shape=((sz or imgsz) // mask_ratio,) * 2)
                for sz in sizes}

    def host_prep(batch):
        """The batch's arrays for the step; a host multi-scale size drawn
        per batch resizes its images (bilinear) and its masks (nearest)."""
        batch = {k: batch[k] for k in ("images", "targets", "valid", "masks")}
        if multi_scale:
            s_b = int(ms_rng.choice(ms_sizes))
            if s_b != imgsz:
                batch["images"] = np.stack([resize(im, (s_b, s_b), "linear")
                                            for im in batch["images"]])
                batch["masks"] = _resample_masks(batch["masks"], s_b // mask_ratio)
        return batch

    stopper = EarlyStopper(patience)
    if main:
        print(f"seg training {cfg} on {data_dict.get('train')}: {len(train_ds)} imgs, {nb} "
              f"steps/epoch, {device}" + (f" x {n_ranks} ranks" if n_ranks > 1 else "")
              + f", imgsz {imgsz}")
    results = {}
    t_start = time.time()
    try:
        for epoch in range(start_epoch, epochs):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            if cache_dev is not None:
                idx_epoch = np.stack([b["idx"] for b in index_batches(train_loader,
                                                                      whole=n_ranks > 1)])
                plan = (multiscale_epoch_plan(idx_epoch, ms_sizes, ms_rng) if multi_scale
                        else [(None, idx_epoch)])
                feed = (({"idx": idx}, size) for size, rows in plan
                        for idx in torch.from_numpy(rows).to(device))
            else:
                feed = ((batch, None) for batch in
                        prefetch(iter(train_loader), device, depth=2, transform=host_prep))
            agg = None
            for batch, size in feed:
                _, metrics = step_fns[size](state, batch, cache_dev)
                agg = metrics if agg is None else {k: agg[k] + v for k, v in metrics.items()}
            # the epoch's one wait for the device: the ranks' shares summed
            keys = ("box", "obj", "cls", "seg", "total", "seg_overflow")
            agg = dict(zip(keys, all_reduce_sum(torch.stack([agg[k] for k in keys])).tolist()))
            dt = time.time() - t0
            row = {f"train/{k}": agg[k] / nb for k in keys[:5]}
            row["train/imgs_per_sec"] = nb * batch_size / dt
            if agg["seg_overflow"] > 0 and main:
                # no silent caps: candidates past seg_k trained no mask
                print(f"WARNING: {agg['seg_overflow']:.0f} mask-loss candidates exceeded "
                      f"--seg-k {seg_k} this epoch and were dropped; raise --seg-k to "
                      "restore full mask supervision")

            fi, stop = 0.0, False
            if main:  # the other ranks wait for its fitness below
                if val_loader is not None:
                    seg = ema_segmenter(state, amp == torch.bfloat16, device)
                    results = evaluate_segment(seg.forward, val_loader, device, nc,
                                               overlap=overlap)
                    row.update({"val/box_map50": results["box"]["map50"],
                                "val/box_map": results["box"]["map"],
                                "val/mask_map50": results["mask"]["map50"],
                                "val/mask_map": results["mask"]["map"]})
                    fi = results["fitness"]
                row["fitness"] = fi
                loggers.log_metrics(row, epoch)
                print(f"epoch {epoch + 1}/{epochs}  "
                      + "  ".join(f"{k.split('/')[-1]} {v:.4g}" for k, v in row.items()))

                best_fitness = max(best_fitness, fi)
                if not nosave:
                    save_checkpoint(last, state, epoch, best_fitness, include_opt=True)
                    if val_loader is not None and best_fitness == fi:
                        save_checkpoint(best, state, epoch, best_fitness)
                    if save_period > 0 and epoch % save_period == 0:
                        save_checkpoint(save_dir / f"epoch{epoch}.ckpt", state, epoch,
                                        best_fitness)
                stop = stopper(epoch, fi)
                if stop:
                    print(f"early stopping at epoch {epoch + 1} "
                          f"(no fitness gain in {patience} epochs)")
            best_fitness, stop, results = broadcast_object((best_fitness, stop, results))
            if stop:
                break
    finally:
        train_loader.close()
    if main:
        print(f"done in {(time.time() - t_start) / 3600:.3f}h, best fitness {best_fitness:.4f}")
        if not noplots:
            from yolov5_tpu_torch.utils.plots import plot_labels, plot_results

            plot_results(save_dir / "results.csv")
            plot_labels(train_ds.labels, model.names, save_dir)
        if best.exists():
            loggers.log_model(best)
        loggers.close()
    return best_fitness, results, save_dir
