"""yolov5_tpu_torch.eval.metrics and eval.coco against their originals in
yolov5_tpu on random inputs: the port is a numpy copy, so every result is
exactly equal."""

import numpy as np
import pytest

import yolov5_tpu.eval.coco as jcoco
import yolov5_tpu.eval.metrics as jmet
import yolov5_tpu_torch.eval.coco as pcoco
import yolov5_tpu_torch.eval.metrics as pmet


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _boxes(rng, n, span=100.0):
    xy = rng.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, 40, (n, 2))], 1).astype(np.float32)


def _dets_labels(rng, n, m, nc=3):
    """Detections (n, 6) near some labels (m, 5), so that matches exist."""
    labels = np.concatenate([rng.integers(0, nc, (m, 1)), _boxes(rng, m)], 1).astype(np.float32)
    near = labels[rng.integers(0, max(m, 1), n), 1:] + rng.normal(0, 3, (n, 4)) if m else _boxes(rng, n)
    dets = np.concatenate([near, rng.uniform(0, 1, (n, 1)), rng.integers(0, nc, (n, 1))], 1)
    return dets.astype(np.float32), labels


@pytest.mark.parametrize("seed", range(4))
def test_process_batch_and_ap(seed):
    rng = np.random.default_rng(seed)
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    for n, m in ((40, 10), (0, 5), (7, 0), (60, 25)):
        dets, labels = _dets_labels(rng, n, m)
        got = pmet.process_batch(dets, labels, iouv)
        _same(got, jmet.process_batch(dets, labels, iouv))
        stats.append((got, dets[:, 4], dets[:, 5], labels[:, 0]))
    tp, conf, pcls, tcls = (np.concatenate([s[i] for s in stats]) for i in range(4))
    _same(pmet.ap_per_class(tp, conf, pcls, tcls), jmet.ap_per_class(tp, conf, pcls, tcls))
    r = np.sort(rng.uniform(0, 1, 30))
    p = rng.uniform(0, 1, 30)
    _same(pmet.compute_ap(r, p), jmet.compute_ap(r, p))
    _same(pmet.smooth(p, 0.1), jmet.smooth(p, 0.1))
    m = rng.uniform(0, 1, 4)
    assert pmet.fitness(m) == jmet.fitness(m)


def test_process_batch_precomputed_and_mask_iou():
    rng = np.random.default_rng(7)
    dets, labels = _dets_labels(rng, 12, 5)
    iouv = np.linspace(0.5, 0.95, 10)
    iou = rng.uniform(0, 1, (5, 12))
    _same(pmet.process_batch(dets, labels, iouv, iou=iou),
          jmet.process_batch(dets, labels, iouv, iou=iou))
    pm, gm = rng.random((12, 64)) > 0.5, rng.random((5, 64)) > 0.5
    _same(pmet.process_batch(dets, labels, iouv, pred_masks=pm, gt_masks=gm),
          jmet.process_batch(dets, labels, iouv, pred_masks=pm, gt_masks=gm))


@pytest.mark.parametrize("seed", range(3))
def test_confusion_matrix(seed):
    rng = np.random.default_rng(seed)
    cms = [pmet.ConfusionMatrix(3), jmet.ConfusionMatrix(3)]
    for n, m in ((20, 8), (0, 3), (5, 0), (30, 12)):
        dets, labels = _dets_labels(rng, n, m)
        for cm in cms:
            cm.process_batch(dets, labels)
    _same(cms[0].matrix, cms[1].matrix)
    _same(cms[0].tp_fp(), cms[1].tp_fp())


def _coco_rows(rng, n_img=6, nc=3, str_ids=False):
    gt, dt = [], []
    for i in range(n_img):
        image_id = f"img{i}" if str_ids else i
        for _ in range(int(rng.integers(0, 6))):
            x, y = rng.uniform(0, 300, 2)
            w, h = rng.uniform(4, 150, 2)  # small, medium and large areas
            c = int(rng.integers(1, nc + 1))
            gt.append({"image_id": image_id, "category_id": c, "bbox": [x, y, w, h],
                       "iscrowd": int(rng.random() < 0.1)})
            for _ in range(int(rng.integers(0, 4))):
                j = rng.normal(0, 0.15 * min(w, h), 4)
                dt.append({"image_id": image_id, "category_id": c if rng.random() < 0.8 else 1,
                           "bbox": [x + j[0], y + j[1], abs(w + j[2]), abs(h + j[3])],
                           "score": float(rng.uniform(0, 1))})
        for _ in range(int(rng.integers(0, 120))):  # false positives past maxDets 100
            dt.append({"image_id": image_id, "category_id": int(rng.integers(1, nc + 1)),
                       "bbox": list(rng.uniform(0, 200, 4)), "score": float(rng.uniform(0, 0.5))})
    return gt, dt


@pytest.mark.parametrize("seed", range(3))
def test_coco_eval_lite(seed, tmp_path):
    gt, dt = _coco_rows(np.random.default_rng(seed), str_ids=bool(seed % 2))
    got = pcoco.COCOEvalLite(gt, dt).evaluate().accumulate()
    ref = jcoco.COCOEvalLite(gt, dt).evaluate().accumulate()
    _same(got.precision, ref.precision)
    _same(got.recall, ref.recall)
    _same(got.summarize(), ref.summarize())
    import json

    p = tmp_path / "dt.json"
    p.write_text(json.dumps(dt))
    _same(pcoco.score_detections_json(str(p), gt), jcoco.score_detections_json(dt, gt))
    with pytest.raises(ValueError, match="iou_type"):
        pcoco.COCOEvalLite(gt, dt, iou_type="keypoints")


@pytest.mark.parametrize("coco91", [False, True])
def test_gt_from_dataset(coco91):
    rng = np.random.default_rng(1)

    class DS:  # the attributes gt_from_dataset reads
        im_files = ["/d/images/000012.jpg", "/d/images/frame_a.jpg", "/d/images/7.bmp"]
        shapes = np.array([[480, 640], [360, 640], [640, 640]], np.int32)
        labels = [np.concatenate([rng.integers(0, 80, (k, 1)), rng.uniform(0.1, 0.9, (k, 4))],
                                 1).astype(np.float32) for k in (3, 0, 5)]

    _same(pcoco.gt_from_dataset(DS, coco91=coco91), jcoco.gt_from_dataset(DS, coco91=coco91))
    from yolov5_tpu.eval.evaluator import COCO80_TO_COCO91 as ref_map

    from yolov5_tpu_torch.eval.evaluator import COCO80_TO_COCO91

    assert COCO80_TO_COCO91 == ref_map


def test_coco_eval_lite_mixed_image_ids_fail_in_both():
    """A known gap of the reference: image ids from file stems that are
    partly numeric ("000012") and partly not cannot be sorted, and COCO
    scoring raises (the evaluator then reports the failure)."""
    gt, dt = _coco_rows(np.random.default_rng(0))
    gt.append(dict(gt[0], image_id="frame_a"))
    for mod in (pcoco, jcoco):
        with pytest.raises(TypeError):
            mod.COCOEvalLite(gt, dt)
