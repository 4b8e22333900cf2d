"""The segmentation validation side of yolov5_tpu_torch against the JAX
package (yolov5n-seg, 64 px, f32, on the CPU, the same .ckpt): the RLE
codec, the COCO segm mode and its ground truth, the COCO segm JSON rows,
evaluate_segment (box and mask metrics, detection counts and the mask IoU
matrices), and ``segment val --save-json`` with its COCO bbox and segm
scores.

Tolerances: RLE strings byte-equal and IoUs exact; COCO scores of equal
inputs equal; JSON rows equal, their RLE masks byte-equal but for at most
one row an image that differs in at most 2 pixels (the float32 resize is
within 2.4e-7 of OpenCV's, tests/test_torch_cv.py, so a value at the 0.5
threshold may land on the other side); evaluate_segment's box and mask P, R,
mAP50 and mAP within 1e-3 absolute and its detection counts equal, the
mask IoU matrices within 1e-2 (a pixel of a 64 x 64 mask at the 0.5 edge);
COCO scores of the --save-json rows within 1e-4."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import yolov5_tpu.train.run_segment as jax_run_segment
import yolov5_tpu_torch.train.run_segment as run_segment
from tests.torch_port_helpers import (random_segmenter_weights, save_jax_checkpoint, seg_cfg,
                                      write_polygon_dataset)
from yolov5_tpu.data.dataset import create_loader as jax_create_loader
from yolov5_tpu.eval import coco as jax_coco
from yolov5_tpu.eval import rle as jax_rle
from yolov5_tpu.models import SegmentationModel as JaxSegmentationModel
from yolov5_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from yolov5_tpu.utils.checkpoint import variables_from_checkpoint as jax_variables
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.eval import coco, rle
from yolov5_tpu_torch.infer_segment import Segmenter

REPO = Path(__file__).resolve().parents[1]
CFG = seg_cfg(3)
IMGSZ = 64
SHAPES = [(48, 64), (64, 48), (64, 64), (32, 64)]


def _random_masks(rng, n, h, w):
    """Masks of several kinds: empty, full, one pixel, noise, blobs, and
    runs longer than 2^5 and 2^10 (multi-character counts)."""
    out = [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]
    one = np.zeros((h, w), np.uint8)
    one[h // 2, w // 3] = 1
    out.append(one)
    for _ in range(n):
        m = (rng.random((h, w)) < rng.uniform(0.05, 0.95)).astype(np.uint8)
        if rng.random() < 0.5:  # a blob
            m[:] = 0
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            m[y0:y0 + rng.integers(1, h // 2), x0:x0 + rng.integers(1, w // 2)] = 1
        out.append(m)
    return out


# ---------------------------------------------------------------------------
# eval/rle.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(7, 5), (48, 64), (200, 150)])
def test_rle_codec_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    masks = _random_masks(rng, 12, *hw)
    for m in masks:
        got, ref = rle.mask_to_rle(m), jax_rle.mask_to_rle(m)
        assert got == ref
        np.testing.assert_array_equal(rle.rle_to_mask(got), m)
        np.testing.assert_array_equal(rle.rle_to_mask(got), jax_rle.rle_to_mask(ref))
        assert rle.rle_area(got) == jax_rle.rle_area(ref) == int(m.sum())
        counts = rle._string_to_counts(got["counts"])
        assert counts == jax_rle._string_to_counts(ref["counts"])
        np.testing.assert_array_equal(rle.rle_to_mask({"size": got["size"], "counts": counts}), m)
    rles = [rle.mask_to_rle(m) for m in masks]
    crowd = rng.random(len(rles)) < 0.3
    got = rle.rle_iou(rles[:9], rles[3:], crowd[3:])
    np.testing.assert_array_equal(got, jax_rle.rle_iou(rles[:9], rles[3:], crowd[3:]))
    np.testing.assert_array_equal(rle.rle_iou(rles, rles), jax_rle.rle_iou(rles, rles))
    assert rle.rle_iou([], rles).shape == (0, len(rles))


def test_polygons_to_rle_matches_jax():
    """The GT side: polygons filled by data.cv.fill_poly against the JAX
    function's cv2.fillPoly, byte-equal RLE."""
    rng = np.random.default_rng(11)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(20, 120, 2))
        polys = [rng.uniform(-10, max(h, w) + 10, (int(rng.integers(1, 20)), 2))
                 for _ in range(int(rng.integers(1, 4)))]
        assert rle.polygons_to_rle(polys, h, w) == jax_rle.polygons_to_rle(polys, h, w)


# ---------------------------------------------------------------------------
# eval/coco.py: the segm mode
# ---------------------------------------------------------------------------

def _segm_rows(rng, n_img=5, nc=3, h=40, w=48):
    gt, dt = [], []
    for i in range(n_img):
        for _ in range(int(rng.integers(0, 5))):
            c = int(rng.integers(1, nc + 1))
            y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + rng.integers(2, h - y0), x0:x0 + rng.integers(2, w - x0)] = 1
            r = rle.mask_to_rle(m)
            gt.append({"image_id": i, "category_id": c, "bbox": [0, 0, 1, 1],
                       "segmentation": r, "area": rle.rle_area(r),
                       "iscrowd": int(rng.random() < 0.1)})
            for _ in range(int(rng.integers(0, 4))):
                jitter = np.roll(m, tuple(rng.integers(-3, 4, 2)), (0, 1))
                dt.append({"image_id": i, "category_id": c if rng.random() < 0.8 else 1,
                           "bbox": [0, 0, 1, 1], "score": float(rng.uniform(0, 1)),
                           "segmentation": rle.mask_to_rle(jitter)})
        for _ in range(int(rng.integers(0, 30))):  # false positives
            dt.append({"image_id": i, "category_id": int(rng.integers(1, nc + 1)),
                       "bbox": [0, 0, 1, 1], "score": float(rng.uniform(0, 0.5)),
                       "segmentation": rle.mask_to_rle(rng.random((h, w)) < 0.2)})
    return gt, dt


@pytest.mark.parametrize("seed", range(3))
def test_coco_eval_segm_matches_jax(seed):
    gt, dt = _segm_rows(np.random.default_rng(seed))
    got = coco.COCOEvalLite(gt, dt, iou_type="segm").evaluate().accumulate()
    ref = jax_coco.COCOEvalLite(gt, dt, iou_type="segm").evaluate().accumulate()
    np.testing.assert_array_equal(got.precision, ref.precision)
    np.testing.assert_array_equal(got.recall, ref.recall)
    assert got.summarize() == ref.summarize()
    assert got.summarize()["map50"] > 0
    assert (coco.score_detections_json(dt, gt, iou_type="segm")
            == jax_coco.score_detections_json(dt, gt, iou_type="segm"))


# ---------------------------------------------------------------------------
# a segmentation set and a checkpoint both packages read
# ---------------------------------------------------------------------------

def _mask_weights(cfg, seed):
    """random_segmenter_weights with the Segment head's coefficient biases
    drawn wide, so that predicted masks cover parts of their boxes and
    overlap the GT masks (the mask IoUs are not all 0)."""
    sd = random_segmenter_weights(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    no = 5 + cfg["nc"] + 32
    for k in sd:
        if k.startswith("model.24.m.") and k.endswith("bias"):
            b = sd[k].reshape(-1, no)
            b[:, 5 + cfg["nc"]:] = rng.normal(0, 3, b[:, 5 + cfg["nc"]:].shape)
    return sd


@pytest.fixture(scope="module")
def seg_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg_val")
    d = write_polygon_dataset(root / "data", SHAPES * 3, seed=3)
    data = root / "seg.yaml"
    data.write_text(yaml.safe_dump(d))
    ckpt = save_jax_checkpoint(CFG, root / "seg.ckpt", weights=_mask_weights)
    return root, data, ckpt


@pytest.mark.parametrize("coco91", [False, True])
def test_gt_from_dataset_segm_matches_jax(seg_case, coco91):
    root, _, _ = seg_case
    kw = dict(img_size=IMGSZ, batch_size=4, workers=1, masks=True)
    ds, _ = create_loader(str(root / "data" / "images" / "val"), **kw)
    jds, _ = jax_create_loader(str(root / "data" / "images" / "val"), **kw)
    got = coco.gt_from_dataset_segm(ds, coco91=coco91)
    assert got == jax_coco.gt_from_dataset_segm(jds, coco91=coco91)
    assert len(got) == sum(len(lb) for lb in ds.labels) > 0


def test_segm_json_rows_match_jax():
    """COCO segm rows of one image (mask from coeffs x proto, crop, resize to
    the letterbox, un-letterbox to the native size): equal bboxes, scores
    and classes; equal RLE strings but for at most one row, whose mask
    differs in at most 2 pixels."""
    rng = np.random.default_rng(12)
    n, hm, nm = 40, 16, 32
    xy = rng.uniform(0, 48, (n, 2))
    pred = np.concatenate([xy, xy + rng.uniform(4, 32, (n, 2)), rng.uniform(0, 1, (n, 1)),
                           rng.integers(0, 3, (n, 1)), rng.normal(0, 1, (n, nm))],
                          1).astype(np.float32)
    proto = rng.normal(0, 1, (hm, hm, nm)).astype(np.float32)
    for native in ((48, 64), (64, 64), (100, 75), (32, 32)):
        got = run_segment._segm_json_rows(pred, proto, "0007.bmp", native, (64, 64), True)
        ref = jax_run_segment._segm_json_rows(pred, proto, "0007.bmp", native, (64, 64), True)
        assert len(got) == len(ref) == n
        same = 0
        for g, r in zip(got, ref):
            assert {k: g[k] for k in ("image_id", "category_id", "bbox", "score")} == \
                {k: r[k] for k in ("image_id", "category_id", "bbox", "score")}
            if g["segmentation"] == r["segmentation"]:
                same += 1
            else:  # the masks differ only by a pixel or two
                a, b = rle.rle_to_mask(g["segmentation"]), rle.rle_to_mask(r["segmentation"])
                assert (a != b).sum() <= 2
        assert same >= n - 1
        assert got[0]["image_id"] == 7 and got[0]["category_id"] in (1, 2, 3)


# ---------------------------------------------------------------------------
# evaluate_segment and segment val
# ---------------------------------------------------------------------------

def _jax_eval(ckpt, data_root, overlap, save_json=None):
    payload, meta = jax_load_checkpoint(ckpt)
    model = JaxSegmentationModel(meta["cfg"], anchors=meta.get("anchors"))
    _, loader = jax_create_loader(str(data_root / "images" / "val"), img_size=IMGSZ,
                                  batch_size=4, augment=False, masks=True, overlap=overlap)
    return jax_run_segment.evaluate_segment(model, jax_variables(payload), loader,
                                            overlap=overlap, save_json=save_json), loader


def _recorded(monkeypatch, module):
    """Record process_batch's calls in ``module``: (number of predictions,
    of labels, the mask IoU matrix or None)."""
    calls = []
    real = module.process_batch

    def record(detections, labels, iouv, iou=None, **kw):
        calls.append((len(detections), len(labels), None if iou is None else np.array(iou)))
        return real(detections, labels, iouv, iou=iou, **kw)

    monkeypatch.setattr(module, "process_batch", record)
    return calls


@pytest.mark.parametrize("overlap", [True, False])
def test_evaluate_segment_matches_jax(seg_case, monkeypatch, overlap):
    """The same .ckpt and images: box and mask P/R/mAP50/mAP within 1e-3,
    the same detection counts per image, and the mask IoU matrices (GT x
    predictions at image resolution) within 1e-2."""
    root, _, ckpt = seg_case
    jcalls = _recorded(monkeypatch, jax_run_segment)
    ref, _ = _jax_eval(ckpt, root / "data", overlap)
    pcalls = _recorded(monkeypatch, run_segment)
    seg = Segmenter(str(ckpt), device="cpu")
    _, loader = create_loader(str(root / "data" / "images" / "val"), img_size=IMGSZ,
                              batch_size=4, workers=1, masks=True, overlap=overlap)
    got = run_segment.evaluate_segment(seg.forward, loader, "cpu", seg.nc, overlap=overlap)
    assert got["images"] == ref["images"] == 12
    for part in ("box", "mask"):
        for k in ("p", "r", "map50", "map"):
            assert got[part][k] == pytest.approx(float(ref[part][k]), abs=1e-3), (part, k)
    assert got["fitness"] == pytest.approx(float(ref["fitness"]), abs=1e-3)
    assert [c[:2] for c in pcalls] == [c[:2] for c in jcalls]
    assert sum(c[0] for c in pcalls) >= 12  # detections to match
    ious = [(a[2], b[2]) for a, b in zip(pcalls, jcalls) if b[2] is not None]
    assert ious and all(a is not None for a, _ in ious)
    for a, b in ious:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
    assert max(b.max() for _, b in ious) > 0.05  # masks overlap their GT


def test_segment_val_cli_save_json_matches_jax(seg_case, tmp_path):
    """``segment val --save-json`` (a subprocess, as a user runs it) against
    the JAX evaluate_segment with save_json: the same number of rows, and
    the COCO bbox and segm scores of the two JSON files, each scored by its
    own package against its own ground truth, within 1e-4."""
    root, data, ckpt = seg_case
    ref, jloader = _jax_eval(ckpt, root / "data", True, save_json=tmp_path / "jax.json")
    proc = subprocess.run(
        [sys.executable, "-m", "yolov5_tpu_torch.segment", "val", "--device", "cpu",
         "--data", str(data), "--weights", str(ckpt), "--imgsz", str(IMGSZ), "--batch-size",
         "4", "--workers", "1", "--save-json", str(tmp_path / "port.json")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = json.loads((tmp_path / "port.json").read_text())
    ref_rows = json.loads((tmp_path / "jax.json").read_text())
    assert len(rows) == len(ref_rows) > 0
    for mode, gt_fn in (("bbox", jax_coco.gt_from_dataset),
                        ("segm", jax_coco.gt_from_dataset_segm)):
        ref_scores = jax_coco.score_detections_json(ref_rows, gt_fn(jloader.ds), iou_type=mode)
        for k, v in ref_scores.items():
            assert out[f"coco_{mode}"][k] == pytest.approx(v, abs=1e-4), (mode, k)
    for part in ("box", "mask"):
        assert out[part]["map"] == pytest.approx(float(ref[part]["map"]), abs=1e-3)
