"""The validation loop: yolov5_tpu.eval.evaluator.evaluate and its port on
the same weights (via from_jax_variables) and the same BMP dataset, read by
each package's own loader (yolov5n, nc 3, 160 px, f32 on the CPU)."""

import json

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (assert_same_rows, random_detector_weights,
                                      write_shapes_dataset, yolov5n_cfg)
from yolov5_tpu.data.dataset import create_loader as jax_create_loader
from yolov5_tpu.eval import evaluator as jax_evaluator
from yolov5_tpu.infer import Detector as JaxDetector
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.eval import evaluator
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.models.weights import from_jax_variables

CFG = yolov5n_cfg(3)
IMGSZ = 160
# (h, w): padding only, an upscale and a downscale (cv2.resize in both)
SHAPES = [(120, 160), (160, 120), (160, 160), (90, 160), (200, 150), (64, 160),
          (160, 160), (130, 100)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(images dir, JAX detector, port detector) on the same weights."""
    root = tmp_path_factory.mktemp("val")
    write_shapes_dataset(root, SHAPES, ext=".bmp")
    w = root / "w.pt"
    torch.save({k: torch.from_numpy(v) for k, v in random_detector_weights(CFG, 0).items()}, w)
    jdet = JaxDetector(str(w), cfg=CFG, imgsz=IMGSZ)
    det = Detector(from_jax_variables(jdet.variables), cfg=CFG, imgsz=IMGSZ, device="cpu")
    return root / "images" / "val", jdet, det


def _capture(monkeypatch, module):
    """Per-image detections (letterbox space) of every batch ``module``'s
    evaluate scores, padded images included."""
    rows = []
    real = module.detections_to_numpy
    monkeypatch.setattr(module, "detections_to_numpy",
                        lambda d: rows.extend(real(d)) or real(d))
    return rows


def _both(pair, monkeypatch, tmp_path, rect=True, **kw):
    images, jdet, det = pair
    jrows, prows = _capture(monkeypatch, jax_evaluator), _capture(monkeypatch, evaluator)
    extra = {}
    if kw.pop("save", False):
        extra = {"jax": dict(save_txt_dir=tmp_path / "jax", save_json=tmp_path / "jax.json"),
                 "port": dict(save_txt_dir=tmp_path / "port", save_json=tmp_path / "port.json")}
    _, jl = jax_create_loader(str(images), img_size=IMGSZ, batch_size=3, rect=rect,
                              stride=32, native=False)
    ref = jax_evaluator.evaluate(jdet.model, jdet.variables, jl, **kw, **extra.get("jax", {}))
    _, loader = create_loader(str(images), img_size=IMGSZ, batch_size=3, rect=rect, stride=32)
    got = evaluator.evaluate(det.forward, loader, "cpu", **kw, **extra.get("port", {}))
    return got, ref, prows, jrows


def _assert_same_results(got, ref):
    """mAP within 1e-4: the detections agree to ~1e-6 in score, so the ranks
    of true and false positives can only trade places between near-equal
    scores."""
    assert got["images"] == ref["images"] == len(SHAPES)
    assert set(got["per_class"]) == set(ref["per_class"])
    for k in ("map50", "map"):
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])


@pytest.mark.parametrize("rect", [True, False])
@pytest.mark.parametrize("native_space", [True, False])
def test_evaluate_matches_jax(pair, monkeypatch, tmp_path, rect, native_space):
    """Detections: equal counts per image and boxes within 1e-3 px (the
    tolerance of tests/test_torch_detector.py); metrics within 1e-4."""
    got, ref, prows, jrows = _both(pair, monkeypatch, tmp_path, rect=rect,
                                   native_space=native_space)
    assert sum(len(r) for r in prows) > 0
    assert_same_rows(prows, jrows, atol=1e-3)
    _assert_same_results(got, ref)


@pytest.mark.parametrize("native_space", [True, False])
def test_evaluate_hybrid_matches_jax(pair, monkeypatch, tmp_path, native_space):
    """save_hybrid: the labels, injected at confidence 1, rank first and
    match themselves, so mAP50 is the 101-point maximum, 0.995, in both."""
    got, ref, prows, jrows = _both(pair, monkeypatch, tmp_path, native_space=native_space,
                                   save_hybrid=True)
    assert_same_rows(prows, jrows, atol=1e-3)
    _assert_same_results(got, ref)
    assert got["map50"] == pytest.approx(0.995)


def _read_txt(d):
    return {p.name: np.loadtxt(p, ndmin=2).reshape(-1, 5) for p in sorted(d.glob("*.txt"))}


def test_evaluate_txt_and_json_match_jax(pair, monkeypatch, tmp_path):
    """save_txt and save_json: the same files, rows and values (normalized
    boxes within 1e-5; json boxes and scores, each rounded to 1e-3 px and
    1e-5, within 2e-3), and the same COCO summary within 1e-4."""
    got, ref, _, _ = _both(pair, monkeypatch, tmp_path, save=True)
    tj, tp = _read_txt(tmp_path / "jax"), _read_txt(tmp_path / "port")
    assert tj.keys() == tp.keys() and len(tp) == len(SHAPES)
    for name in tj:
        a, b = tp[name], tj[name]
        assert_same_rows([np.concatenate([a[:, 1:], np.ones((len(a), 1)), a[:, :1]], 1)],
                         [np.concatenate([b[:, 1:], np.ones((len(b), 1)), b[:, :1]], 1)],
                         atol=1e-5)
    rows = {}
    for side in ("jax", "port"):
        js = json.loads((tmp_path / f"{side}.json").read_text())
        rows[side] = {}
        for r in js:
            rows[side].setdefault(r["image_id"], []).append(
                [*r["bbox"], r["score"], r["category_id"]])
    assert rows["jax"].keys() == rows["port"].keys()
    for k in rows["jax"]:
        a, b = np.array(rows["port"][k]), np.array(rows["jax"][k])
        assert_same_rows([a], [b], atol=2e-3)
    assert got["coco"].keys() == ref["coco"].keys()
    for k, v in ref["coco"].items():
        assert abs(got["coco"][k] - v) <= 1e-4, k


def test_run_cuda_without_card_raises(pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluator.run({"val": str(pair[0]), "nc": 3}, cfg=CFG, imgsz=IMGSZ, device="cuda")
