"""The port's exported backends against the JAX package's: ``Detector`` on
the .onnx of both packages' exports, ``evaluator.run`` and ``infer.run``
(the val and detect CLIs) on it, OpenCV DNN, the KServe v2 client and the
``triton+http://`` Detector against an in-process server, the REST client
against the port's service, the JAX package's TensorFlow exports, and the
port's sources, which import no JAX. yolov5n at 160 px (64 for TF), b2,
on the CPU."""

import json
import re
import sys
import threading
import urllib.error
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from torch_port_helpers import (assert_same_records, random_detector_weights,
                                save_jax_checkpoint, write_shapes_dataset, yolov5n_cfg)
from yolov5_tpu_torch import export as export_t
from yolov5_tpu_torch.data.imageio import bmp_bytes, imwrite
from yolov5_tpu_torch.data.letterbox import letterbox
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.ops.nms import detections_to_numpy
from yolov5_tpu_torch.onnx.runtime import Runtime

REPO = Path(__file__).resolve().parents[1]
IMGSZ, BATCH, CONF = 160, 2, 0.25
SHAPES = [(120, 160), (160, 120), (160, 160), (90, 160)] * 2


def head_scaled_weights(cfg, seed):
    """random_detector_weights with the Detect convs' weights 0.1x and their
    biases N(0, 1): boxes of 2-800 px (no degenerate ones, whose IoUs turn
    last-digit differences into other suppressions) and a few hundred
    detections an image at conf 0.25."""
    sd = random_detector_weights(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    for k in sd:
        if k.startswith("model.24.m."):
            sd[k] = (rng.normal(0.0, 1.0, sd[k].shape).astype(np.float32) if k.endswith("bias")
                     else sd[k] * np.float32(0.1))
    return sd


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A JAX .ckpt of yolov5n, both packages' .onnx of it (b2, 160 px), the
    port's fused .ckpt, and a generated BMP val set with its YAML."""
    from yolov5_tpu.export import run as jax_export

    root = tmp_path_factory.mktemp("backends")
    w = save_jax_checkpoint(yolov5n_cfg(3), root / "w.ckpt", weights=head_scaled_weights)
    port = export_t.run(weights=str(w), imgsz=IMGSZ, batch_size=BATCH, include=("ckpt", "onnx"),
                        output_dir=str(root / "port"), device="cpu")
    jax_arts = jax_export(weights=str(w), imgsz=IMGSZ, batch_size=BATCH, include=("onnx",),
                          output_dir=str(root / "jax"))
    data = write_shapes_dataset(root / "data", SHAPES, ext=".bmp", write=imwrite)
    (root / "data.yaml").write_text(yaml.safe_dump(data))
    return {"root": root, "ckpt": w, "port": port["onnx"], "fused": port["ckpt"],
            "jax": jax_arts["onnx"], "yaml": root / "data.yaml"}


def _batch(n=BATCH, seed=0):
    """A letterboxed uint8 RGB batch of textured images with bright boxes."""
    rng = np.random.default_rng(seed)
    ims = []
    for h, w in SHAPES[:n]:
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        im[h // 4:h // 2, w // 4:w // 2] = (40, 120, 250)
        ims.append(letterbox(im, IMGSZ)[0][..., ::-1])
    return np.ascontiguousarray(np.stack(ims))


def assert_same_rows(a, b):
    """Per image equal counts and a one-to-one match: same class, score
    within 1e-4, box within 1e-3 px + 1e-5 of the coordinate (random
    weights draw boxes a thousand px wide, whose f32 roundings differ by
    more than 1e-3 px between two graphs)."""
    assert len(a) == len(b)
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), f"image {i}: {len(ra)} vs {len(rb)} detections"
        free = np.ones(len(rb), bool)
        for r in ra:
            hit = (free & (rb[:, 5] == r[5]) & (np.abs(rb[:, 4] - r[4]) <= 1e-4)
                   & (np.abs(rb[:, :4] - r[:4]) <= 1e-3 + 1e-5 * np.abs(r[:4])).all(1))
            assert hit.any(), f"image {i}: no match for detection {r}"
            free[np.flatnonzero(hit)[0]] = False


def _jax_rows(det, images, conf=CONF):
    from yolov5_tpu.ops.nms import detections_to_numpy as jax_to_numpy

    return jax_to_numpy(det(images, conf_thres=conf))


def test_detector_onnx_matches_jax(case):
    """Both packages' .onnx of the same weights in both packages' Detector on
    the same letterboxed batch: equal counts, boxes within 1e-3 px, equal
    classes (and the port's .onnx is an onnx backend with the file's meta)."""
    from yolov5_tpu.infer import Detector as JaxDetector

    images = _batch()
    ref = _jax_rows(JaxDetector(str(case["jax"])), images)
    assert sum(map(len, ref)) >= BATCH
    for w in (case["port"], case["jax"]):
        det = Detector(str(w), device="cpu")
        assert (det.backend, det.model, det.imgsz, det.nc) == ("onnx", None, IMGSZ, 3)
        assert det.names == {0: "class0", 1: "class1", 2: "class2"}
        assert_same_rows(detections_to_numpy(det(images, conf_thres=CONF)), ref)
    assert_same_rows(_jax_rows(JaxDetector(str(case["port"])), images), ref)


def test_exported_backend_rules(case):
    """An exported backend has no raw maps and no TTA (ValueError, as the JAX
    Detector), takes only its export batch (ValueError naming the shapes),
    and runs on the card unless asked for the CPU."""
    det = Detector(str(case["port"]), device="cpu")
    images = _batch()
    with pytest.raises(ValueError, match="TTA"):
        det(images, augment=True)
    with pytest.raises(ValueError, match="TTA"):
        det.forward_tta(images)
    with pytest.raises(ValueError, match="raw maps"):
        det.forward_maps(images)
    with pytest.raises(ValueError, match=r"exported for \(2, 160, 160, 3\)"):
        det(images[:1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Detector(str(case["port"]))


def test_val_onnx_matches_jax_and_ckpt(case, capsys):
    """evaluator.run on the .onnx in both packages: P, R, mAP50, mAP50-95
    within 1e-4; the port's equal to its own .ckpt run at rect=False within
    1e-4. The export size overrides --imgsz (warned) and TTA is ignored
    (warned), as in the JAX evaluator."""
    from yolov5_tpu.eval.evaluator import run as jax_val
    from yolov5_tpu_torch.eval.evaluator import run as val

    kw = dict(data=str(case["yaml"]), batch_size=BATCH, conf_thres=0.001, workers=0,
              verbose=False)
    port = val(weights=str(case["port"]), imgsz=96, augment=True, device="cpu", **kw)
    out = capsys.readouterr().out
    assert "does not match the export size 160" in out and "TTA" in out
    ref = jax_val(weights=str(case["jax"]), imgsz=IMGSZ, **kw)
    ckpt = val(weights=str(case["ckpt"]), imgsz=IMGSZ, rect=False, device="cpu", **kw)
    assert port["images"] == ref["images"] == len(SHAPES)
    assert ref["map50"] > 0
    for k in ("mp", "mr", "map50", "map"):
        assert abs(port[k] - ref[k]) <= 1e-4, k
        assert abs(port[k] - ckpt[k]) <= 1e-4, k


def test_val_batch_other_than_export_raises_in_both(case):
    """The graph's batch is fixed: val at another batch raises ValueError in
    both packages (the JAX runtime at its first Reshape, the port's at the
    input)."""
    from yolov5_tpu.eval.evaluator import run as jax_val
    from yolov5_tpu_torch.eval.evaluator import run as val

    kw = dict(data=str(case["yaml"]), imgsz=IMGSZ, batch_size=3, workers=0, verbose=False)
    with pytest.raises(ValueError):
        jax_val(weights=str(case["jax"]), **kw)
    with pytest.raises(ValueError, match="exported for"):
        val(weights=str(case["port"]), device="cpu", **kw)


def test_detect_run_onnx_writes_detector_rows(case, capsys):
    """infer.run (the detect CLI) on the .onnx writes, for every image, the
    txt rows of Detector.__call__ on the same letterboxed batch. An --imgsz
    other than the export's is overridden with a warning (the JAX detect
    hands the graph the wrong size: ROADMAP §3)."""
    from yolov5_tpu_torch.data.letterbox import scale_boxes_np
    from yolov5_tpu_torch.infer import run

    src = sorted((case["root"] / "data" / "images" / "val").glob("*.bmp"))[:4]
    results, save_dir = run(weights=str(case["port"]), source=[str(p) for p in src],
                            imgsz=96, batch_size=BATCH, conf_thres=CONF, save_txt=True,
                            save_img=False, project=str(case["root"] / "runs"), device="cpu",
                            verbose=False)
    assert "--imgsz 96 does not match the export size 160" in capsys.readouterr().out
    from yolov5_tpu.infer import run as jax_run

    with pytest.raises(ValueError):  # the JAX runtime at the graph's first Reshape
        jax_run(weights=str(case["jax"]), source=str(src[0].parent), imgsz=96,
                batch_size=BATCH, save_img=False, project=str(case["root"] / "runs"),
                name="jax_detect", verbose=False)
    det = Detector(str(case["port"]), device="cpu")
    from yolov5_tpu_torch.data.imageio import imread

    im0s = [imread(p) for p in src]
    lb = np.stack([letterbox(im, IMGSZ)[0][..., ::-1] for im in im0s])
    rows = [r for b in range(0, len(src), BATCH)
            for r in detections_to_numpy(det(lb[b:b + BATCH], conf_thres=CONF))]
    assert sum(map(len, rows)) > 0
    for p, r, im0 in zip(src, rows, im0s):
        h0, w0 = im0.shape[:2]
        r[:, :4] = scale_boxes_np(lb.shape[1:3], r[:, :4], im0.shape[:2])
        want = [" ".join(f"{v:.6g}" for v in (int(c), (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                                              (x2 - x1) / w0, (y2 - y1) / h0))
                for x1, y1, x2, y2, _, c in r]
        txt = save_dir / "labels" / f"{p.stem}.txt"
        assert (txt.read_text().splitlines() if txt.exists() else []) == want


def test_dnn_backend(case, monkeypatch):
    """OpenCV's DNN module runs the port's .onnx within 2e-3 of the port's
    runtime (tests/test_onnx.py's check); without OpenCV, dnn raises
    ImportError naming it and picks no other backend."""
    images = _batch()
    ref = Detector(str(case["port"]), device="cpu").forward(images).numpy()
    cv2 = pytest.importorskip("cv2")
    if hasattr(cv2, "dnn"):
        det = Detector(str(case["port"]), device="cpu", dnn=True)
        assert det.backend == "onnx-dnn" and det.nc == 3
        got = det.forward(images).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        Detector(str(case["port"]), device="cpu", dnn=True)


@pytest.fixture()
def kserve(case):
    """A stdlib KServe v2 server on 127.0.0.1 that serves the port's .onnx
    through the port's runtime (onnx/kserve.py; the fixture pattern of
    tests/test_net_remote.py)."""
    from yolov5_tpu_torch.onnx.kserve import serve_kserve

    with serve_kserve(Runtime(case["port"].read_bytes(), device="cpu")) as url:
        yield url


def test_kserve_client_and_triton_detector(case, kserve):
    """The port's KServeV2Client (a copy of the JAX one) gives what the JAX
    client gives, the runtime's decoded output; Detector("triton+http://")
    gives the .onnx Detector's detections, names and nc from the server."""
    from yolov5_tpu.remote import KServeV2Client as JaxClient
    from yolov5_tpu_torch.remote import KServeV2Client

    images = _batch()
    client = KServeV2Client(f"triton+{kserve}/det")
    assert (client.model, client.input_name, client.output_name) == ("det", "images", "output_0")
    with pytest.raises(urllib.error.HTTPError, match="404"):
        KServeV2Client(f"triton+{kserve}/other")
    out = client.infer(images)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, JaxClient(f"triton+{kserve}/det").infer(images))
    ref_det = Detector(str(case["port"]), device="cpu")
    np.testing.assert_array_equal(out, ref_det.forward(images).numpy())
    det = Detector(f"triton+{kserve}/det", imgsz=IMGSZ, device="cpu")
    assert (det.backend, det.nc, det.names[0]) == ("triton", 3, "class0")
    got = detections_to_numpy(det(images, conf_thres=CONF))
    ref = detections_to_numpy(ref_det(images, conf_thres=CONF))
    assert sum(map(len, ref)) >= BATCH
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_rest_client_against_port_serve(case):
    """RestClient (the port's copy and the JAX original) against the port's
    serve.make_handler running the b1 .onnx: health, and the records of a
    direct Detector call with the boxes scaled back."""
    from yolov5_tpu.remote import RestClient as JaxRestClient
    from yolov5_tpu_torch.data.letterbox import scale_boxes_np
    from yolov5_tpu_torch.remote import RestClient
    from yolov5_tpu_torch.serve import detections_to_records, make_handler

    arts = export_t.run(weights=str(case["ckpt"]), imgsz=IMGSZ, batch_size=1,
                        include=("onnx",), output_dir=str(case["root"] / "b1"), device="cpu")
    det = Detector(str(arts["onnx"]), device="cpu")
    handler = make_handler({"m": det}, "k1", CONF)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        rng = np.random.default_rng(3)
        im0 = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
        im0[30:60, 40:80] = (40, 120, 250)
        lb = letterbox(im0, IMGSZ)[0]
        rows = detections_to_numpy(det(lb[..., ::-1][None].copy(), conf_thres=CONF))[0]
        rows[:, :4] = scale_boxes_np(lb.shape[:2], rows[:, :4], im0.shape[:2])
        want = detections_to_records(rows, det.names)
        assert want
        for cls in (RestClient, JaxRestClient):
            client = cls(url, model="m", api_key="k1")
            assert client.health() == {"ok": True, "models": ["m"]}
            assert_same_records(client.detect_bytes(bmp_bytes(im0)), want)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)
        handler.executor.shutdown()


@pytest.mark.slow  # ~21 s alone on the CPU: jax2tf and the TFLite converter
def test_tf_backends_match_jax(tmp_path):
    """The JAX package's SavedModel and TFLite exports of yolov5n (64 px) in
    the port's Detector on the CPU: the JAX Detector's forward and
    detections on the same batch."""
    from yolov5_tpu.export import run as jax_export
    from yolov5_tpu.infer import Detector as JaxDetector

    pytest.importorskip("tensorflow")
    w = save_jax_checkpoint(yolov5n_cfg(3), tmp_path / "w.ckpt", weights=head_scaled_weights)
    arts = jax_export(weights=str(w), imgsz=64, include=("saved_model", "tflite"),
                      output_dir=str(tmp_path))
    images = np.random.default_rng(6).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    for fmt in ("saved_model", "tflite"):
        det, jd = Detector(str(arts[fmt]), device="cpu"), JaxDetector(str(arts[fmt]))
        assert (det.backend, det.model, det.imgsz, det.nc) == (fmt, None, 64, 3)
        np.testing.assert_array_equal(det.forward(images).numpy(),
                                      np.asarray(jd._forward(None, images)))
        ref = _jax_rows(jd, images)
        assert sum(map(len, ref)) > 0
        assert_same_rows(detections_to_numpy(det(images, conf_thres=CONF)), ref)


def test_port_sources_import_no_jax():
    """No module of yolov5_tpu_torch/, and not chip_smoke.py, imports JAX,
    flax or any yolov5_tpu module (the JAX package's __init__ loads JAX)."""
    bad = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|yolov5_tpu)(?:[.\s]|$)", re.M)
    files = sorted((REPO / "yolov5_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 50
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text())]
    assert not hits, hits
