"""``train.run`` from a zoo config (the new families and the zoo-layers
model of tests/test_torch_zoo_layers.py at width 0.125 / depth 0.33 as
dicts, 64 px, b4, f32, device augmentation from the device cache, one
epoch on 8 BMPs): finite losses, its EMA validation reproduced by
``eval.evaluator.run`` on best.ckpt (within 1e-6), best.ckpt read by the
JAX package (its unfused model on the checkpoint's EMA variables gives the
port's raw maps within 1e-4 of their largest value), and the detect CLI
and the HTTP service on best.ckpt giving the same detections of one
image."""

import csv
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_zoo_layers import ZOO_CFG
from tests.torch_port_helpers import (assert_maps_close, nchw, small_cfg,
                                      write_shapes_dataset)
from yolov5_tpu.models import DetectionModel as JaxModel
from yolov5_tpu.utils.checkpoint import load_checkpoint as jax_load
from yolov5_tpu.utils.checkpoint import variables_from_checkpoint as jax_vars
import yolov5_tpu_torch.detect as detect_cli
import yolov5_tpu_torch.serve as serve
from yolov5_tpu_torch.data.imageio import bmp_bytes, imread, imwrite
from yolov5_tpu_torch.eval import evaluator
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.train.run import run

CONFIGS = ["yolov3", "yolov3-spp", "yolov3-tiny", "yolov5s-ghost", "yolov5s-transformer",
           "zoo-layers"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_train")
    d = write_shapes_dataset(root, [(64, 80), (80, 64)] * 4, ext=".bmp", split="train",
                             write=imwrite)
    write_shapes_dataset(root, [(64, 80), (80, 64)] * 2, ext=".bmp", split="val", write=imwrite,
                         seed=1)
    d.update(train="images/train", val="images/val")
    path = root / "data.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


@pytest.mark.parametrize("name", CONFIGS)
def test_train_run_zoo_config(name, data, tmp_path):
    cfg = ZOO_CFG if name == "zoo-layers" else small_cfg(name)
    _, results, save_dir = run(str(data), cfg=cfg, epochs=1, batch_size=4, imgsz=64,
                               device="cpu", dtype="float32", device_aug=True, cache="device",
                               workers=1, project=str(tmp_path), name=name)
    with open(save_dir / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert np.isfinite([float(rows[0][f"train/{k}"]) for k in ("box", "obj", "cls", "total")]).all()
    again = evaluator.run(str(data), weights=str(save_dir / "best.ckpt"), imgsz=64, batch_size=4,
                          rect=False, device="cpu", verbose=False)
    for k in ("mp", "mr", "map50", "map"):
        assert abs(again[k] - results[k]) <= 1e-6, k

    payload, meta = jax_load(save_dir / "best.ckpt")
    variables = jax_vars(payload, prefer_ema=True)
    jm = JaxModel(cfg, anchors=meta.get("anchors"), packed_stem=False)
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = jm.apply(variables, jnp.asarray(x))
    port = DetectionModel(cfg, anchors=meta.get("anchors"))
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert_maps_close(got, ref, 1e-4, name)

    # the detect CLI and the service on best.ckpt, at conf 0.001: one image's rows
    image = sorted((data.parent / "images" / "val").glob("*.bmp"))[0]
    detect_cli.main(["--weights", str(save_dir / "best.ckpt"), "--source", str(image),
                     "--imgsz", "64", "--conf-thres", "0.001", "--save-txt", "--nosave",
                     "--device", "cpu", "--project", str(tmp_path), "--name", "detect"])
    txt = (tmp_path / "detect" / "labels" / f"{image.stem}.txt").read_text().split("\n")
    classes = sorted(int(line.split()[0]) for line in txt if line)
    records = _serve_one(Detector(str(save_dir / "best.ckpt"), imgsz=64, device="cpu"),
                         bmp_bytes(imread(image)))
    assert classes and sorted(r["class"] for r in records) == classes


def _serve_one(det, body):
    """One raw-body POST to ``serve``'s handler for ``det`` (conf 0.001) on
    a server at 127.0.0.1: its records."""
    handler = serve.make_handler({"m": det}, None, 0.001)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_port}/v1/object-detection/m",
                                     data=body, method="POST",
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)
        handler.executor.shutdown()
