"""The port's classification run, validation, checkpoints, CLI and hub
against the JAX package: ``run`` on the host path for 3 epochs from the JAX
model's initial weights, both packages' ``validate_classify`` on both
packages' ``best.ckpt``, the device-cache path, the CLI without OpenCV and
without JAX, and ``hub.load(task="classify")``."""

import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import write_imagefolder
from yolov5_tpu_torch import hub
from yolov5_tpu_torch.models import weights as W
from yolov5_tpu_torch.models.yolo import ClassificationModel
from yolov5_tpu_torch.train import run_classify

REPO = Path(__file__).resolve().parents[1]
CLASSES = ["ants", "bees", "cats"]
SHAPES = ((48, 64), (60, 48), (56, 56), (40, 72))
IMGSZ, BATCH, EPOCHS = 48, 8, 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """24 train images (3 full b8 batches) and 12 val images (one full b8
    batch, the partial one dropped by the training-time validation)."""
    root = tmp_path_factory.mktemp("cls")
    write_imagefolder(root / "train", CLASSES, 8, SHAPES, seed=1)
    write_imagefolder(root / "val", CLASSES, 4, SHAPES, seed=2)
    return root


def _rows(save_dir):
    with open(Path(save_dir) / "results.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX package's run and the port's, host path, SGD, from the JAX
    model's initial weights (seed 0)."""
    from yolov5_tpu.models import ClassificationModel as JaxCls
    from yolov5_tpu.train.run_classify import run as jax_run

    out = tmp_path_factory.mktemp("runs")
    # SGD at the default lr0 (0.001): Adam's steps are about lr·sign(g), and
    # where g is within float rounding of 0 the sign differs between the
    # packages (test_torch_classify.py::test_train_step_matches_jax); at b8
    # such differences grow about tenfold a step, past 1e-4 in the loss
    # within 9 steps, as SGD's do at lr0 0.01. SGD at 0.001 keeps each
    # step's loss within 2e-5.
    kw = dict(data=str(data), cfg="yolov5n", epochs=EPOCHS, batch_size=BATCH, imgsz=IMGSZ,
              optimizer="sgd", verbose=False, device_aug=False, exist_ok=True)
    _, jax_dir = jax_run(project=str(out), name="jax", **kw)
    init = W.from_jax_variables(JaxCls("yolov5n", nc=len(CLASSES)).variables)

    def from_jax_init(cfg, nc=1000, seed=0, **k):
        model = ClassificationModel(cfg, nc=nc, seed=seed, **k)
        if not k.get("fused"):
            assert not W.load_weights(model, init)
        return model

    mp = pytest.MonkeyPatch()
    mp.setattr(run_classify, "ClassificationModel", from_jax_init)
    try:
        _, port_dir = run_classify.run(project=str(out), name="port", device="cpu", **kw)
    finally:
        mp.undo()
    return Path(jax_dir), Path(port_dir)


def test_run_host_path_matches_jax(runs):
    """Per epoch: train/loss within 1e-4 and train/acc, val/top1 and
    val/top5 equal; the CSV's columns are the JAX run's."""
    jax_rows, port_rows = (_rows(d) for d in runs)
    assert len(jax_rows) == len(port_rows) == EPOCHS
    assert list(jax_rows[0]) == list(port_rows[0])
    for j, p in zip(jax_rows, port_rows):
        assert float(p["train/loss"]) == pytest.approx(float(j["train/loss"]), abs=1e-4)
        for k in ("train/acc", "val/top1", "val/top5"):
            assert float(p[k]) == float(j[k]), (k, p[k], j[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_best_ckpt_reads_across_packages(runs, data, writer):
    """Each package's validate_classify on either package's best.ckpt:
    equal top-1, top-5 and per-class rows; the loss within 1e-5."""
    from yolov5_tpu.train.run_classify import validate_classify as jax_validate

    ckpt = (runs[1] if writer == "port" else runs[0]) / "best.ckpt"
    meta = json.loads(Path(str(ckpt) + ".json").read_text())
    assert meta["nc"] == 3 and meta["imgsz"] == IMGSZ and meta["anchors"] == []
    assert meta["names"] == {str(i): c for i, c in enumerate(CLASSES)}
    ref = jax_validate(str(ckpt), str(data), batch_size=5, verbose=False)
    got = run_classify.validate_classify(str(ckpt), str(data), batch_size=5, verbose=False,
                                         device="cpu")
    assert got["images"] == ref["images"] == 12
    assert (got["top1"], got["top5"], got["per_class"]) == (ref["top1"], ref["top5"],
                                                            ref["per_class"])
    assert got["loss"] == pytest.approx(ref["loss"], abs=1e-5)


def test_port_checkpoint_layout(runs):
    """last.ckpt and best.ckpt hold no optimizer state; the JAX reader
    sees the Dense kernel as (in, out)."""
    from yolov5_tpu.utils.checkpoint import load_checkpoint

    for name in ("last.ckpt", "best.ckpt"):
        payload, meta = load_checkpoint(runs[1] / name)
        assert "opt_state" not in payload and "torch_opt_state" not in payload
        assert np.asarray(payload["ema_params"]["layers_10"]["linear"]["kernel"]).shape == (1280, 3)
        assert meta["cfg"] == "yolov5n" and meta["stride"] == [32]
    assert json.loads((runs[1] / "last.ckpt.json").read_text())["epoch"] == EPOCHS - 1


def test_device_cache_path_runs_and_learns(data, tmp_path):
    """The device-resident path (on the CPU here): the set is cached once,
    each step augments on the device, and the loss falls."""
    best, save_dir = run_classify.run(str(data), cfg="yolov5n", epochs=4, batch_size=BATCH,
                                      imgsz=32, lr0=0.005, project=str(tmp_path), name="dev",
                                      verbose=True, device="cpu")
    losses = [float(r["train/loss"]) for r in _rows(save_dir)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert 0.0 <= best <= 1.0 and (save_dir / "best.ckpt").exists()


def test_cli_without_cv2_or_jax(data, tmp_path):
    """``classify train`` (device cache), ``val`` on its best.ckpt and
    ``predict`` in a process where cv2 cannot be imported: no JAX and no
    module of the JAX package is loaded, and val reproduces the epoch's
    EMA top-1/top-5 (one full val batch, so padding changes nothing)."""
    code = f"""
import json, sys
sys.modules["cv2"] = None
from yolov5_tpu_torch.classify import main
tr = main(["train", "--device", "cpu", "--data", {str(data)!r}, "--cfg", "yolov5n",
           "--imgsz", "32", "--batch-size", "12", "--epochs", "1", "--project", {str(tmp_path)!r},
           "--name", "a"])
va = main(["val", "--device", "cpu", "--data", {str(data)!r}, "--batch-size", "12",
           "--weights", tr["save_dir"] + "/best.ckpt"])
pr = main(["predict", "--device", "cpu", "--imgsz", "32", "--weights",
           tr["save_dir"] + "/best.ckpt", "--source", {str(data / "val" / "bees")!r}])
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "yolov5_tpu."))]
assert not bad, bad
assert "cv2" not in [m for m in sys.modules if sys.modules[m] is not None]
print("RESULT", json.dumps({{"train": tr, "val": va, "predict": pr}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.split("RESULT ", 1)[1])
    row = _rows(out["train"]["save_dir"])[0]
    assert out["val"]["images"] == 12
    assert out["val"]["top1"] == float(row["val/top1"])
    assert out["val"]["top5"] == float(row["val/top5"])
    assert len(out["predict"]) == 4
    for path, top in out["predict"]:
        assert Path(path).parent.name == "bees" and len(top) == 3
        assert {c for c, _ in top} == set(CLASSES)
        assert sum(p for _, p in top) == pytest.approx(1.0, abs=1e-5)
    assert "bees" in proc.stdout


def test_cli_refuses_several_processes(monkeypatch, data):
    from yolov5_tpu_torch.classify import main

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="item 6"):
        main(["train", "--device", "cpu", "--data", str(data)])


def test_cli_defaults_to_the_card(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolov5_tpu_torch.classify import main

    for argv in (["train", "--data", str(data), "--epochs", "1"],
                 ["predict", "--weights", "x.ckpt", "--source", str(data)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_hub_load_classify(runs):
    """hub.load(task="classify"): a config name gives the seeded model, a
    checkpoint the BN-folded classifier of its EMA weights, on the device."""
    model = hub.load("yolov5n", task="classify", device="cpu")
    assert isinstance(model, ClassificationModel) and not model.training and model.nc == 1000
    ckpt = runs[1] / "best.ckpt"
    cls = hub.load(str(ckpt), task="classify", device="cpu")
    assert isinstance(cls, ClassificationModel) and cls.fused and cls.nc == 3
    ref, _, _ = run_classify.load_classifier(str(ckpt), device="cpu")
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                                                dtype=np.uint8))
    torch.testing.assert_close(run_classify.classify_logits(cls, images),
                               run_classify.classify_logits(ref, images), rtol=0, atol=0)
