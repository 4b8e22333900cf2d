"""The training CLIs of the port under two gloo ranks on the CPU
(``WORLD_SIZE`` 2, as torchrun sets it): ``python -m yolov5_tpu_torch.train``,
``segment train`` and ``classify train`` each run one epoch as two
processes, and rank 0's ``last.ckpt`` is held against one process's at the
global batch. Rank 0 alone writes the run directory and prints the JSON
line.

Tolerance: the model and EMA weights within 3e-4 of each tensor's largest
entry, float32. The runs differ in the order of their sums only
(tests/test_torch_parallel.py), and that reordering alone moves this
configuration (yolov5n at full width, 64 px, 2 steps of the warmup, whose
bias lr is 0.1) by up to 1.6e-4: one process, same data, run once with
``batch_norm_train``'s one-process form and once with the global form
(``_batch_norm_global``) lands that far apart in its BN biases. The ranks
land 0.8e-4 .. 1.1e-4 from one process."""

import json

import numpy as np
import pytest
import yaml

from tests.test_torch_parallel import REPO, spawn_ranks
from tests.torch_port_helpers import (write_imagefolder, write_polygon_dataset,
                                      write_shapes_dataset)
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.utils.checkpoint import load_checkpoint, variables_from_checkpoint

REL = 3e-4


def weights(ckpt):
    payload, meta = load_checkpoint(ckpt)
    out = {}
    for ema in (False, True):
        sd = from_jax_variables(variables_from_checkpoint(payload, prefer_ema=ema))
        out.update({f"{'ema/' if ema else ''}{k}": np.asarray(v) for k, v in sd.items()})
    return out, meta


def assert_same_run(got_dir, ref_dir):
    got, got_meta = weights(got_dir / "last.ckpt")
    ref, ref_meta = weights(ref_dir / "last.ckpt")
    assert got.keys() == ref.keys() and len(got) > 100
    assert got_meta.get("anchors") == ref_meta.get("anchors")
    for k, r in ref.items():
        err = np.abs(got[k] - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= REL, f"{k}: {err:.3g}"


def json_lines(outs):
    return [[json.loads(line) for line in out.splitlines() if line.startswith("{")]
            for out in outs]


def run_cli(module, argv, cwd):
    return spawn_ranks(["-m", module, *argv], cwd=cwd, YOLOV5_TPU_LOGGERS="off")


@pytest.fixture(scope="module")
def det_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mr_det")
    for split, n in (("train", 8), ("val", 4)):
        write_shapes_dataset(root, [(64, 64)] * n, ext=".bmp", split=split, seed=len(split))
    path = root / "data.yaml"
    path.write_text(yaml.safe_dump({"train": str(root / "images" / "train"),
                                    "val": str(root / "images" / "val"), "nc": 3}))
    return path


@pytest.mark.parametrize("device_aug", [True, False], ids=["device", "host"])
def test_train_cli_two_ranks_equal_one_process(det_data, tmp_path, device_aug, monkeypatch):
    """``train`` at a global batch of 4 (2 a rank), one epoch of 2 steps,
    device augmentation from the device cache or host augmentation in the
    loader: rank 0's last.ckpt equals the one-process run's, autoanchor's
    anchors included; only rank 0 writes and prints."""
    from yolov5_tpu_torch.train.run import run

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    kw = dict(cfg="yolov5n", imgsz=64, batch_size=4, epochs=1, dtype="float32", workers=1,
              device="cpu", exist_ok=True, device_aug=device_aug)
    argv = ["--device", "cpu", "--data", str(det_data), "--cfg", "yolov5n", "--imgsz", "64",
            "--batch-size", "4", "--epochs", "1", "--dtype", "float32", "--workers", "1",
            "--project", str(tmp_path), "--name", "ranks", "--exist-ok"]
    outs = run_cli("yolov5_tpu_torch.train", argv + (["--device-aug"] if device_aug else []),
                   REPO)
    lines = json_lines(outs)
    assert len(lines[0]) == 1 and lines[1] == []
    assert lines[0][0]["save_dir"] == str(tmp_path / "ranks")
    _, _, ref = run(data=str(det_data), project=str(tmp_path), name="one", **kw)
    got = tmp_path / "ranks"
    assert_same_run(got, ref)
    rows = (got / "results.csv").read_text().splitlines()
    assert len(rows) == 2
    assert {"results.png", "labels.png", "best.ckpt"} <= {p.name for p in got.iterdir()}


def test_segment_cli_two_ranks_equal_one_process(tmp_path, monkeypatch):
    """``segment train``, host augmentation and host masks, global batch 4."""
    from yolov5_tpu_torch.train.run_segment import run

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    root = tmp_path / "data"
    for split, n in (("train", 8), ("val", 2)):
        write_polygon_dataset(root, [(64, 64)] * n, split=split, seed=len(split))
    data = tmp_path / "seg.yaml"
    data.write_text(yaml.safe_dump({"train": str(root / "images" / "train"),
                                    "val": str(root / "images" / "val"), "nc": 3}))
    argv = ["train", "--device", "cpu", "--data", str(data), "--cfg", "yolov5n-seg", "--imgsz",
            "64", "--batch-size", "4", "--epochs", "1", "--dtype", "float32", "--workers", "1",
            "--project", str(tmp_path), "--name", "ranks", "--noplots"]
    lines = json_lines(run_cli("yolov5_tpu_torch.segment", argv, REPO))
    assert len(lines[0]) == 1 and lines[1] == []
    _, _, ref = run(data=str(data), cfg="yolov5n-seg", imgsz=64, batch_size=4, epochs=1,
                    dtype="float32", workers=1, device="cpu", project=str(tmp_path), name="one",
                    noplots=True)
    assert_same_run(tmp_path / "ranks", ref)
    assert (tmp_path / "ranks" / "best.ckpt").exists()


@pytest.mark.parametrize("device_aug", [True, False], ids=["device", "host"])
def test_classify_cli_two_ranks_equal_one_process(tmp_path, device_aug, monkeypatch):
    """``classify train`` (SGD), global batch 8: from the device cache with
    device augmentation, or the host crops of each rank's rows."""
    from yolov5_tpu_torch.train.run_classify import run

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    for split in ("train", "val"):
        write_imagefolder(tmp_path / "data" / split, ["a", "b", "c"], 4,
                          [(40, 48), (48, 40)], seed=len(split))
    argv = ["train", "--device", "cpu", "--data", str(tmp_path / "data"), "--cfg", "yolov5n",
            "--imgsz", "32", "--batch-size", "8", "--epochs", "1", "--optimizer", "sgd",
            "--project", str(tmp_path), "--name", "ranks"]
    lines = json_lines(run_cli("yolov5_tpu_torch.classify",
                               argv + ([] if device_aug else ["--no-device-aug"]), REPO))
    assert len(lines[0]) == 1 and lines[1] == []
    _, ref = run(data=str(tmp_path / "data"), cfg="yolov5n", imgsz=32, batch_size=8, epochs=1,
                 optimizer="sgd", device_aug=device_aug, device="cpu", project=str(tmp_path),
                 name="one", verbose=False)
    assert_same_run(tmp_path / "ranks", ref)


def test_global_batch_must_divide_over_the_ranks(det_data, tmp_path):
    """``--batch-size`` is the global batch: 5 over 2 ranks fails both."""
    with pytest.raises(AssertionError, match="does not divide over 2 ranks"):
        run_cli("yolov5_tpu_torch.train",
                ["--device", "cpu", "--data", str(det_data), "--batch-size", "5", "--imgsz",
                 "64", "--epochs", "1", "--project", str(tmp_path)], REPO)
