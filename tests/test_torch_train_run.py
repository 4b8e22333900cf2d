"""The port's training loop (train.run) end to end on the CPU: yolov5n at 128 px on a
generated BMP set, device augmentation, the device cache, per-epoch EMA
validation, results.csv, last.ckpt and best.ckpt; best.ckpt re-validated
by the port's val.run and read by the JAX package; resume equal to an
uninterrupted run; the CLI; the options that are not ported."""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from tests.torch_port_helpers import write_shapes_dataset
from yolov5_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from yolov5_tpu.utils.checkpoint import variables_from_checkpoint as jax_variables
from yolov5_tpu_torch.eval.evaluator import run as val_run
from yolov5_tpu_torch.train.run import run
from yolov5_tpu_torch.utils.callbacks import Callbacks

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(96, 128), (128, 96), (128, 128), (64, 128)]


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    write_shapes_dataset(root / "set", SHAPES * 3, ext=".bmp", split="train", seed=1)
    d = write_shapes_dataset(root / "set", SHAPES * 2, ext=".bmp", split="val", seed=2)
    d["train"] = "images/train"
    path = root / "shapes.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


def _kw(data_yaml, tmp_path, name, **extra):
    kw = dict(data=str(data_yaml), cfg="yolov5n", epochs=2, batch_size=4, imgsz=128,
              workers=2, project=str(tmp_path / "runs"), name=name, exist_ok=True,
              device_aug=True, dtype="float32", device="cpu")
    return {**kw, **extra}


def _rows(save_dir):
    with open(save_dir / "results.csv") as f:
        return list(csv.DictReader(f))


def test_run_writes_results_and_checkpoints(data_yaml, tmp_path):
    best_fitness, results, save_dir = run(**_kw(data_yaml, tmp_path, "a"))
    rows = _rows(save_dir)
    assert [int(r["step"]) for r in rows] == [0, 1]
    for r in rows:
        for k in ("train/box", "train/obj", "train/cls", "train/total"):
            assert np.isfinite(float(r[k])) and float(r[k]) > 0, k
    for name in ("last.ckpt", "best.ckpt"):
        assert (save_dir / name).exists() and (save_dir / f"{name}.json").exists()

    # the JAX package reads the port's files
    last, meta = jax_load_checkpoint(save_dir / "last.ckpt")
    best, best_meta = jax_load_checkpoint(save_dir / "best.ckpt")
    assert meta["format"] == "yolov5_tpu-ckpt-v1" and meta["epoch"] == 1
    assert set(last) == {"params", "batch_stats", "ema_params", "ema_stats", "ema_updates",
                         "step", "torch_opt_state"}
    assert "torch_opt_state" not in best and "opt_state" not in best
    # 6 micro-batches; at b4 (nbs 64) the EMA ticks on real updates only
    assert int(last["step"]) == 2 * 3
    assert int(last["ema_updates"]) == int(last["torch_opt_state"]["gradient_step"]) == 2
    v = jax_variables(best)
    assert v["params"]["layers_0"]["conv"]["kernel"].shape == (6, 6, 3, 16)

    # val.run on best.ckpt reproduces the training-time EMA validation
    best_epoch = int(best_meta["epoch"])
    ref = rows[best_epoch]
    res = val_run(str(data_yaml), weights=str(save_dir / "best.ckpt"), imgsz=128,
                  batch_size=4, rect=False, device="cpu", verbose=False)
    for k in ("mp", "mr", "map50", "map"):
        assert res[k] == pytest.approx(float(ref[f"val/{k}"]), rel=1e-9, abs=1e-12), k
    assert best_fitness == pytest.approx(max(float(r["fitness"]) for r in rows))


class _Interrupt(Exception):
    pass


def test_resume_equals_uninterrupted_run(data_yaml, tmp_path):
    """3 epochs straight against 2 epochs, an interruption, and --resume of
    the run dir: the third epoch's losses, metrics and weights are equal."""
    _, _, straight = run(**_kw(data_yaml, tmp_path, "straight", epochs=3))

    cb = Callbacks()

    def stop(epoch, fitness):
        if epoch == 1:
            raise _Interrupt

    cb.register_action("on_fit_epoch_end", callback=stop)
    with pytest.raises(_Interrupt):
        run(**_kw(data_yaml, tmp_path, "cut", epochs=3), callbacks=cb)
    cut = tmp_path / "runs" / "cut"
    _, _, resumed = run(data=str(data_yaml), resume=str(cut / "last.ckpt"),
                        project=str(tmp_path / "runs"), device="cpu")
    assert resumed == cut
    a, b = _rows(straight), _rows(cut)
    assert len(a) == len(b) == 3
    for k in a[2]:
        if k != "train/imgs_per_sec":
            assert float(a[2][k]) == pytest.approx(float(b[2][k]), rel=1e-6, abs=1e-9), k
    pa, _ = jax_load_checkpoint(straight / "last.ckpt")
    pb, _ = jax_load_checkpoint(cut / "last.ckpt")
    assert int(pa["step"]) == int(pb["step"]) == 9
    ka = pa["ema_params"]["layers_24"]["m_2"]["kernel"]
    np.testing.assert_allclose(pb["ema_params"]["layers_24"]["m_2"]["kernel"], ka,
                               rtol=1e-6, atol=1e-7)


def test_cli_trains_two_epochs(data_yaml, tmp_path):
    # one thread, as in the test processes (tests/torch_port_helpers.py)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "yolov5_tpu_torch.train", "--device", "cpu", "--data",
         str(data_yaml), "--cfg", "yolov5n", "--imgsz", "128", "--batch-size", "4",
         "--epochs", "2", "--device-aug", "--dtype", "float32", "--workers", "2",
         "--project", str(tmp_path / "runs"), "--name", "cli"],
        capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    save_dir = Path(summary["save_dir"])
    assert (save_dir / "results.csv").exists() and (save_dir / "best.ckpt").exists()
    assert set(summary) >= {"best_fitness", "map50", "map"}


@pytest.mark.parametrize("option", ["rect", "quad", "multi_scale", "image_weights",
                                    "upload_dataset", "host_augmentation"])
def test_options_not_ported_raise(data_yaml, tmp_path, option):
    kw = _kw(data_yaml, tmp_path, "x")
    if option == "host_augmentation":
        kw["device_aug"] = False
    else:
        kw[option] = True
    with pytest.raises(NotImplementedError, match=option.split("_")[0]):
        run(**kw)
