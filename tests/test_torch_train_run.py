"""The port's training loop (train.run) end to end on the CPU: yolov5n at 128 px on a
generated BMP set, device augmentation, the device cache, per-epoch EMA
validation, results.csv, last.ckpt and best.ckpt; best.ckpt re-validated
by the port's val.run and read by the JAX package; resume equal to an
uninterrupted run; the CLI with host augmentation (the worker pool and the
prefetcher) and --evolve; rect, quad, multi-scale (host and device) and
image weights; the option that is not ported."""

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


def _cli(args, cwd):
    # one thread, as in the test processes (tests/torch_port_helpers.py)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "yolov5_tpu_torch.train", "--device", "cpu",
                          *args], capture_output=True, text=True, env=env, timeout=600, cwd=cwd)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_trains_with_host_augmentation(data_yaml, tmp_path):
    """The default path, as `python train.py` runs it: host mosaic,
    copy-paste and mixup (scratch-high) in two worker processes, batches
    copied ahead by the prefetcher."""
    summary = _cli(["--data", str(data_yaml), "--cfg", "yolov5n", "--imgsz", "128",
                    "--batch-size", "4", "--epochs", "2", "--hyp", "scratch-high", "--dtype",
                    "float32", "--workers", "2", "--project", str(tmp_path / "runs"), "--name",
                    "host"], tmp_path)
    save_dir = Path(summary["save_dir"])
    rows = _rows(save_dir)
    assert [int(r["step"]) for r in rows] == [0, 1]
    for r in rows:
        assert all(np.isfinite(float(r[f"train/{k}"])) for k in ("box", "obj", "cls", "total"))
    assert (save_dir / "last.ckpt").exists() and (save_dir / "best.ckpt").exists()
    opt = yaml.safe_load((save_dir / "opt.yaml").read_text())
    assert opt["device_aug"] is False and opt["workers"] == 2


@pytest.mark.parametrize("option", ["rect", "quad", "multi_scale", "multi_scale_device",
                                    "image_weights"])
def test_training_options_run(data_yaml, tmp_path, option, monkeypatch):
    """Two epochs with each option: finite losses, and the option reaches
    what it changes: rect, no mosaic and the images in order; quad, 2s
    batches and loss gain 4; multi-scale, a size drawn per batch, on the host
    or in the device mosaic's warp; image weights, indices drawn by weight in
    the second epoch."""
    from yolov5_tpu_torch.data import dataset
    from yolov5_tpu_torch.train import run as run_mod

    seen = {"batches": [], "sizes": set(), "gain": set()}
    build = dataset.Loader._build

    def noted_build(self, *args, **kw):
        batch = build(self, *args, **kw)
        if self.ds.augment:  # the training loader's
            seen["batches"].append((batch["images"].shape, list(batch["indices"]),
                                    self.ds.hyp["mosaic"], self.weighted_indices is not None))
        return batch

    make_step, loss_cls = run_mod.make_train_step, run_mod.ComputeLoss

    def sized_step(*args, ms_size=None, **kw):
        inner = make_step(*args, ms_size=ms_size, **kw)

        def step(state, batch, cache=None):
            seen["sizes"].add(ms_size or batch["images"].shape[1])
            return inner(state, batch, cache)

        return step

    def noted_loss(*args, gain=1.0, **kw):
        seen["gain"].add(gain)
        return loss_cls(*args, gain=gain, **kw)

    monkeypatch.setattr(dataset.Loader, "_build", noted_build)
    monkeypatch.setattr(run_mod, "make_train_step", sized_step)
    monkeypatch.setattr(run_mod, "ComputeLoss", noted_loss)
    device_aug = option == "multi_scale_device"
    kw = _kw(data_yaml, tmp_path, option, device_aug=device_aug, workers=1)
    kw["multi_scale" if option.startswith("multi_scale") else option] = True
    _, _, save_dir = run(**kw)
    rows = _rows(save_dir)
    assert len(rows) == 2
    for r in rows:
        assert all(np.isfinite(float(r[f"train/{k}"])) for k in ("box", "obj", "cls", "total"))
    assert seen["gain"] == {4.0 if option == "quad" else 1.0}
    shapes = {shape for shape, *_ in seen["batches"]}
    if option == "quad":
        assert shapes == {(1, 256, 256, 3)}
    elif option == "rect":  # square batches: the JAX package's rule
        assert shapes == {(4, 128, 128, 3)}
        assert {m for _, _, m, _ in seen["batches"]} == {0.0}
        assert [i for _, idx, _, _ in seen["batches"][:3] for i in idx] == list(range(12))
    elif option.startswith("multi_scale"):
        assert len(seen["sizes"]) > 1 and seen["sizes"] <= {64, 96, 128, 160, 192}
    else:
        assert [w for *_, w in seen["batches"]] == [False] * 3 + [True] * 3


def test_image_weights_act_from_the_second_epoch(data_yaml, tmp_path, monkeypatch):
    from yolov5_tpu_torch.data import dataset

    drawn = []
    original = dataset.Loader.set_image_weights

    def record(self, weights, epoch=0):
        original(self, weights, epoch)
        drawn.append((epoch, self.weighted_indices.copy()))

    monkeypatch.setattr(dataset.Loader, "set_image_weights", record)
    run(**_kw(data_yaml, tmp_path, "iw", epochs=3, image_weights=True, device_aug=False,
              workers=1))
    assert [e for e, _ in drawn] == [1, 2]
    assert all(len(idx) == 12 for _, idx in drawn)


def test_cli_evolve_mutates_as_jax(data_yaml, tmp_path):
    """--evolve 2 --epochs 1: generation 0 trains the base hyps, generation 1
    the JAX package's mutation of them from the same seed."""
    from yolov5_tpu.train import evolve as jax_evolve
    from yolov5_tpu.utils.hyp import load_hyp as jax_load_hyp

    summary = _cli(["--data", str(data_yaml), "--cfg", "yolov5n", "--imgsz", "128",
                    "--batch-size", "4", "--epochs", "1", "--evolve", "2", "--seed", "3",
                    "--dtype", "float32", "--workers", "1", "--project",
                    str(tmp_path / "runs" / "train"), "--name", "evo"], tmp_path)
    evolve_dir = tmp_path / "runs" / "evolve" / "evo"
    with open(evolve_dir / "evolve.csv") as f:
        gens = list(csv.DictReader(f))
    assert len(gens) == 2 and (evolve_dir / "hyp_evolve.yaml").exists()
    rng = np.random.default_rng(3)
    base = jax_load_hyp(None)
    assert jax_evolve.select_parent([], rng) is None
    parent = jax_evolve.select_parent([(float(gens[0]["fitness"]), base)], rng)
    child = jax_evolve.mutate({**base, **parent}, rng)
    for k in jax_evolve.META:
        assert float(gens[0][k]) == base[k], k
        assert float(gens[1][k]) == child[k], k
    assert summary["best_fitness"] == max(float(g["fitness"]) for g in gens)


@pytest.mark.parametrize("size", [64, 96, 160, 192])
def test_ms_resize_matches_jax_image_resize(size):
    """The train step's resize of a batch without the mosaic to its
    multi-scale size: jax.image.resize(..., "linear") (antialiased when it
    shrinks), +0.5 and truncated for uint8, within 1 level."""
    import jax
    import jax.numpy as jnp
    import torch

    from yolov5_tpu_torch.train.trainer import resize_batch

    im = np.random.default_rng(size).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    ref = jax.image.resize(jnp.asarray(im, jnp.float32), (2, size, size, 3), "linear")
    ref = np.asarray(jnp.clip(ref + 0.5, 0, 255).astype(jnp.uint8))
    got = resize_batch(torch.from_numpy(im), size).numpy()
    assert got.shape == ref.shape and np.abs(got.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("option", ["upload_dataset"])
def test_options_not_ported_raise(data_yaml, tmp_path, option):
    kw = _kw(data_yaml, tmp_path, "x")
    kw[option] = True
    with pytest.raises(NotImplementedError, match=option.split("_")[0]):
        run(**kw)
