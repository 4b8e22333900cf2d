"""The port's plots (``yolov5_tpu_torch.utils.plots``) against the JAX
package's (``yolov5_tpu.utils.plots``): each function, on the inputs the JAX
package gives it, writes an image whose decoded pixels equal the JAX one's;
``soft_fail`` keeps a run alive; and the training, evolution and study
runs write their plots where the JAX package's do."""

import csv

import numpy as np
import pytest
import yaml

from yolov5_tpu.utils import plots as JP
from yolov5_tpu_torch.utils import plots as PP

pytest.importorskip("matplotlib")
cv2 = pytest.importorskip("cv2")


def pixels(path):
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert im is not None and im.size, path
    return im


def both(tmp_path, name, call):
    """``call(module, out_dir)`` through both packages; their images' pixels."""
    outs = []
    for mod in (PP, JP):
        d = tmp_path / mod.__name__
        d.mkdir(exist_ok=True)
        call(mod, d)
        outs.append(pixels(d / name))
    return outs


def write_results_csv(path, n=4):
    rng = np.random.default_rng(0)
    keys = ["train/box", "train/obj", "train/cls", "val/map50", "fitness"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["step", *keys])
        w.writeheader()
        for s in range(n):
            w.writerow({"step": s, **{k: float(rng.uniform()) for k in keys}})


def labels_list(n=6, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 5))
        lb = np.zeros((k, 5), np.float32)
        lb[:, 0] = rng.integers(0, 3, k)
        lb[:, 1:] = rng.uniform(0.05, 0.9, (k, 4))
        out.append(lb)
    return out


def test_plot_results_pixels_equal_jax(tmp_path):
    def call(mod, d):
        write_results_csv(d / "results.csv")
        mod.plot_results(d / "results.csv")

    got, ref = both(tmp_path, "results.png", call)
    np.testing.assert_array_equal(got, ref)
    assert got.shape[0] > 100 and got.std() > 0


def test_plot_labels_pixels_equal_jax(tmp_path):
    got, ref = both(tmp_path, "labels.png",
                    lambda mod, d: mod.plot_labels(labels_list(), {0: "a", 1: "b", 2: "c"}, d))
    np.testing.assert_array_equal(got, ref)


def test_plot_evolve_pixels_equal_jax(tmp_path):
    def call(mod, d):
        rng = np.random.default_rng(2)
        with open(d / "evolve.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["fitness", "lr0", "momentum", "box"])
            w.writeheader()
            for _ in range(5):
                w.writerow({"fitness": rng.uniform(), "lr0": rng.uniform(1e-3, 1e-2),
                            "momentum": rng.uniform(0.8, 0.95), "box": rng.uniform(0.02, 0.2)})
        assert mod.plot_evolve(d / "evolve.csv") == d / "evolve.png"

    got, ref = both(tmp_path, "evolve.png", call)
    np.testing.assert_array_equal(got, ref)


def test_plot_study_pixels_equal_jax(tmp_path):
    def call(mod, d):
        rows = np.array([[s, 0.5, 0.4, 0.3 + s / 4000, 0.2 + s / 5000, s / 100, 0.5, 1.0]
                         for s in (256, 384, 512)])
        np.savetxt(d / "study_data_w.txt", rows, fmt="%10.4g")
        mod.plot_study([d / "study_data_w.txt"], d / "study.png")

    got, ref = both(tmp_path, "study.png", call)
    np.testing.assert_array_equal(got, ref)


def test_plot_curves_and_confusion_matrix_pixels_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    px = np.linspace(0, 1, 101)
    py = np.sort(rng.uniform(0, 1, (3, 101)), 1)[:, ::-1]
    ap = rng.uniform(0, 1, 3)
    matrix = rng.integers(0, 20, (4, 4))
    for name, call in (
            ("pr.png", lambda mod, d: mod.plot_pr_curve(px, py, ap, ("a", "b", "c"), d / "pr.png")),
            ("f1.png", lambda mod, d: mod.plot_mc_curve(px, py, d / "f1.png", ylabel="F1",
                                                        names=("a", "b", "c"))),
            ("cm.png", lambda mod, d: mod.plot_confusion_matrix(matrix, ("a", "b", "c"),
                                                                d / "cm.png"))):
        got, ref = both(tmp_path, name, call)
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_plot_images_pixels_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (5, 32, 40, 3), dtype=np.uint8)
    targets = np.zeros((5, 3, 5), np.float32)
    targets[..., 0] = rng.integers(0, 2, (5, 3))
    targets[..., 1:] = rng.uniform(0.2, 0.6, (5, 3, 4))
    valid = rng.uniform(size=(5, 3)) < 0.7
    got, ref = both(tmp_path, "batch.png",
                    lambda mod, d: mod.plot_images(images, targets, valid, d / "batch.png",
                                                   names={0: "a", 1: "b"}))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (2 * 32, 3 * 40, 3)


def test_soft_fail_keeps_the_run_alive(tmp_path, capsys):
    @PP.soft_fail
    def broken():
        raise RuntimeError("no canvas")

    assert broken() is None
    assert "plot broken failed: no canvas" in capsys.readouterr().out
    assert PP.plot_results(tmp_path / "missing.csv") is None  # an unreadable csv


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    from tests.torch_port_helpers import write_shapes_dataset

    root = tmp_path_factory.mktemp("plots_data")
    for split in ("train", "val"):
        write_shapes_dataset(root, [(64, 64)] * 4, ext=".bmp", split=split)
    path = root / "data.yaml"
    path.write_text(yaml.safe_dump({"train": str(root / "images" / "train"),
                                    "val": str(root / "images" / "val"), "nc": 3}))
    return path


@pytest.mark.parametrize("noplots", [False, True])
def test_train_run_writes_its_plots_unless_noplots(data_yaml, tmp_path, noplots, monkeypatch):
    """``results.png`` and ``labels.png`` beside ``results.csv``, as the JAX
    run writes them (run.py:526-530); none with ``noplots``."""
    from yolov5_tpu_torch.train.run import run

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    _, _, save_dir = run(data=str(data_yaml), cfg="yolov5n", epochs=1, batch_size=2, imgsz=64,
                         workers=1, dtype="float32", device="cpu", device_aug=True,
                         noautoanchor=True, noplots=noplots, project=str(tmp_path), name="r")
    assert (save_dir / "results.csv").exists()
    for name in ("results.png", "labels.png"):
        assert (save_dir / name).exists() is not noplots, name
    if not noplots:
        assert pixels(save_dir / "results.png").std() > 0


def test_evolve_and_study_write_their_plots(data_yaml, tmp_path, monkeypatch):
    """``--evolve`` writes evolve.png beside evolve.csv
    (evolve.py:105-107), the val study study.png (evaluator.py:399-401)."""
    from yolov5_tpu_torch.eval.evaluator import run_study
    from yolov5_tpu_torch.train.evolve import run_evolve

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    run_evolve(str(data_yaml), cfg="yolov5n", generations=2, epochs=1, batch_size=2, imgsz=64,
               save_dir=tmp_path / "evolve",
               train_kwargs=dict(device="cpu", dtype="float32", workers=1, device_aug=True,
                                 noautoanchor=True, noplots=True))
    assert (tmp_path / "evolve" / "evolve.png").exists()
    run_study(str(data_yaml), cfg="yolov5n", imgsz_range=(64, 96, 32), batch_size=2,
              workers=1, device="cpu", verbose=False, project=str(tmp_path), name="study")
    assert (tmp_path / "study" / "study.png").exists()
    assert len(np.loadtxt(next((tmp_path / "study").glob("study_*.txt")), ndmin=2)) == 2
