"""The training side of the port's data and host utilities against the JAX
package: the shuffled epoch order, raw batches, the device cache, the
resize of training images, host augmentation (``load_mosaic``, ``get_item``,
std and quad batches, the worker pool), image weights, the multi-scale
plan, hyperparameter presets, seeding, callbacks, the CSV logger and
autoanchor. Host code is equal, not close, except the images of host
augmentation: a warp may differ from OpenCV's by one level on at most 0.1%
of the pixels (tests/test_torch_cv.py), which the HSV LUT can widen, so at
most 0.1% of an augmented image's pixels may differ."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import write_shapes_dataset
from yolov5_tpu.data import dataset as jax_dataset
from yolov5_tpu.data import device_cache as jax_cache
from yolov5_tpu.utils import autoanchor as jax_autoanchor
from yolov5_tpu.utils import callbacks as jax_callbacks
from yolov5_tpu.utils import general as jax_general
from yolov5_tpu.utils import hyp as jax_hyp
from yolov5_tpu.utils.loggers import CSVLogger as JaxCSVLogger
from yolov5_tpu_torch.data import dataset, device_cache
from yolov5_tpu_torch.utils import autoanchor, callbacks, general, hyp
from yolov5_tpu_torch.utils.loggers import CSVLogger, Loggers

SHAPES = [(96, 128), (128, 96), (200, 160), (64, 128), (130, 90)]


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_set")
    write_shapes_dataset(root, SHAPES * 2, ext=".bmp", split="train", seed=4)
    return root / "images" / "train"


def _pair(train_dir):
    """The same training set and loader in both packages (the port's training
    loader always yields the raw batches of the device mosaic)."""
    args = dict(img_size=128, batch_size=3, augment=True, device_aug=True, max_labels=None,
                workers=1, seed=5)
    return (dataset.create_loader(str(train_dir), **args),
            jax_dataset.create_loader(str(train_dir), raw_images=True, **args))


def test_shuffled_epochs_match_jax(train_dir):
    (ds, loader), (jds, jloader) = _pair(train_dir)
    assert len(loader) == len(jloader) and loader.max_labels == jloader.max_labels
    for epoch in (0, 1, 7):
        np.testing.assert_array_equal(loader._indices(epoch), jloader._indices(epoch))
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got = [b["idx"] for b in device_cache.index_batches(loader)]
        ref = [b["idx"] for b in jax_cache.index_batches(jloader)]
        np.testing.assert_array_equal(np.stack(got), np.stack(ref))


def test_raw_batches_and_device_cache_match_jax(train_dir):
    """Resize long side = 128 with linear interpolation for a training set
    (the 200x160 and 130x90 images), content top-left, labels padded."""
    (ds, loader), (jds, jloader) = _pair(train_dir)
    for i in range(len(ds)):
        im, hw0, hw = ds.load_image(i)
        rim, rhw0, rhw = jds.load_image(i)
        np.testing.assert_array_equal(im, rim)
        assert (hw0, tuple(hw)) == (rhw0, tuple(rhw))
    chunk = [7, 2, 2]
    got, ref = dataset.raw_batch(ds, chunk, loader.max_labels), jloader._raw_batch(chunk)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    a = device_cache.build_cache_arrays(ds, loader.max_labels)
    b = jax_cache.build_cache_arrays(jds, jloader.max_labels)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert device_cache.cache_nbytes(ds, 8) == jax_cache.cache_nbytes(jds, 8)
    on_dev = device_cache.to_device(a, "cpu")
    assert on_dev["images"].dtype == torch.uint8 and on_dev["images"].shape == (10, 128, 128, 3)
    assert device_cache.device_memory_budget("cpu") > 0


HOST_HYP = dict(mosaic=1.0, mixup=0.5, copy_paste=0.5, degrees=5.0, shear=2.0, flipud=0.3,
                scale=0.5)


@pytest.fixture(scope="module")
def seg_train_dir(tmp_path_factory):
    """The training set of train_dir's shapes, half of its images labelled by
    polygons (an octagon in each box), so that copy-paste has instances."""
    root = tmp_path_factory.mktemp("seg_set")
    write_shapes_dataset(root, SHAPES * 2, ext=".bmp", split="train", seed=6)
    for i, f in enumerate(sorted((root / "labels" / "train").glob("*.txt"))):
        if i % 2:
            continue
        rows = []
        for line in f.read_text().split("\n"):
            if line.strip():
                c, x, y, w, h = map(float, line.split())
                a = np.linspace(0, 2 * np.pi, 8, endpoint=False)
                pts = np.stack([x + w / 2 * np.cos(a), y + h / 2 * np.sin(a)], 1).clip(0, 1)
                rows.append(f"{int(c)} " + " ".join(f"{v:.6f}" for v in pts.ravel()))
        f.write_text("\n".join(rows) + "\n")
    return root / "images" / "train"


def _close_images(a, b, frac=1e-3):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert (a != b).mean() <= frac, (a != b).mean()


def _same_sample(got, ref):
    _close_images(got[0], ref[0])
    assert got[1].shape == ref[1].shape
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    assert len(got[2]) == len(ref[2])
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("mosaic", [1.0, 0.5, 0.0])
def test_get_item_matches_jax(seg_train_dir, mosaic):
    """Host augmentation per seed: the mosaic (copy-paste, mixup,
    random_perspective's crop) or the letterbox with random_perspective, then
    HSV and flips."""
    hyp = dict(HOST_HYP, mosaic=mosaic)
    ds = dataset.YOLODataset(str(seg_train_dir), img_size=128, augment=True, hyp=hyp)
    jds = jax_dataset.YOLODataset(str(seg_train_dir), img_size=128, augment=True, hyp=hyp)
    assert ds.hyp == jds.hyp and ds.mosaic_border == jds.mosaic_border
    np.testing.assert_array_equal(ds.indices, jds.indices)
    assert sum(len(s) for s in ds.segments) == sum(len(s) for s in jds.segments) > 0
    for seed in range(4):
        for i in range(len(ds)):
            _same_sample(ds.get_item(i, np.random.default_rng(seed * 100 + i)),
                         jds.get_item(i, np.random.default_rng(seed * 100 + i)))


@pytest.mark.parametrize("device_aug", [False, True])
def test_load_mosaic_matches_jax(seg_train_dir, device_aug):
    """With device augmentation the host mosaic only composes and crops."""
    kw = dict(img_size=128, augment=True, hyp=HOST_HYP, device_aug=device_aug)
    ds = dataset.YOLODataset(str(seg_train_dir), **kw)
    jds = jax_dataset.YOLODataset(str(seg_train_dir), **kw)
    for seed in range(6):
        _same_sample(ds.load_mosaic(seed % len(ds), np.random.default_rng(seed)),
                     jds.load_mosaic(seed % len(ds), np.random.default_rng(seed)))


def _host_pair(train_dir, workers=1, **extra):
    args = dict(img_size=128, batch_size=4, augment=True, max_labels=None, seed=3,
                hyp=HOST_HYP, cache=False, **extra)
    return (dataset.create_loader(str(train_dir), workers=workers, **args),
            jax_dataset.create_loader(str(train_dir), workers=1, **args))


def _same_batches(got, ref, image_frac=1e-3):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close_images(g["images"], r["images"], image_frac)
        np.testing.assert_allclose(g["targets"], r["targets"], atol=1e-4)
        for k in ("valid", "indices", "real", "paths"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("quad", [False, True])
def test_host_loader_batches_match_jax(seg_train_dir, quad):
    """Std and quad batches of two epochs, built in-process in both packages
    (quad: label capacity x4, half the groups upsampled 2x, half tiled)."""
    (ds, loader), (jds, jloader) = _host_pair(seg_train_dir, quad=quad)
    assert len(loader) == len(jloader) == 2
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, ref = list(loader), list(jloader)
        if quad:
            assert got[0]["images"].shape == (1, 256, 256, 3)
            assert got[0]["targets"].shape[1] == 4 * loader.max_labels
        _same_batches(got, ref)


@pytest.mark.parametrize("quad", [False, True])
def test_worker_pool_equals_in_process_loader(seg_train_dir, quad):
    (_, pooled), _ = _host_pair(seg_train_dir, workers=2, quad=quad)
    (_, inline), _ = _host_pair(seg_train_dir, workers=1, quad=quad)
    assert pooled.use_processes and not inline.use_processes
    try:
        for epoch in (0, 1):
            pooled.set_epoch(epoch)
            inline.set_epoch(epoch)
            _same_batches(list(pooled), list(inline), image_frac=0.0)
    finally:
        pooled.close()
    assert pooled._mp_pool is None


def test_a_failing_worker_stops_the_loader(tmp_path):
    """An error in a worker process reaches the loop that reads the batches
    (here: the images are gone once the label cache is built)."""
    write_shapes_dataset(tmp_path, SHAPES * 2, ext=".bmp", split="train", seed=1)
    _, loader = dataset.create_loader(str(tmp_path / "images" / "train"), img_size=128,
                                      batch_size=4, augment=True, workers=2, cache=False)
    for f in (tmp_path / "images" / "train").glob("*.bmp"):
        f.unlink()
    try:
        with pytest.raises(FileNotFoundError):
            next(iter(loader))
    finally:
        loader.close()


def test_prefetch_keeps_order_and_raises_the_producers_error():
    from yolov5_tpu_torch.train.prefetch import prefetch

    batches = [{"images": np.full((2, 3), i, np.uint8), "real": i} for i in range(5)]
    got = list(prefetch(iter(batches), "cpu", transform=lambda b: dict(b, twice=2 * b["real"])))
    assert [int(b["images"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["images"], torch.Tensor) and b["twice"] == 2 * b["real"]
               for b in got)

    def failing():
        yield batches[0]
        raise RuntimeError("worker died")

    it = prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="worker died"):
        next(it)


def test_quad_refuses_what_it_cannot_batch(train_dir):
    with pytest.raises(ValueError, match="divisible by 4"):
        dataset.create_loader(str(train_dir), img_size=128, batch_size=6, augment=True,
                              quad=True)
    for kw in (dict(device_aug=True), dict(rect=True)):
        with pytest.raises(ValueError, match="incompatible"):
            dataset.create_loader(str(train_dir), img_size=128, batch_size=4, augment=True,
                                  quad=True, **kw)


def test_rect_training_gets_square_batches_as_in_jax(train_dir):
    """The JAX package's rule (dataset.py:603): --rect never reaches a
    training loader; it only turns the shuffle off."""
    kw = dict(img_size=128, batch_size=4, augment=True, rect=True, shuffle=False, workers=1,
              hyp=dict(mosaic=0.0), cache=False)
    (_, loader), (_, jloader) = (dataset.create_loader(str(train_dir), **kw),
                                 jax_dataset.create_loader(str(train_dir), **kw))
    assert not loader.rect and not jloader.rect
    np.testing.assert_array_equal(loader._indices(0), np.arange(10))
    got, ref = list(loader), list(jloader)
    assert {b["images"].shape for b in got} == {(4, 128, 128, 3)}
    _same_batches(got, ref)


def test_image_weights_match_jax(train_dir):
    (ds, loader), (jds, jloader) = _pair(train_dir)
    for nc in (3, 5):
        np.testing.assert_array_equal(general.labels_to_class_weights(ds.labels, nc),
                                      jax_general.labels_to_class_weights(jds.labels, nc))
    w = np.random.default_rng(0).uniform(0, 1, len(ds))
    for epoch in (1, 4):
        loader.set_image_weights(w, epoch)
        jloader.set_image_weights(w, epoch)
        np.testing.assert_array_equal(loader.weighted_indices, jloader.weighted_indices)
        np.testing.assert_array_equal(loader._indices(epoch), jloader._indices(epoch))
        assert len(loader) == len(jloader)


def test_multiscale_plan_matches_jax(monkeypatch):
    from yolov5_tpu.train import run as jax_run
    from yolov5_tpu_torch.train import run as port_run

    for imgsz, gs in ((640, 32), (128, 32), (320, 64)):
        assert port_run.multiscale_sizes(imgsz, gs) == jax_run.multiscale_sizes(imgsz, gs)
        assert port_run.multiscale_sizes(imgsz, gs, 3) == jax_run.multiscale_sizes(imgsz, gs, 3)
    monkeypatch.setenv("YOLOV5_TPU_MS_BUCKETS", "11")
    assert port_run.multiscale_sizes(640, 32) == jax_run.multiscale_sizes(640, 32)
    idx_epoch = np.arange(7 * 4).reshape(7, 4)
    sizes = port_run.multiscale_sizes(640, 32)
    got = list(port_run.multiscale_epoch_plan(idx_epoch, sizes, np.random.default_rng(2)))
    ref = list(jax_run.multiscale_epoch_plan(idx_epoch, sizes, np.random.default_rng(2)))
    assert [s for s, _ in got] == [s for s, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_no_opencv_or_pil_on_the_bmp_paths(seg_train_dir, monkeypatch, tmp_path):
    """With cv2 and PIL unimportable: letterbox with a resize, load_image
    (linear and area), host-augmented get_item (copy-paste included) and a
    loader batch of odd-sized BMPs (200x160, 130x90, ...), a val batch, and
    the train (host augmentation, EMA validation) and detect paths over
    them."""
    import sys

    import yaml

    from yolov5_tpu_torch import infer
    from yolov5_tpu_torch.data.letterbox import letterbox
    from yolov5_tpu_torch.train.run import run

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    im = np.random.default_rng(0).integers(0, 256, (130, 90, 3), dtype=np.uint8)
    assert letterbox(im, 128)[0].shape == (128, 128, 3)
    for augment in (False, True):  # area, then linear
        ds = dataset.YOLODataset(str(seg_train_dir), img_size=100, augment=augment,
                                 hyp=HOST_HYP)
        assert {ds.load_image(i)[0].shape[:2] for i in range(len(ds))} >= {(100, 80), (100, 70)}
        im, labels, _ = ds.get_item(2, np.random.default_rng(0))
        assert im.shape == (100, 100, 3) and len(labels)
    _, loader = dataset.create_loader(str(seg_train_dir), img_size=96, batch_size=4,
                                      augment=True, hyp=HOST_HYP, workers=1)
    assert next(iter(loader))["images"].shape == (4, 96, 96, 3)
    _, val_loader = dataset.create_loader(str(seg_train_dir), img_size=96, batch_size=4)
    assert next(iter(val_loader))["images"].shape == (4, 96, 96, 3)
    data = tmp_path / "set.yaml"
    data.write_text(yaml.safe_dump({"train": str(seg_train_dir), "val": str(seg_train_dir),
                                    "nc": 3, "names": ["a", "b", "c"]}))
    _, results, save_dir = run(data=str(data), cfg="yolov5n", epochs=1, batch_size=4, imgsz=96,
                               workers=1, project=str(tmp_path), name="train", hyp=HOST_HYP,
                               dtype="float32", device="cpu", noautoanchor=True)
    assert results["images"] == 10 and (save_dir / "best.ckpt").exists()
    found, _ = infer.run(weights=str(save_dir / "best.ckpt"), source=str(seg_train_dir),
                         imgsz=96, project=str(tmp_path), name="detect", device="cpu",
                         verbose=False)
    assert len(found) == 10 and (tmp_path / "detect" / "004.bmp").exists()


def test_hyp_presets_and_load_hyp_match_jax(tmp_path):
    assert hyp.PRESETS == jax_hyp.PRESETS
    f = tmp_path / "h.yaml"
    f.write_text("lr0: 0.02\nmosaic: 0.5\n")
    for arg in (None, "scratch-low", "hyp.scratch-high.yaml", "VOC", {"lr0": 0.3}, str(f)):
        assert hyp.load_hyp(arg) == jax_hyp.load_hyp(arg)


def test_init_seeds_matches_jax():
    draws = []
    for init in (general.init_seeds, jax_general.init_seeds):
        assert init(11) == 11
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    general.init_seeds(11)
    a = torch.rand(3)
    torch.manual_seed(11)
    assert torch.equal(a, torch.rand(3))


def test_callbacks_match_jax():
    assert callbacks.HOOKS == jax_callbacks.HOOKS
    seen = []
    cb = callbacks.Callbacks()
    cb.register_action("on_fit_epoch_end", "x", lambda epoch, fitness: seen.append((epoch,
                                                                                    fitness)))
    cb.run("on_fit_epoch_end", epoch=2, fitness=0.5)
    assert seen == [(2, 0.5)] and len(cb.get_registered_actions("on_fit_epoch_end")) == 1
    with pytest.raises(AssertionError):
        cb.run("no_such_hook")


def test_csv_logger_matches_jax(tmp_path):
    rows = [{"step": 0, "train/box": 0.5, "val/map": 0.125}, {"step": 1, "train/box": 0.25,
                                                              "val/map": 0.5}]
    for cls, name in ((CSVLogger, "port.csv"), (JaxCSVLogger, "jax.csv")):
        for r in rows:
            cls(tmp_path / name).log(r)  # a new logger per row: resume adopts the header
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    Loggers(tmp_path / "run").log_metrics({"a": 1.0}, 3)
    assert (tmp_path / "run" / "results.csv").read_text().splitlines() == ["step,a", "3,1.0"]


@pytest.mark.parametrize("scale", [1.0, 0.15])
def test_autoanchor_matches_jax(scale):
    """check_anchors keeps fitting anchors and evolves poor ones, equal to
    the JAX package (kmeans + the seeded genetic search)."""
    rng = np.random.default_rng(2)
    labels = [np.concatenate([rng.integers(0, 3, (n, 1)), rng.uniform(0.2, 0.8, (n, 2)),
                              rng.uniform(0.05, 0.6, (n, 2)) * scale], 1).astype(np.float32)
              for n in rng.integers(1, 6, 40)]
    ds = SimpleNamespace(labels=labels)
    model = SimpleNamespace(anchors=(((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45),
                                     (59, 119)), ((116, 90), (156, 198), (373, 326))))
    got = autoanchor.check_anchors(ds, model, imgsz=128, verbose=False)
    ref = jax_autoanchor.check_anchors(ds, model, imgsz=128, verbose=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert (got == model.anchors) == (scale == 1.0)
