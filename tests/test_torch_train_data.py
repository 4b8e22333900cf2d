"""The training side of the port's data and host utilities against the JAX
package: the shuffled epoch order, raw batches, the device cache, the
resize of training images, hyperparameter presets, seeding, callbacks, the
CSV logger and autoanchor. All of it is host code: equal, not close."""

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


def test_host_augmentation_is_not_ported(train_dir):
    with pytest.raises(NotImplementedError, match="host-side augmentation"):
        dataset.create_loader(str(train_dir), img_size=128, augment=True)


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
