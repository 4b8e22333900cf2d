"""The native JPEG batch decoder (``yolov5_tpu_torch.native``) and the
loader's native path against the JAX package's: the decoder's bytes, its
failures, the loader's batches and fall-back, ``evaluator.run`` on a JPEG
set, the build's directory and reasons, and the decoder beside torch's
OpenMP. Skips where g++ or libjpeg's header is missing, as
tests/test_native.py does. Small JPEGs (<= 200 px), yolov5n at 160 px, CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.torch_port_helpers import (assert_same_rows, random_detector_weights,
                                      save_jax_checkpoint, write_shapes_dataset, yolov5n_cfg)
from yolov5_tpu_torch import native
from yolov5_tpu_torch.data.imageio import bmp_bytes, imwrite

cv2 = pytest.importorskip("cv2")
jax_native = pytest.importorskip("yolov5_tpu.native")

if not (native.available() and jax_native.available()):
    pytest.skip(f"native decoder unavailable ({native.unavailable_reason()})",
                allow_module_level=True)

REPO = Path(__file__).resolve().parents[1]
IMGSZ = 160
# (h, w): landscape, portrait, square, one below IMGSZ on both sides (scaleup
# True upscales it) and one narrow strip
DECODE_SHAPES = [(120, 200), (200, 90), (160, 160), (50, 70), (30, 190)]
SET_SHAPES = [(120, 160), (160, 120), (200, 150), (90, 160), (64, 100), (160, 160), (130, 100)]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Colour JPEGs of DECODE_SHAPES and two greyscale ones."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(DECODE_SHAPES):
        im = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 2)
        paths.append(str(d / f"c{i}.jpg"))
        assert cv2.imwrite(paths[-1], im, [cv2.IMWRITE_JPEG_QUALITY, 95])
    for i, (h, w) in enumerate([(100, 180), (140, 60)]):
        im = rng.integers(0, 256, (h, w), dtype=np.uint8)
        paths.append(str(d / f"g{i}.jpeg"))
        assert cv2.imwrite(paths[-1], im)
    return paths


@pytest.mark.parametrize("scaleup", [True, False])
@pytest.mark.parametrize("size", [IMGSZ, 96])
def test_decoder_bit_equal_to_jax(jpegs, scaleup, size):
    got, ref = (m.decode_letterbox_batch(jpegs, size, scaleup=scaleup)
                for m in (native, jax_native))
    assert got[2].all() and ref[2].all()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0].shape == (len(jpegs), size, size, 3)
    assert [tuple(hw) for hw in got[1]] == [cv2.imread(p).shape[:2] for p in jpegs]


def test_decoder_failures_match_jax(jpegs, tmp_path):
    """A missing file and one cut after its header: ok False in both, the
    other files decoded alike."""
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(Path(jpegs[0]).read_bytes()[:200])
    paths = [jpegs[0], str(tmp_path / "missing.jpg"), str(cut), jpegs[1]]
    got, ref = (m.decode_letterbox_batch(paths, 96) for m in (native, jax_native))
    np.testing.assert_array_equal(got[2], [True, False, False, True])
    np.testing.assert_array_equal(ref[2], got[2])
    for k in (0, 3):
        np.testing.assert_array_equal(got[0][k], ref[0][k])


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    """A JPEG val set of SET_SHAPES (labels, noise and rectangles) and its
    YAML; the images directory is the loaders' path."""
    root = tmp_path_factory.mktemp("jpegset")
    data = write_shapes_dataset(root, SET_SHAPES, ext=".jpg")
    (root / "data.yaml").write_text(yaml.safe_dump(data))
    return root


def _batches(create, path, **kw):
    _, loader = create(str(path), img_size=IMGSZ, batch_size=3, **kw)
    return loader, list(loader)


def _assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["images"], r["images"])
        np.testing.assert_allclose(g["targets"], r["targets"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(g["valid"], r["valid"])
        assert g["real"] == r["real"] and g["paths"] == r["paths"]
        np.testing.assert_array_equal(g["indices"], r["indices"])


def test_loader_defaults_match_jax_on_jpegs(jpeg_set):
    """Square val loaders with their defaults: the JAX loader takes its
    native path, and the port's gives the same batches byte for byte (before
    the port decoded with its cv path: ~18% of the pixels off by 1-4)."""
    from yolov5_tpu.data.dataset import create_loader as jax_create_loader
    from yolov5_tpu_torch.data.dataset import create_loader

    images = jpeg_set / "images" / "val"
    jl, ref = _batches(jax_create_loader, images)
    pl, got = _batches(create_loader, images)
    assert jl.native and pl.native
    assert got[-1]["real"] == len(SET_SHAPES) % 3
    _assert_same_batches(got, ref)
    # native=False in both: the cv paths, also equal to each other's
    _, cv_ref = _batches(jax_create_loader, images, native=False)
    _, cv_got = _batches(create_loader, images, native=False)
    _assert_same_batches(cv_got, cv_ref)


def test_loader_native_conditions(jpeg_set, tmp_path):
    """Rect batches come first; augmenting, masks or a non-JPEG file turn
    the native path off, as in the JAX package."""
    from yolov5_tpu.data.dataset import create_loader as jax_create_loader
    from yolov5_tpu_torch.data.dataset import create_loader

    images = jpeg_set / "images" / "val"
    pl, got = _batches(create_loader, images, rect=True)
    jl, ref = _batches(jax_create_loader, images, rect=True)
    assert pl.rect and pl.native and jl.native
    _assert_same_batches(got, ref)
    _, aug = create_loader(str(images), img_size=IMGSZ, augment=True, workers=1)
    _, seg = create_loader(str(images), img_size=IMGSZ, masks=True)
    assert not aug.native and not seg.native
    bmp = tmp_path / "images" / "val" / "x.bmp"
    bmp.parent.mkdir(parents=True)
    imwrite(bmp, np.full((40, 50, 3), 90, np.uint8))
    _, mixed = create_loader([str(images), str(bmp)], img_size=IMGSZ)
    assert not mixed.native


def test_loader_falls_back_for_undecodable_file(tmp_path):
    """A .jpg that libjpeg cannot decode (a BMP under a .jpg name) is read
    by get_item, in both packages; its labels and the other images agree.
    The JAX package writes that fall-back image in BGR (its _native_batch
    skips the channel flip); the port writes RGB, as its other paths do."""
    from yolov5_tpu.data.dataset import create_loader as jax_create_loader
    from yolov5_tpu_torch.data.dataset import create_loader

    write_shapes_dataset(tmp_path, SET_SHAPES[:4], ext=".jpg")
    images = tmp_path / "images" / "val"
    odd = images / "001.jpg"
    odd.write_bytes(bmp_bytes(cv2.imread(str(odd))))  # BMP bytes, .jpg name
    assert not native.decode_letterbox_batch([str(odd)], IMGSZ)[2][0]
    pl, got = _batches(create_loader, images)
    _, ref = _batches(jax_create_loader, images)
    _, cv = _batches(create_loader, images, native=False)
    assert pl.native
    np.testing.assert_array_equal(got[0]["images"][1], cv[0]["images"][1])
    np.testing.assert_array_equal(got[0]["images"][1], ref[0]["images"][1][..., ::-1])
    ref[0]["images"][1] = got[0]["images"][1]
    _assert_same_batches(got, ref)


def test_evaluator_run_on_jpegs_matches_jax(jpeg_set, monkeypatch):
    """evaluator.run(rect=False) on the JPEG set, through both packages'
    default (native) loaders on the same weights: the same detections and
    mAP within 1e-4 (the tolerance of tests/test_torch_eval.py)."""
    from yolov5_tpu.eval import evaluator as jax_evaluator
    from yolov5_tpu_torch.eval import evaluator

    w = save_jax_checkpoint(yolov5n_cfg(3), jpeg_set / "w.ckpt", weights=random_detector_weights)
    rows = {}
    for name, mod in (("jax", jax_evaluator), ("port", evaluator)):
        real = mod.detections_to_numpy
        rows[name] = []
        monkeypatch.setattr(mod, "detections_to_numpy",
                            lambda d, r=rows[name], f=real: r.extend(f(d)) or f(d))
    kw = dict(weights=str(w), imgsz=IMGSZ, batch_size=3, rect=False, verbose=False,
              project=str(jpeg_set / "runs"))
    ref = jax_evaluator.run(str(jpeg_set / "data.yaml"), **kw)
    got = evaluator.run(str(jpeg_set / "data.yaml"), device="cpu", **kw)
    assert sum(map(len, rows["port"])) > 0
    assert_same_rows(rows["port"], rows["jax"], atol=1e-3)
    assert got["images"] == ref["images"] == len(SET_SHAPES)
    for k in ("map50", "map"):
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])


def test_native_true_raises_where_it_cannot_build(jpeg_set, tmp_path, monkeypatch):
    """No g++ on PATH and no built library: available() is False with the
    reason, native=None quietly takes the cv path, native=True raises."""
    from yolov5_tpu_torch.data.dataset import create_loader

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "build" / "lib.so")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    assert not native.available()
    assert native.unavailable_reason() == "g++ not found on PATH"
    images = str(jpeg_set / "images" / "val")
    _, loader = create_loader(images, img_size=IMGSZ)
    assert not loader.native
    with pytest.raises(RuntimeError, match="native JPEG decoder is unavailable.*g\\+\\+ not found"):
        create_loader(images, img_size=IMGSZ, native=True)


def test_build_failure_reason_is_the_first_error_line(tmp_path, monkeypatch):
    """A source that does not compile (a missing header, as where libjpeg's
    is absent): the reason is g++'s first error line."""
    src = tmp_path / "bad.cpp"
    src.write_text("#include <no_such_header_here.h>\nint f() { return 1; }\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "build" / "bad.so")
    with pytest.raises(RuntimeError, match="no_such_header_here.h: No such file"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))


def test_library_lands_in_build_dir():
    path = native.library_path()
    assert native.available() and path.exists()
    assert path.parent == REPO / "yolov5_tpu_torch" / "build"
    assert path.name.startswith("libyolo_native-") and path.suffix == ".so"
    assert not list((REPO / "yolov5_tpu_torch" / "native").glob("*.so"))


_INTERLEAVE = """
import os, sys, numpy as np, torch
from yolov5_tpu_torch import native
paths = sys.argv[1:]
x = torch.randn(384, 384)
ref = native.decode_letterbox_batch(paths, 96)
outs = []
for _ in range(3):
    y = torch.matmul(x, x).sum().item()
    outs.append(native.decode_letterbox_batch(paths, 96))
    torch.set_num_threads(torch.get_num_threads())
assert all((o[0] == ref[0]).all() and o[2].all() for o in outs)
print(len(os.listdir("/proc/self/task")), torch.get_num_threads())
"""


def test_decoder_interleaves_with_torch_openmp(jpegs):
    """Batch decodes between torch matmuls in one fresh process: the same
    bytes each time, no crash, and threads bounded by the two pools' size."""
    proc = subprocess.run([sys.executable, "-c", _INTERLEAVE, *jpegs], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    threads, torch_threads = map(int, proc.stdout.split()[-2:])
    assert threads <= 2 * max(torch_threads, os.cpu_count() or 1) + 8, threads
