"""The validation data path of yolov5_tpu_torch against yolov5_tpu: image
discovery, labels, verification, the label cache, rect shapes and every
batch of the rect and square loaders, on a JPEG set and a BMP set; and the
host utilities of utils/general."""

import numpy as np
import pytest

import yolov5_tpu.data.dataset as jds
import yolov5_tpu.utils.general as jgen
import yolov5_tpu_torch.data.dataset as pds
import yolov5_tpu_torch.utils.general as pgen
from tests.torch_port_helpers import write_shapes_dataset

# 11 images: batches of 4 leave a padded final batch of 3
SHAPES = [(120, 160), (160, 120), (160, 160), (90, 160), (200, 150), (64, 160),
          (160, 160), (130, 100), (50, 70), (160, 100), (100, 160)]


@pytest.fixture(scope="module", params=[".jpg", ".bmp"])
def dataset(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("ds" + request.param[1:])
    write_shapes_dataset(root, SHAPES, ext=request.param)
    return root / "images" / "val"


def _same(a, b):
    """Equal nested results: arrays exactly, containers item by item."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_find_images_and_label_paths(dataset, tmp_path):
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(str(p) for p in sorted(dataset.glob("*"))[:5]) + "\n")
    for spec in (str(dataset), str(dataset / "*.*"), str(listing), [str(dataset), str(listing)]):
        files = pds.find_images(spec)
        assert files and files == jds.find_images(spec)
        assert pds.img2label_paths(files) == jds.img2label_paths(files)


def test_load_label_file(tmp_path):
    cases = {
        "boxes": "0 0.5 0.5 0.2 0.3\n2 0.1 0.2 0.1 0.1\n",
        "polygons": "1 0.1 0.1 0.4 0.1 0.4 0.5 0.1 0.5\n0 0.6 0.6 0.9 0.6 0.8 0.9\n",
        "mixed": "1 0.1 0.1 0.4 0.1 0.4 0.5\n0 0.5 0.5 0.2 0.3\n",
        "clipped": "0 1.2 -0.1 0.5 0.5\n",
        "empty": "",
    }
    for name, text in cases.items():
        p = tmp_path / f"{name}.txt"
        p.write_text(text)
        _same(pds.load_label_file(str(p)), jds.load_label_file(str(p)))
    _same(pds.load_label_file(str(tmp_path / "absent.txt")),
          jds.load_label_file(str(tmp_path / "absent.txt")))


def test_verify_image_label(dataset, tmp_path):
    im = sorted(dataset.glob("*"))[0]
    labels = {
        "dup": "0 0.5 0.5 0.2 0.3\n1 0.2 0.2 0.1 0.1\n0 0.5 0.5 0.2 0.3\n",
        "negative": "0 -0.5 0.5 0.2 0.3\n",
        "unnormalized": "0 0.5 0.5 0.2 0.3\n0 1.5 0.5 0.2 0.3\n",
        "ok": "2 0.5 0.5 0.2 0.3\n",
    }
    for name, text in labels.items():
        lb = tmp_path / f"{name}.txt"
        lb.write_text(text)
        _same(pds.verify_image_label(str(im), str(lb)), jds.verify_image_label(str(im), str(lb)))
    small = tmp_path / f"small{im.suffix}"
    import cv2

    cv2.imwrite(str(small), np.zeros((8, 20, 3), np.uint8))
    got, ref = (m.verify_image_label(str(small), str(tmp_path / "ok.txt")) for m in (pds, jds))
    assert got[0] is None and ref[0] is None and "< 10 pixels" in got[3]


def test_label_cache_across_packages(dataset, monkeypatch):
    """Each package writes labels/val.cache.npy; neither takes the other's
    file for its own: a file of the other package's version, even with the
    right hash and bogus labels, is rebuilt over."""
    im_files = pds.find_images(str(dataset))
    lb_files = pds.img2label_paths(im_files)
    cache = dataset.parent.parent / "labels" / "val.cache.npy"
    truth = jds.load_or_build_label_cache(im_files, lb_files)
    for reader, writer in ((pds, jds), (jds, pds)):
        cache.unlink(missing_ok=True)
        writer.load_or_build_label_cache(im_files, lb_files)
        assert np.load(cache, allow_pickle=True).item()["version"] == writer.CACHE_VERSION
        _same(reader.load_or_build_label_cache(im_files, lb_files), truth)
        assert np.load(cache, allow_pickle=True).item()["version"] == reader.CACHE_VERSION
        bogus = np.load(cache, allow_pickle=True).item()
        bogus["version"] = writer.CACHE_VERSION
        bogus["labels"] = [np.zeros((0, 5), np.float32)] * len(bogus["labels"])
        np.save(str(cache), bogus, allow_pickle=True)
        _same(reader.load_or_build_label_cache(im_files, lb_files), truth)
    # its own cache is read back without verifying again
    pds.load_or_build_label_cache(im_files, lb_files)
    monkeypatch.setattr(pds, "verify_image_label", None)
    _same(pds.load_or_build_label_cache(im_files, lb_files), truth)


@pytest.mark.parametrize("bs", [1, 4, 32])
@pytest.mark.parametrize("img_size", [160, 640])
def test_rect_batch_shapes(bs, img_size):
    shapes = np.random.default_rng(bs + img_size).integers(20, 1000, (37, 2)).astype(np.int32)
    buckets = tuple(sorted(set(list(range(128, img_size, 64)) + [img_size])))
    for b in (None, buckets):
        _same(pds.rect_batch_shapes(shapes, bs, img_size, 32, 0.5, buckets=b),
              jds.rect_batch_shapes(shapes, bs, img_size, 32, 0.5, buckets=b))


@pytest.mark.parametrize("rect", [True, False])
@pytest.mark.parametrize("cache", [None, "ram", "disk"])
def test_loader_batches_equal_jax(dataset, rect, cache):
    """images, targets, valid, real, indices and paths of every batch,
    the padded final batch included, exactly equal."""
    jds_, jl = jds.create_loader(str(dataset), img_size=160, batch_size=4, rect=rect,
                                 stride=32, native=False, max_labels=8)
    ds, pl = pds.create_loader(str(dataset), img_size=160, batch_size=4, rect=rect,
                               stride=32, max_labels=8, cache=cache)
    np.testing.assert_array_equal(ds.shapes, jds_.shapes)
    _same(ds.labels, jds_.labels)
    assert len(pl) == len(jl) == 3
    for epoch in range(2 if cache else 1):  # the second pass reads the cache
        got, ref = list(pl), list(jl)
        assert len(got) == len(ref) == 3 and got[-1]["real"] == 3
        for g, r in zip(got, ref):
            _same(g, r)
    if cache == "disk":
        assert len(list(dataset.glob("*.npy"))) == len(SHAPES)
        for p in dataset.glob("*.npy"):
            p.unlink()


def test_loader_single_cls_and_unported_options(dataset):
    """single_cls; host augmentation and segmentation masks are ported now
    (an augmented loader yields batches, a mask loader mask batches: empty
    for box labels, as in the JAX package); the JAX loader's option the port
    has not (a per-rank shard) is not accepted."""
    ds, _ = pds.create_loader(str(dataset), img_size=160, single_cls=True)
    assert all((l[:, 0] == 0).all() for l in ds.labels)
    _, loader = pds.create_loader(str(dataset), img_size=160, batch_size=2, augment=True,
                                  workers=1)
    assert next(iter(loader))["images"].shape == (2, 160, 160, 3)
    _, loader = pds.create_loader(str(dataset), img_size=160, batch_size=2, masks=True)
    masks = next(iter(loader))["masks"]
    assert masks.shape == (2, 40, 40) and masks.dtype == np.int32 and not masks.any()
    with pytest.raises(TypeError, match="shard"):
        pds.create_loader(str(dataset), shard=True)


def test_general_utils(tmp_path):
    for v in (64, 100, 640, [100, 200]):
        assert pgen.check_img_size(v, 32) == jgen.check_img_size(v, 32)
    run = tmp_path / "runs" / "exp"
    for _ in range(3):
        a = pgen.increment_path(run, mkdir=True)
        a.rmdir()
        assert a == jgen.increment_path(run, mkdir=True)
    root = tmp_path / "d"
    (root / "images" / "val").mkdir(parents=True)
    for data in ({"path": str(root), "val": "images/val", "names": ["a", "b"]},
                 {"path": str(root), "train": "images/val", "nc": 2}):
        assert pgen.check_dataset(data) == jgen.check_dataset(data)
    yml = tmp_path / "d.yaml"
    yml.write_text(f"path: {root}\nval: images/val\nnames: {{0: x}}\n")
    assert pgen.check_dataset(str(yml)) == jgen.check_dataset(str(yml))
    with pytest.raises(FileNotFoundError):  # a preset whose split is not there
        pgen.check_dataset("coco128")
    with pytest.raises(NotImplementedError, match="loggers"):
        pgen.check_dataset("clearml://abc")
