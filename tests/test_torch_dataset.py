"""The validation data path of yolov5_tpu_torch against yolov5_tpu: image
discovery, labels, verification, the label cache, rect shapes and every
batch of the rect and square loaders, on a JPEG set and a BMP set; and the
host utilities of utils/general."""

import struct

import numpy as np
import pytest

import yolov5_tpu.data.dataset as jds
import yolov5_tpu.utils.general as jgen
import yolov5_tpu_torch.data.dataset as pds
import yolov5_tpu_torch.utils.general as pgen
from tests.torch_port_helpers import write_polygon_dataset, write_shapes_dataset
from yolov5_tpu_torch.data.imageio import bmp_bytes, imread, imwrite
from yolov5_tpu_torch.data.letterbox import letterbox
from yolov5_tpu_torch.utils import profile

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
    the padded final batch included, exactly equal, both packages reading
    through their cv paths and caches (native=False; the native JPEG batches:
    tests/test_torch_native.py)."""
    jds_, jl = jds.create_loader(str(dataset), img_size=160, batch_size=4, rect=rect,
                                 stride=32, native=False, max_labels=8)
    ds, pl = pds.create_loader(str(dataset), img_size=160, batch_size=4, rect=rect,
                               stride=32, max_labels=8, cache=cache, native=False)
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


def _rect_reference(ds, chunk, hw, max_labels):
    """The rect batch as letterbox's canvas and a BGR -> RGB copy build it."""
    h, w = hw
    images = np.zeros((len(chunk), h, w, 3), np.uint8)
    targets = np.zeros((len(chunk), max_labels, 5), np.float32)
    valid = np.zeros((len(chunk), max_labels), bool)
    for b, i in enumerate(chunk):
        im, _, (rh, rw) = ds.load_image(int(i))
        im, ratio, (dw, dh) = letterbox(im, (h, w), auto=False, scaleup=False)
        images[b] = im[..., ::-1]
        lab = ds.labels[int(i)]
        n = min(len(lab), max_labels)
        if n:
            t = lab[:n].copy()
            sw, sh = ratio[0] * rw, ratio[1] * rh
            t[:, 1] = (t[:, 1] * sw + dw) / w
            t[:, 2] = (t[:, 2] * sh + dh) / h
            t[:, 3] = t[:, 3] * sw / w
            t[:, 4] = t[:, 4] * sh / h
            targets[b, :n] = t
            valid[b, :n] = True
    return {"images": images, "targets": targets, "valid": valid}


def _write_bmp_top_down(path, bgr):
    data = bytearray(bmp_bytes(bgr[::-1]))  # rows stored first to last
    struct.pack_into("<i", data, 22, -bgr.shape[0])  # a negative height: top-down
    path.write_bytes(bytes(data))


# at 160 px: long sides above (area shrink) and below (linear grow) img_size,
# and heights whose padding is odd (top and bottom differ); 9 images in
# batches of 4 leave a final batch of 1 and 3 copies
RECT_SHAPES = [(240, 180), (50, 70), (91, 160), (160, 120), (120, 160), (100, 130),
               (160, 160), (73, 160), (160, 99)]


@pytest.mark.parametrize("kind, cache", [("bmp", None), ("bmp-top-down", None), ("jpg", None),
                                         ("bmp", "ram"), ("bmp", "disk")])
def test_rect_batch_equals_letterbox(tmp_path, kind, cache):
    """``Loader._rect_batch`` (one write an image into a pre-padded batch)
    against ``load_image`` -> ``letterbox(auto=False, scaleup=False)`` ->
    ``[..., ::-1]``: images, targets and valid byte for byte, over every
    batch of a rect pass (the padded final batch included, cached reads on
    a second pass) and at a slot smaller than every image (the resize)."""
    if kind == "jpg":
        pytest.importorskip("cv2")
        write, ext = None, ".jpg"
    else:
        write, ext = (imwrite if kind == "bmp" else _write_bmp_top_down), ".bmp"
    write_shapes_dataset(tmp_path, RECT_SHAPES, ext=ext, write=write)
    if kind == "bmp-top-down":
        path = next((tmp_path / "images" / "val").glob("*.bmp"))
        assert struct.unpack_from("<i", path.read_bytes(), 22)[0] < 0
    ds, loader = pds.create_loader(str(tmp_path / "images" / "val"), img_size=160,
                                   batch_size=4, rect=True, stride=32, max_labels=8,
                                   cache=cache)
    grown = shrunk = odd = 0
    for _ in range(2 if cache else 1):
        batches = list(loader)
        assert len(batches) == 3 and batches[-1]["real"] == 1
        for batch in batches:
            chunk, real = batch["indices"], batch["real"]
            want = _rect_reference(ds, chunk, batch["images"].shape[1:3], 8)
            want["valid"][real:] = False  # padded copies carry no labels
            want["targets"][real:] = 0
            for k in ("images", "targets", "valid"):
                assert batch[k].dtype == want[k].dtype
                np.testing.assert_array_equal(batch[k], want[k])
            h, w = batch["images"].shape[1:3]
            for i in chunk[:real]:
                h0, w0 = ds.shapes[i]
                _, _, (rh, rw) = ds.load_image(int(i))
                grown += max(h0, w0) < 160
                shrunk += max(h0, w0) > 160
                odd += (h - rh) % 2 or (w - rw) % 2
    assert grown and shrunk and odd  # the cases the shapes are there for
    chunk = [0, 2, 5, 5]
    with profile.recording() as spans:
        got = loader._rect_batch(chunk, (64, 96))
    want = _rect_reference(ds, chunk, (64, 96), 8)
    for k in ("images", "targets", "valid"):
        np.testing.assert_array_equal(got[k], want[k])
    assert [(s.name, s.counts) for s in spans] == [("load.rect", {"images": 4, "resized": 4})]


def _square_reference(loader, chunk, real, base_seed):
    """A square batch as ``get_item`` (letterbox's canvas) and a BGR -> RGB
    copy of each image build it, its GT masks by ``rasterize_masks``."""
    ds, cap = loader.ds, loader.max_labels
    s = ds.img_size
    samples = [ds.get_item(int(i), np.random.default_rng(base_seed + int(i)))
               for i in chunk[:real]]
    samples += [samples[-1]] * (len(chunk) - real)
    images = np.zeros((len(chunk), s, s, 3), np.uint8)
    targets = np.zeros((len(chunk), cap, 5), np.float32)
    valid = np.zeros((len(chunk), cap), bool)
    hm = s // loader.mask_ratio
    masks = (np.zeros((len(chunk), hm, hm), np.int32) if loader.overlap
             else np.zeros((len(chunk), cap, hm, hm), np.uint8))
    for b, (im, labels, segments) in enumerate(samples):
        images[b] = im[..., ::-1]
        n = min(len(labels), cap)
        targets[b, :n] = labels[:n]
        valid[b, :n] = True
        if segments:
            m = pds.rasterize_masks(segments[:cap], labels, hm, hm, s, overlap=loader.overlap)
            if loader.overlap:
                masks[b] = m
            else:
                masks[b, :m.shape[0]] = m
    want = {"images": images, "targets": targets, "valid": valid}
    if loader.masks:
        want["masks"] = masks
    return want


SQUARE_CASES = [(source, masks, False) for source in ("bmp", "bmp-top-down", "ram")
                for masks in ("off", "overlap", "per-instance")]
SQUARE_CASES += [("bmp", "off", True), ("bmp", "overlap", True)]


@pytest.mark.parametrize("source, masks, augment", SQUARE_CASES)
def test_square_batch_equals_letterbox(tmp_path, source, masks, augment):
    """The square loader's batches against ``get_item`` -> ``letterbox``'s
    canvas -> ``[..., ::-1]`` -> ``rasterize_masks``: images, targets, valid
    and GT masks byte for byte with their dtypes, over every batch of a pass
    (the padded final batch included, cached reads on a second pass), with
    images grown and shrunk by ``load_image`` and odd paddings. A validation
    batch writes every slot once (``load.square`` counts ``written ==
    images``); an augmented batch is built as before and counts 0."""
    write_polygon_dataset(tmp_path, RECT_SHAPES)
    root = tmp_path / "images" / "val"
    if source == "bmp-top-down":
        for path in root.glob("*.bmp"):
            _write_bmp_top_down(path, imread(path))
        assert struct.unpack_from("<i", path.read_bytes(), 22)[0] < 0
    ds, loader = pds.create_loader(str(root), img_size=160, batch_size=4, max_labels=8,
                                   workers=1 if augment else 3, augment=augment,
                                   cache="ram" if source == "ram" else False,
                                   masks=masks != "off", overlap=masks != "per-instance")
    grown = shrunk = odd = 0
    for epoch in range(2 if source == "ram" else 1):
        loader.set_epoch(epoch)
        with profile.recording() as spans:
            batches = list(loader)
        assert len(batches) == (2 if augment else 3) and batches[-1]["real"] == (4 if augment
                                                                                 else 1)
        square = [s for s in spans if s.name == "load.square"]
        assert len(square) == len(batches)
        for batch, span in zip(batches, square):
            chunk, real = batch["indices"], batch["real"]
            assert span.counts["images"] == len(chunk)
            assert span.counts["written"] == (0 if augment else len(chunk))
            want = _square_reference(loader, chunk, real, loader.seed * 100003 + epoch * 1009)
            assert batch.keys() - {"real", "indices", "paths"} == want.keys()
            for k in want:
                assert batch[k].dtype == want[k].dtype
                np.testing.assert_array_equal(batch[k], want[k])
            for i in chunk[:real]:
                _, _, (rh, rw) = ds.load_image(int(i))
                grown += max(ds.shapes[i]) < 160
                shrunk += max(ds.shapes[i]) > 160
                odd += (160 - rh) % 2 or (160 - rw) % 2
    assert augment or (grown and shrunk and odd)  # the cases the shapes are there for


def test_loader_single_cls_and_unported_options(dataset):
    """single_cls; host augmentation and segmentation masks are ported now
    (an augmented loader yields batches, a mask loader mask batches: empty
    for box labels, as in the JAX package); the per-rank shard is ported
    too: a training loader takes one (tests/test_torch_parallel.py), and a
    validation loader, which every rank reads whole, refuses it."""
    ds, _ = pds.create_loader(str(dataset), img_size=160, single_cls=True)
    assert all((l[:, 0] == 0).all() for l in ds.labels)
    _, loader = pds.create_loader(str(dataset), img_size=160, batch_size=2, augment=True,
                                  workers=1)
    assert next(iter(loader))["images"].shape == (2, 160, 160, 3)
    _, loader = pds.create_loader(str(dataset), img_size=160, batch_size=2, masks=True)
    masks = next(iter(loader))["masks"]
    assert masks.shape == (2, 40, 40) and masks.dtype == np.int32 and not masks.any()
    with pytest.raises(ValueError, match="shard"):
        pds.create_loader(str(dataset), shard=(0, 2))
    _, loader = pds.create_loader(str(dataset), img_size=160, batch_size=1, augment=True,
                                  workers=1, shard=(1, 2))
    assert (loader.rank, loader.world) == (1, 2)


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
    # clearml:// goes to the ClearML SDK, in both packages (not installed here;
    # tests/test_torch_loggers.py drives it with a fake one)
    for gen in (pgen, jgen):
        with pytest.raises(ImportError, match="clearml"):
            gen.check_dataset("clearml://abc")
