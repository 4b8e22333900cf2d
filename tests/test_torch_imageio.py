"""yolov5_tpu_torch.data.imageio against OpenCV and PIL: BMP pixels equal
cv2.imread's exactly, sizes and formats equal PIL's, BMP written here reads
back in cv2 and decodes from bytes as cv2.imdecode does, and a format that
needs a missing module raises ImportError naming the file."""

import struct
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from yolov5_tpu_torch.data.imageio import bmp_bytes, image_size, imdecode, imread, imwrite

# odd widths exercise the 4-byte row padding (3w mod 4 = 1, 2, 3, 0)
SHAPES = [(10, 13), (17, 10), (11, 15), (12, 16), (1, 1), (33, 7)]


def _bmp_bytes(bgr, info_size=40, top_down=False):
    """A 24-bit BI_RGB BMP with an info header of ``info_size`` bytes."""
    h, w, _ = bgr.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = (bgr if top_down else bgr[::-1]).reshape(h, 3 * w)
    offset = 14 + info_size
    info = struct.pack("<IiiHHIIiiII", info_size, w, -h if top_down else h, 1, 24, 0,
                       rows.size, 2835, 2835, 0, 0)
    info += bytes(info_size - 40)  # V4/V5 masks, colour space: unused for BI_RGB
    head = struct.pack("<2sIHHI", b"BM", offset + rows.size, 0, 0, offset)
    return head + info + rows.tobytes()


@pytest.mark.parametrize("hw", SHAPES)
def test_bmp_written_by_cv2(tmp_path, hw):
    im = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    p = tmp_path / "a.bmp"
    assert cv2.imwrite(str(p), im)
    got = imread(p)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, cv2.imread(str(p)))
    np.testing.assert_array_equal(got, im)
    with Image.open(p) as ref:
        assert image_size(p) == (*ref.size, ref.format.lower())


@pytest.mark.parametrize("hw", SHAPES)
def test_bmp_written_by_pil(tmp_path, hw):
    rgb = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    p = tmp_path / "a.bmp"
    Image.fromarray(rgb).save(p)
    np.testing.assert_array_equal(imread(p), cv2.imread(str(p)))
    np.testing.assert_array_equal(imread(p), rgb[..., ::-1])
    assert image_size(p) == (hw[1], hw[0], "bmp")


@pytest.mark.parametrize("info_size", [40, 108, 124])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_headers_and_row_order(tmp_path, info_size, top_down):
    im = np.random.default_rng(info_size).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    p = tmp_path / "a.bmp"
    p.write_bytes(_bmp_bytes(im, info_size, top_down))
    np.testing.assert_array_equal(imread(p), im)
    np.testing.assert_array_equal(imread(p), cv2.imread(str(p)))
    with Image.open(p) as ref:
        assert image_size(p) == (*ref.size, "bmp")


def test_truncated_bmp_raises(tmp_path):
    p = tmp_path / "a.bmp"
    p.write_bytes(_bmp_bytes(np.zeros((8, 8, 3), np.uint8))[:-10])
    with pytest.raises(ValueError, match="truncated"):
        imread(p)


@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_other_formats_go_to_cv2_and_pil(tmp_path, ext):
    im = np.random.default_rng(0).integers(0, 256, (21, 17, 3), dtype=np.uint8)
    p = tmp_path / f"a{ext}"
    assert cv2.imwrite(str(p), im)
    np.testing.assert_array_equal(imread(p), cv2.imread(str(p)))
    with Image.open(p) as ref:
        assert image_size(p) == (17, 21, ref.format.lower())


def test_missing_decoder_raises_naming_the_file(tmp_path, monkeypatch):
    p = tmp_path / "photo.jpg"
    assert cv2.imwrite(str(p), np.zeros((12, 12, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    with pytest.raises(ImportError, match="photo.jpg"):
        imread(p)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="photo.jpg"):
        image_size(p)
    b = tmp_path / "a.bmp"
    b.write_bytes(_bmp_bytes(np.ones((10, 10, 3), np.uint8)))
    assert imread(b).sum() == 300 and image_size(b) == (10, 10, "bmp")


def test_missing_decoder_is_not_a_corrupt_image(tmp_path, monkeypatch):
    """verify_image_label reports a corrupt image and carries on, but a
    missing module raises."""
    from yolov5_tpu_torch.data.dataset import verify_image_label

    p = tmp_path / "photo.png"
    assert cv2.imwrite(str(p), np.zeros((12, 12, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="photo.png"):
        verify_image_label(str(p), str(tmp_path / "photo.txt"))


@pytest.mark.parametrize("hw", SHAPES)
def test_imwrite_bmp_round_trips(tmp_path, hw):
    """imwrite's BMP reads back equal through imread and cv2.imread, and its
    bytes decode as cv2.imdecode decodes them; so do cv2.imencode's."""
    im = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    p = tmp_path / "w.bmp"
    assert imwrite(p, im)
    np.testing.assert_array_equal(imread(p), im)
    np.testing.assert_array_equal(cv2.imread(str(p)), im)
    data = p.read_bytes()
    assert data == bmp_bytes(im)
    np.testing.assert_array_equal(imdecode(data), cv2.imdecode(np.frombuffer(data, np.uint8),
                                                               cv2.IMREAD_COLOR))
    enc = cv2.imencode(".bmp", im)[1]
    np.testing.assert_array_equal(imdecode(enc), im)
    np.testing.assert_array_equal(imdecode(enc.tobytes()), im)


def test_imwrite_gray_and_other_suffixes(tmp_path):
    gray = np.arange(35, dtype=np.uint8).reshape(5, 7)
    assert imwrite(tmp_path / "g.bmp", gray)
    np.testing.assert_array_equal(imread(tmp_path / "g.bmp"), np.repeat(gray[..., None], 3, 2))
    im = np.random.default_rng(1).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    assert imwrite(tmp_path / "a.png", im)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), im)


def test_imdecode_other_formats_and_garbage():
    im = np.random.default_rng(2).integers(0, 256, (13, 9, 3), dtype=np.uint8)
    for ext in (".png", ".jpg"):
        enc = cv2.imencode(ext, im)[1]
        np.testing.assert_array_equal(imdecode(enc.tobytes()),
                                      cv2.imdecode(enc, cv2.IMREAD_COLOR))
    assert imdecode(b"not an image") is None
    assert imdecode(bmp_bytes(im)[:100]) is None  # truncated BMP


def test_imwrite_and_imdecode_without_cv2(tmp_path, monkeypatch):
    """Without OpenCV: PNG is written through PIL, and without PIL too the
    error names the file; decoding a PNG raises ImportError naming OpenCV;
    BMP needs neither."""
    im = np.random.default_rng(3).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    png = cv2.imencode(".png", im)[1].tobytes()
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert imwrite(tmp_path / "p.png", im)
    with Image.open(tmp_path / "p.png") as f:
        np.testing.assert_array_equal(np.asarray(f)[..., ::-1], im)
    with pytest.raises(ImportError, match="OpenCV"):
        imdecode(png)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="q.jpg"):
        imwrite(tmp_path / "q.jpg", im)
    assert imwrite(tmp_path / "b.bmp", im)
    np.testing.assert_array_equal(imdecode((tmp_path / "b.bmp").read_bytes()), im)
