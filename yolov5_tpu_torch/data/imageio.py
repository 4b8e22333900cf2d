"""Image files without OpenCV or PIL where the format allows it.

The JAX package decodes with ``cv2.imread`` / ``cv2.imdecode``, writes with
``cv2.imwrite`` and reads image headers with PIL. A machine may have none of
them, so uncompressed 24-bit BMP (BI_RGB, with a 40-, 108- or 124-byte info
header, rows bottom-up or top-down) is read, decoded and written here with
numpy. Every other file goes to OpenCV (pixels; PIL too for writing) or PIL
(headers), imported only when such a file is met; if no module can take it,
the error names the file.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_INFO_HEADERS = (40, 108, 124)  # BITMAPINFOHEADER, BITMAPV4HEADER, BITMAPV5HEADER
_BI_RGB = 0


def _bmp_header(head: bytes):
    """(width, height, top_down, bits, compression, pixel offset) of a BMP
    with a 40/108/124-byte info header, or None for any other file."""
    if len(head) < 54 or head[:2] != b"BM":
        return None
    offset, info_size = struct.unpack_from("<II", head, 10)
    if info_size not in _INFO_HEADERS:
        return None
    w, h, _planes, bits, compression = struct.unpack_from("<iiHHI", head, 18)
    return w, abs(h), h < 0, bits, compression, offset


def _read_head(path, n=54) -> bytes:
    with open(path, "rb") as f:
        return f.read(n)


def _missing(path, module, what):
    return ImportError(f"{path}: {what} this file needs {module}, which is not "
                       "installed (only 24-bit uncompressed BMP is read and written "
                       "without it)")


def _is_bmp24(hdr) -> bool:
    return hdr is not None and hdr[3] == 24 and hdr[4] == _BI_RGB


def _bmp_pixels(hdr, data: bytes, name) -> np.ndarray:
    """The BGR (h, w, 3) pixels of a 24-bit BMP with header ``hdr`` from
    ``data``, the bytes from its pixel offset on."""
    w, h, top_down = hdr[:3]
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: BMP of size {w}x{h}")
    stride = (3 * w + 3) // 4 * 4  # rows are padded to 4 bytes
    if len(data) < stride * h:
        raise ValueError(f"{name}: truncated BMP ({len(data)} of {stride * h} pixel bytes)")
    rows = np.frombuffer(data, np.uint8, count=stride * h).reshape(h, stride)[:, :3 * w]
    im = rows.reshape(h, w, 3)
    return np.ascontiguousarray(im if top_down else im[::-1])


def imread(path) -> np.ndarray:
    """The image at ``path`` as BGR uint8 (h, w, 3), as ``cv2.imread`` gives
    it. Raises where ``cv2.imread`` would return None."""
    hdr = _bmp_header(_read_head(path))
    if _is_bmp24(hdr):
        with open(path, "rb") as f:
            f.seek(hdr[5])
            return _bmp_pixels(hdr, f.read(), path)
    try:
        import cv2
    except ImportError as e:
        raise _missing(path, "OpenCV (cv2)", "decoding") from e
    im = cv2.imread(str(path))
    if im is None:
        raise FileNotFoundError(f"image not found or not decodable: {path}")
    return im


def image_size(path):
    """(width, height, format) of the image at ``path``, format in lower
    case as PIL names it ("bmp", "jpeg", "png", ...). BMP headers are read
    here; any other file is opened and verified by PIL."""
    hdr = _bmp_header(_read_head(path))
    if hdr is not None:
        return hdr[0], hdr[1], "bmp"
    try:
        from PIL import Image
    except ImportError as e:
        raise _missing(path, "PIL", "reading the header of") from e
    with Image.open(path) as im:
        im.verify()
        w, h = im.size
        fmt = (im.format or "").lower()
    return w, h, fmt


def imdecode(buf):
    """Encoded image bytes -> BGR uint8 (h, w, 3), as ``cv2.imdecode(buf,
    IMREAD_COLOR)`` gives it, or None where the bytes are not an image it can
    decode. 24-bit BMP is decoded here; anything else needs OpenCV, and
    without it raises ``ImportError``."""
    data = bytes(buf)
    hdr = _bmp_header(data[:54])
    if _is_bmp24(hdr):
        try:
            return _bmp_pixels(hdr, data[hdr[5]:], "BMP bytes")
        except ValueError:
            return None
    try:
        import cv2
    except ImportError as e:
        raise ImportError("decoding these image bytes needs OpenCV (cv2), which is not "
                          "installed (only 24-bit uncompressed BMP is decoded without it)") from e
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def bmp_bytes(bgr) -> bytes:
    """A (h, w, 3) or (h, w) uint8 image as an uncompressed 24-bit bottom-up
    BMP file (BGR channel order, as OpenCV writes it)."""
    im = np.asarray(bgr, np.uint8)
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, 2)
    h, w, _ = im.shape
    stride = (3 * w + 3) // 4 * 4  # rows padded to 4 bytes
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = im[::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, _BI_RGB, rows.size, 2835, 2835, 0, 0)
    return head + info + rows.tobytes()


def imwrite(path, bgr) -> bool:
    """Write a BGR uint8 image, as ``cv2.imwrite`` does: ``.bmp`` as 24-bit
    BMP with numpy; any other suffix through OpenCV, else PIL, imported
    here; if neither is installed, ``ImportError`` names the file."""
    path = Path(path)
    if path.suffix.lower() == ".bmp":
        path.write_bytes(bmp_bytes(bgr))
        return True
    try:
        import cv2
    except ImportError:
        pass
    else:
        return bool(cv2.imwrite(str(path), bgr))
    try:
        from PIL import Image
    except ImportError as e:
        raise _missing(path, "OpenCV (cv2) or PIL", "writing") from e
    im = np.asarray(bgr, np.uint8)
    Image.fromarray(np.ascontiguousarray(im[..., ::-1] if im.ndim == 3 else im)).save(path)
    return True
