"""Image files without OpenCV or PIL where the format allows it.

The JAX package decodes with ``cv2.imread`` and reads image headers with
PIL. A machine may have neither, so uncompressed 24-bit BMP (BI_RGB, with a
40-, 108- or 124-byte info header, rows bottom-up or top-down) is read here
with numpy. Every other file goes to OpenCV (pixels) or PIL (headers),
imported only when such a file is met; if the module is missing, the error
names the file.
"""

from __future__ import annotations

import struct

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
                       "installed (only 24-bit uncompressed BMP is read without it)")


def imread(path) -> np.ndarray:
    """The image at ``path`` as BGR uint8 (h, w, 3), as ``cv2.imread`` gives
    it. Raises where ``cv2.imread`` would return None."""
    hdr = _bmp_header(_read_head(path))
    if hdr is not None and hdr[3] == 24 and hdr[4] == _BI_RGB:
        w, h, top_down, _, _, offset = hdr
        if w <= 0 or h <= 0:
            raise ValueError(f"{path}: BMP of size {w}x{h}")
        stride = (3 * w + 3) // 4 * 4  # rows are padded to 4 bytes
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(stride * h)
        if len(data) < stride * h:
            raise ValueError(f"{path}: truncated BMP ({len(data)} of {stride * h} "
                             "pixel bytes)")
        rows = np.frombuffer(data, np.uint8).reshape(h, stride)[:, :3 * w]
        im = rows.reshape(h, w, 3)
        return np.ascontiguousarray(im if top_down else im[::-1])
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
