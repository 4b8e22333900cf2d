"""A 5x7 bitmap font for box labels, drawn with numpy.

The JAX package writes labels with ``cv2.getTextSize`` / ``cv2.putText``
(Hershey simplex); a machine without OpenCV draws them with this font
instead. Printable ASCII (32-126) only; any other character is drawn as
``?``. Each glyph is 5 columns of 7 bits (bit 0 the top row); a glyph cell
is 6 columns wide (one blank) and 7 rows high, drawn at an integer
``scale``.
"""

from __future__ import annotations

import numpy as np

_GLYPHS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"  # space ! " # $
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"  # % & ' ( )
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"  # * + , - .
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"  # / 0 1 2 3
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"  # 4 5 6 7 8
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"  # 9 : ; < =
    "0041221408" "0201510906" "3249794136" "7e1111117e" "7f49494936"  # > ? @ A B
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"  # C D E F G
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"  # H I J K L
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"  # M N O P Q
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"  # R S T U V
    "7f2018207f" "6314081463" "0304780403" "6151494543" "007f414100"  # W X Y Z [
    "0204081020" "0041417f00" "0402010204" "4040404040" "0001020400"  # \\ ] ^ _ `
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"  # a b c d e
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00"  # f g h i j
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"  # k l m n o
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"  # p q r s t
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"  # u v w x y
    "4464544c44" "0008364100" "00007f0000" "0041360800" "0201020402"  # z { | } ~
)
GLYPH_W, GLYPH_H, CELL_W = 5, 7, 6
# (95, 7, 5) bool: glyph, row, column
_BITMAPS = ((np.frombuffer(_GLYPHS, np.uint8).reshape(95, 1, GLYPH_W)
             >> np.arange(GLYPH_H, dtype=np.uint8)[None, :, None]) & 1).astype(bool)


def text_size(text: str, scale: int) -> tuple[int, int]:
    """(width, height) in pixels of ``text`` drawn at ``scale``."""
    return max(len(text) * CELL_W - 1, 0) * scale, GLYPH_H * scale


def render(text: str, scale: int) -> np.ndarray:
    """``text`` as a (GLYPH_H·scale, width) bool bitmap, True where ink."""
    codes = [ord(c) - 32 if 32 <= ord(c) <= 126 else ord("?") - 32 for c in text]
    if not codes:
        return np.zeros((GLYPH_H * scale, 0), bool)
    cells = np.zeros((len(codes), GLYPH_H, CELL_W), bool)
    cells[:, :, :GLYPH_W] = _BITMAPS[codes]
    line = cells.transpose(1, 0, 2).reshape(GLYPH_H, -1)[:, :-1]
    return line.repeat(scale, 0).repeat(scale, 1)


def put_text(im: np.ndarray, text: str, org, scale: int, color) -> None:
    """Draw ``text`` on the (h, w, 3) image in place, the bottom-left
    corner of its ink box at ``org`` = (x, y) (cv2.putText's origin: the
    bottom row is y - 1), clipped to the image."""
    ink = render(text, scale)
    x0, y0 = int(org[0]), int(org[1]) - ink.shape[0]
    h, w = im.shape[:2]
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + ink.shape[0], h), min(x0 + ink.shape[1], w)
    if ys >= ye or xs >= xe:
        return
    region = im[ys:ye, xs:xe]
    region[ink[ys - y0:ye - y0, xs - x0:xe - x0]] = color
