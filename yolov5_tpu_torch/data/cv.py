"""Numpy versions of the OpenCV calls that host augmentation and image
loading make, so that no path of the port needs OpenCV (the card's machine
has none).

Each function names its cv2 counterpart and how close it comes to OpenCV
5.0 (``tests/test_torch_cv.py`` holds it there):
- ``resize``: ``cv2.resize`` with ``INTER_LINEAR`` (bit-exact: OpenCV's
  11-bit fixed-point weights and its vector code's rounding) and
  ``INTER_AREA`` for shrinking (bit-exact at integer factors, within one
  level elsewhere); float32 masks with ``INTER_LINEAR`` (OpenCV's float
  weights, within 2.4e-7 on values in [0, 1]: its sums round in another
  order);
- ``warp_affine``, ``warp_perspective``: ``cv2.warpAffine`` /
  ``cv2.warpPerspective``, bilinear, constant border (within one level on at
  most 0.1% of the pixels: OpenCV 5 maps coordinates in float32, as here, but
  in another order of operations);
- ``rotation_matrix_2d``: ``cv2.getRotationMatrix2D`` (equal);
- ``bgr_to_hsv``, ``hsv_to_bgr``: ``cv2.cvtColor`` with ``COLOR_BGR2HSV`` /
  ``COLOR_HSV2BGR`` on uint8 (bit-exact over every input);
- ``fill_poly``: ``cv2.drawContours(..., FILLED)`` / ``cv2.fillPoly`` of one
  int32 polygon, 8-connected (the same pixels);
- ``contour_area``: ``cv2.contourArea`` (equal).
There is one implementation of each: none of them calls OpenCV when it
happens to be installed.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def _linear_taps(n_src, n_dst, clamp_weights):
    """Source indices (i0, i1) and 11-bit weights (w0, w1) of each output
    position along one axis (OpenCV's resize tables: coordinates in float32,
    ``cvRound(w * 2048)``). Horizontally OpenCV moves an out-of-range tap's
    whole weight onto the border pixel; vertically it clamps the row indices
    and keeps the weights."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(_F32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(_F32)).astype(_F32)
    if clamp_weights:
        lo, hi = i0 < 0, i0 >= n_src - 1
        f[lo | hi] = 0
        i0 = np.where(lo, 0, np.where(hi, n_src - 1, i0))
    i1 = np.clip(i0 + 1, 0, n_src - 1)
    i0 = np.clip(i0, 0, n_src - 1)
    w0 = np.rint((_F32(1) - f) * _F32(2048)).astype(np.int32)
    w1 = np.rint(f * _F32(2048)).astype(np.int32)
    return i0, i1, w0, w1


def _resize_linear(im, w, h):
    h0, w0 = im.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w0, w, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(h0, h, clamp_weights=False)
    src = im.reshape(h0, w0, -1).astype(np.int32)
    rows = np.unique(np.concatenate([y0, y1]))
    hor = np.zeros((h0, w, src.shape[2]), np.int32)
    s = src[rows]
    hor[rows] = s[:, x0] * a0[:, None] + s[:, x1] * a1[:, None]
    # the vector code's rounding: ((b0*(r0>>4))>>16 + (b1*(r1>>4))>>16 + 2) >> 2
    top = (b0[:, None, None] * (hor[y0] >> 4)) >> 16
    bot = (b1[:, None, None] * (hor[y1] >> 4)) >> 16
    out = np.clip((top + bot + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + im.shape[2:])


def _resize_area(im, w, h):
    h0, w0 = im.shape[:2]
    sx, sy = 1.0 / (w / w0), 1.0 / (h / h0)  # OpenCV's scale factors
    if sx < 1 or sy < 1:
        raise ValueError(f"resize: 'area' only shrinks ({w0}x{h0} -> {w}x{h})")
    kx, ky = int(round(sx)), int(round(sy))
    src = im.astype(np.int64)
    if abs(sx - kx) < 2.220446049250313e-16 and abs(sy - ky) < 2.220446049250313e-16:
        # integer factors: block sums; a 2x2 block rounds as OpenCV's vector
        # code does, (sum + 2) >> 2, any other as cvRound(sum * (1.f / area))
        blocks = src.reshape((h, ky, w, kx) + im.shape[2:]).sum((1, 3))
        if kx == ky == 2 and (im.ndim == 2 or im.shape[2] in (1, 3, 4)):
            out = (blocks + 2) >> 2
        else:
            out = np.rint(blocks.astype(_F32) * _F32(1.0 / (kx * ky)))
        return np.clip(out, 0, 255).astype(np.uint8)

    def taps(n_src, n_dst, scale):
        # the source pixels each output pixel's interval covers, and their shares
        lo = np.arange(n_dst) * scale
        hi = np.minimum(lo + scale, n_src)
        idx = np.floor(lo).astype(np.int64)[:, None] + np.arange(int(np.ceil(scale)) + 1)
        wt = np.clip(np.minimum(hi[:, None], idx + 1) - np.maximum(lo[:, None], idx), 0, None)
        return np.minimum(idx, n_src - 1), wt / wt.sum(1, keepdims=True)

    src = src.reshape(h0, w0, -1).astype(np.float64)
    ix, wx = taps(w0, w, sx)
    iy, wy = taps(h0, h, sy)
    tmp = sum(src[:, ix[:, k]] * wx[None, :, k, None] for k in range(ix.shape[1]))
    out = sum(tmp[iy[:, k]] * wy[:, k, None, None] for k in range(iy.shape[1]))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape((h, w) + im.shape[2:])


def _resize_linear_f32(im, w, h):
    """Float32 bilinear: OpenCV's float tables (weights 1 - f and f, the
    horizontal taps moved onto the border pixel), the horizontal pass in
    float32 and the vertical one as ``S0 * b0 + S1 * b1`` rounded once, as
    its vector loop's multiply-add computes it. An exact 2x shrink is the
    mean of each 2 x 2 block."""
    h0, w0 = im.shape[:2]
    src = im.reshape(h0, w0, -1).astype(_F32)
    if w0 == 2 * w and h0 == 2 * h:
        s = src.reshape(h, 2, w, 2, -1)
        out = ((s[:, 0, :, 0] + s[:, 0, :, 1]) + (s[:, 1, :, 0] + s[:, 1, :, 1])) * _F32(0.25)
        return out.reshape((h, w) + im.shape[2:])

    def taps(n_src, n_dst):  # the coordinate in float64, its fraction cast to float32
        f = (np.arange(n_dst) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5
        i0 = np.floor(f)
        return i0.astype(np.int64), (f - i0).astype(_F32)

    x0, fx = taps(w0, w)
    edge = (x0 < 0) | (x0 >= w0 - 1)
    fx[edge] = 0
    x0 = np.clip(x0, 0, w0 - 1)
    x1 = np.clip(x0 + 1, 0, w0 - 1)
    y0, fy = taps(h0, h)
    y1 = np.clip(y0 + 1, 0, h0 - 1)
    y0 = np.clip(y0, 0, h0 - 1)
    # only the output rows and columns with a nonzero tap are computed: the
    # others are 0 * w + 0 * w = 0 exactly (a mask cropped to its box is
    # mostly zeros)
    nz = src != 0
    cols = nz.any((0, 2))
    cols = np.flatnonzero(cols[x0] | cols[x1])
    rows = nz.any((1, 2))
    rows = np.flatnonzero(rows[y0] | rows[y1])
    out = np.zeros((h, w, src.shape[2]), _F32)
    if len(rows) and len(cols):
        xa, xb, f = x0[cols], x1[cols], fx[cols][:, None]
        hor = src[:, xa] * (_F32(1) - f) + src[:, xb] * f
        b0 = (_F32(1) - fy[rows]).astype(np.float64)[:, None, None]
        prod1 = (hor[y1[rows]] * fy[rows][:, None, None]).astype(_F32)
        out[np.ix_(rows, cols)] = (hor[y0[rows]].astype(np.float64) * b0 + prod1).astype(_F32)
    return out.reshape((h, w) + im.shape[2:])


def resize(im, dsize, interpolation="linear"):
    """``cv2.resize(im, dsize, interpolation=INTER_LINEAR | INTER_AREA)`` of a
    uint8 (h, w) or (h, w, c) image; ``dsize`` is (width, height).
    "linear" is bit-exact; "area" (shrinking only) is bit-exact at integer
    factors and within one level elsewhere. A float32 image takes "linear"
    only (OpenCV's float path, within 2.4e-7 on values in [0, 1])."""
    w, h = int(dsize[0]), int(dsize[1])
    h0, w0 = im.shape[:2]
    if (w, h) == (w0, h0):
        return im.copy()
    if im.dtype == np.float32:
        if interpolation != "linear":
            raise ValueError(f"resize: float32 images take 'linear', not {interpolation!r}")
        return _resize_linear_f32(im, w, h)
    if interpolation == "linear":
        # OpenCV resizes an exact 2x shrink as INTER_AREA
        if w0 == 2 * w and h0 == 2 * h:
            return _resize_area(im, w, h)
        return _resize_linear(im, w, h)
    if interpolation == "area":
        return _resize_area(im, w, h)
    raise ValueError(f"resize: interpolation {interpolation!r} (linear or area)")


# ---------------------------------------------------------------------------
# warps
# ---------------------------------------------------------------------------

def _sample(im, X, Y, border):
    """Bilinear samples of uint8 ``im`` at float32 source coordinates (X, Y),
    taps outside the image reading ``border``; rounded to uint8."""
    h, w = im.shape[:2]
    c = 1 if im.ndim == 2 else im.shape[2]
    pad = np.empty((h + 2, w + 2, c), np.uint8)  # a 1-pixel frame of the border value
    pad[...] = np.asarray(border)[:c] if np.ndim(border) else border
    pad[1:-1, 1:-1] = im.reshape(h, w, c)
    X = np.clip(X, _F32(-2), _F32(w + 1))
    Y = np.clip(Y, _F32(-2), _F32(h + 1))
    x0, y0 = np.floor(X), np.floor(Y)
    fx, fy = (X - x0)[..., None], (Y - y0)[..., None]
    x0, y0 = x0.astype(np.int32), y0.astype(np.int32)
    xi, xj = np.clip(x0 + 1, 0, w + 1), np.clip(x0 + 2, 0, w + 1)  # padded columns
    yi, yj = np.clip(y0 + 1, 0, h + 1) * (w + 2), np.clip(y0 + 2, 0, h + 1) * (w + 2)
    flat = pad.reshape(-1, c)
    tap = lambda yy, xx: flat[yy + xx].astype(_F32)
    one = _F32(1)
    top = tap(yi, xi) * (one - fx) + tap(yi, xj) * fx
    bot = tap(yj, xi) * (one - fx) + tap(yj, xj) * fx
    out = np.clip(np.rint(top * (one - fy) + bot * fy), 0, 255).astype(np.uint8)
    return out if im.ndim == 3 else out[..., 0]


def _grid(dsize):
    w, h = int(dsize[0]), int(dsize[1])
    return np.arange(w, dtype=_F32)[None, :], np.arange(h, dtype=_F32)[:, None]


def warp_affine(im, M, dsize, border_value=(114, 114, 114)):
    """``cv2.warpAffine(im, M, dsize, borderValue=border_value)`` (bilinear,
    constant border) of a uint8 image by the 2x3 forward matrix M: each output
    pixel samples the source at the inverse map (inverted in float64, applied
    in float32)."""
    A = np.vstack([np.asarray(M, np.float64).reshape(2, 3), [0.0, 0.0, 1.0]])
    Mi = np.linalg.inv(A)[:2].astype(_F32)
    xs, ys = _grid(dsize)
    X = Mi[0, 0] * xs + (Mi[0, 1] * ys + Mi[0, 2])
    Y = Mi[1, 0] * xs + (Mi[1, 1] * ys + Mi[1, 2])
    return _sample(im, X, Y, border_value)


def warp_perspective(im, M, dsize, border_value=(114, 114, 114)):
    """``cv2.warpPerspective(im, M, dsize, borderValue=border_value)``
    (bilinear, constant border) of a uint8 image by the 3x3 forward matrix M."""
    Mi = np.linalg.inv(np.asarray(M, np.float64).reshape(3, 3)).astype(_F32)
    xs, ys = _grid(dsize)
    W = Mi[2, 0] * xs + (Mi[2, 1] * ys + Mi[2, 2])
    W = np.where(W != 0, _F32(1) / W, _F32(0))
    X = (Mi[0, 0] * xs + (Mi[0, 1] * ys + Mi[0, 2])) * W
    Y = (Mi[1, 0] * xs + (Mi[1, 1] * ys + Mi[1, 2])) * W
    return _sample(im, X, Y, border_value)


def rotation_matrix_2d(center, angle, scale):
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the 2x3 float64
    rotation by ``angle`` degrees (counter-clockwise) and scaling about
    ``center``."""
    a = angle * (np.pi / 180.0)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

def _rne_div_table(num, den_of):
    """cvRound(num / den_of(i)) for i in 0..255 (0 where the divisor is 0):
    OpenCV's fixed-point HSV division tables."""
    out = np.zeros(256, np.int64)
    for i in range(1, 256):
        d = den_of(i)
        q, r = divmod(num, d)
        out[i] = q + (2 * r > d or (2 * r == d and q % 2 == 1))
    return out


_SDIV = _rne_div_table(255 << 12, lambda i: i)
_HDIV = _rne_div_table(180 << 12, lambda i: 6 * i)


def bgr_to_hsv(im):
    """``cv2.cvtColor(im, COLOR_BGR2HSV)`` of a uint8 (h, w, 3) BGR image:
    OpenCV's fixed-point RGB2HSV_b (H in 0..179). Returns uint8 (h, w, 3)."""
    x = im.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


HSV_VECTOR_PIXELS = 32  # OpenCV's HSV2RGB_b vector step (4 x 8 float lanes)


def hsv_to_bgr(hsv):
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` of a uint8 (h, w, 3) HSV image
    (H in 0..179): OpenCV's float HSV2RGB with fused multiply-adds. Its
    vector loop, over the first multiple of 32 pixels of each row, truncates
    to uint8; its scalar loop, over the rest of the row, rounds. Returns
    uint8 (h, w, 3) BGR."""
    one = _F32(1)
    fma = lambda a, b, c: (a.astype(np.float64) * b + c).astype(_F32)  # one rounding
    h = hsv[..., 0].astype(_F32) * _F32(6.0 / 180.0)
    s = hsv[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = hsv[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    sector = np.floor(h)
    f = h - sector
    tab = np.stack([v, v * (one - s), v * fma(-s, f, 1.0), v * fma(-s, one - f, 1.0)])
    sel = _SECTORS[sector.astype(np.int64) % 6]  # (h, w, 3) rows of tab for B, G, R
    out = np.moveaxis(np.take_along_axis(tab, np.moveaxis(sel, -1, 0), 0), 0, -1) * _F32(255)
    n_vec = hsv.shape[1] // HSV_VECTOR_PIXELS * HSV_VECTOR_PIXELS
    out[:, :n_vec] = np.floor(out[:, :n_vec])
    out[:, n_vec:] = np.rint(out[:, n_vec:])
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# polygons
# ---------------------------------------------------------------------------

_XY_SHIFT = 16  # OpenCV's polygon edges are 16.16 fixed point


def contour_area(pts) -> float:
    """``cv2.contourArea(pts)`` of one (n, 2) contour: the shoelace sum in
    float64 over the vertices as float32, from the last vertex to the first,
    halved and made positive (the same float64 operations in the same
    order, so equal areas tie as OpenCV's do)."""
    p = np.asarray(pts, _F32).reshape(-1, 2).astype(np.float64)
    a = 0.0
    px, py = p[-1] if len(p) else (0.0, 0.0)
    for x, y in p:
        a += px * y - py * x
        px, py = x, y
    return abs(a * 0.5)


def _clip_line(w, h, p1, p2):
    """OpenCV's ``clipLine`` on the image rect: clipped integer endpoints and
    whether any part of the segment is inside."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1), (x2, y2), (c1 | c2) == 0


def _line_pixels(p1, p2):
    """The pixels of OpenCV's 8-connected ``Line`` from p1 to p2 (endpoints
    inside the image): Bresenham from the left end, error ``dx - 2 dy``."""
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1)
    m = -((major - 2 * minor * k) // (2 * major)) if major else np.zeros(1, np.int64)
    if dy > dx:
        return x1 + m, y1 + sy * k
    return x1 + k, y1 + sy * m


def fill_poly(im, pts, color):
    """``cv2.drawContours(im, [pts], -1, color, cv2.FILLED)`` (equivalently
    ``cv2.fillPoly``) in place, for one int32 polygon pts (n, 2): the
    8-connected outline, each side clipped to the image as ``cv2.line``
    clips it, and OpenCV's scanline fill. An edge runs in 16.16 fixed point
    from its upper vertex (a side that leaves the image starts from its
    clipped ends, the rows it spans unclipped where the clipped ends share a
    row), steps by the C quotient of its run over its rise, and each row
    fills the even-odd spans from ceil(left) to floor(right). Returns im."""
    h, w = im.shape[:2]
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    mask = np.zeros((h, w), bool)
    edges = []  # (first row, end row, x at the first row, x step a row)
    for i in range(len(pts)):
        p0 = (int(pts[i - 1, 0]), int(pts[i - 1, 1]))
        p1 = (int(pts[i, 0]), int(pts[i, 1]))
        (x0, y0), (x1, y1) = p0, p1
        if 0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h and 0 <= p1[1] < h:
            t0, t1, inside = p0, p1, True
        else:
            t0, t1, inside = _clip_line(w, h, p0, p1)
            x0, x1 = t0[0], t1[0]
            if t0[1] != t1[1]:
                y0, y1 = t0[1], t1[1]
        if inside:
            xs, ys = _line_pixels(t0, t1)
            mask[ys, xs] = True
        if p0[1] == p1[1]:
            continue
        run, rise = (x1 - x0) << _XY_SHIFT, y1 - y0
        step = abs(run) // abs(rise) * (1 if (run >= 0) == (rise >= 0) else -1)
        if p0[1] < p1[1]:
            edges.append((p0[1], p1[1], (x0 << _XY_SHIFT) + (p0[1] - y0) * step, step))
        else:
            edges.append((p1[1], p0[1], (x1 << _XY_SHIFT) + (p1[1] - y1) * step, step))
    if len(edges) >= 2:
        e = np.asarray(edges, np.int64)
        ends = e[:, 2] + (e[:, 1] - e[:, 0]) * e[:, 3]
        if not (e[:, 1].max() < 0 or e[:, 0].min() >= h
                or max(e[:, 2].max(), ends.max()) < 0
                or min(e[:, 2].min(), ends.min()) >= (w << _XY_SHIFT)):
            counts = e[:, 1] - e[:, 0]
            rows = np.repeat(np.arange(len(e)), counts)
            ys = e[rows, 0] + np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                                  counts)
            xs = e[rows, 2] + (ys - e[rows, 0]) * e[rows, 3]
            order = np.lexsort((xs, ys))
            ys, xs = ys[order], xs[order]
            # every row holds an even number of crossings: spans pair them in order
            one = (1 << _XY_SHIFT) - 1
            y, x1, x2 = ys[0::2], (xs[0::2] + one) >> _XY_SHIFT, xs[1::2] >> _XY_SHIFT
            ok = (y >= 0) & (y < h) & (x1 < w) & (x2 >= 0)
            y, x1, x2 = y[ok], np.maximum(x1[ok], 0), np.minimum(x2[ok], w - 1)
            ok = x1 <= x2
            spans = np.zeros((h, w + 1), np.int32)
            np.add.at(spans, (y[ok], x1[ok]), 1)
            np.add.at(spans, (y[ok], x2[ok] + 1), -1)
            mask |= np.cumsum(spans[:, :w], 1) > 0
    im[mask] = color
    return im
