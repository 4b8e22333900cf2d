"""The port's numpy image primitives (``yolov5_tpu_torch.data.cv``) against
OpenCV, which the JAX package's host path calls.

Bars: ``resize`` linear bit-exact; area bit-exact at integer factors and
within 1 level elsewhere; ``warp_affine`` within 1 level on at most 0.1% of
the pixels and bit-exact where the inverse map lands on whole pixels;
``warp_perspective`` within 1 level on at most 0.3% (0.25% measured on the
worst case here: OpenCV 5 maps coordinates in float32 in another order);
``rotation_matrix_2d`` equal; the HSV conversions bit-exact over every
input, in OpenCV's vector loop and in its scalar tail; ``fill_poly`` the
same pixels as ``cv2.drawContours(..., FILLED)``; float32 ``resize``
(linear) within 2.4e-7 of OpenCV's on values in [0, 1], its threshold at 0.5
equal; ``contour_area`` equal to ``cv2.contourArea``."""

import math

import cv2
import numpy as np
import pytest

from yolov5_tpu_torch.data import cv

cv2.setNumThreads(1)

# (h0, w0) -> (h, w): up, down, exact 2x both ways, odd sizes, one-pixel sides
RESIZE_PAIRS = [((480, 640), (640, 853)), ((200, 160), (103, 128)), ((50, 70), (640, 896)),
                ((128, 96), (64, 48)), ((72, 128), (36, 64)), ((75, 100), (96, 128)),
                ((120, 160), (96, 128)), ((1, 5), (3, 7)), ((7, 3), (2, 2)), ((5, 1), (9, 2)),
                ((97, 131), (97, 200)), ((33, 65), (66, 130)), ((64, 64), (128, 128)),
                ((101, 37), (51, 19))]


@pytest.mark.parametrize("src,dst", RESIZE_PAIRS)
def test_resize_linear_is_bitexact(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    for shape in (src + (3,), src):
        im = rng.integers(0, 256, shape, dtype=np.uint8)
        got = cv.resize(im, dst[::-1], "linear")
        np.testing.assert_array_equal(got, cv2.resize(im, dst[::-1],
                                                      interpolation=cv2.INTER_LINEAR))


AREA_PAIRS = [((128, 96), (64, 48)), ((72, 128), (36, 64)), ((90, 120), (30, 40)),
              ((101, 37), (51, 19)), ((64, 64), (16, 16)), ((7, 3), (2, 2)),
              ((200, 160), (103, 128)), ((120, 160), (96, 128)), ((75, 100), (48, 64)),
              ((641, 427), (640, 426))]


@pytest.mark.parametrize("src,dst", AREA_PAIRS)
def test_resize_area_matches_cv2(src, dst):
    rng = np.random.default_rng(sum(src) * 7 + sum(dst))
    im = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    got = cv.resize(im, dst[::-1], "area").astype(int)
    ref = cv2.resize(im, dst[::-1], interpolation=cv2.INTER_AREA).astype(int)
    whole = src[0] % dst[0] == 0 and src[1] % dst[1] == 0
    if whole or (math.ceil(src[0] / 2) == dst[0] and math.ceil(src[1] / 2) == dst[1]):
        np.testing.assert_array_equal(got, ref)  # integer factors
    else:
        assert np.abs(got - ref).max() <= 1


def test_resize_area_refuses_to_grow():
    with pytest.raises(ValueError, match="only shrinks"):
        cv.resize(np.zeros((4, 4, 3), np.uint8), (8, 8), "area")


def _matrix(src_hw, dst_hw, angle, scale, shear, persp):
    """random_perspective's composition (yolov5_tpu/data/augment.py:119-140)."""
    h, w = src_hw
    C = np.eye(3)
    C[0, 2], C[1, 2] = -w / 2, -h / 2
    P = np.eye(3)
    P[2, 0], P[2, 1] = persp, -persp
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale)
    S = np.eye(3)
    S[0, 1] = math.tan(shear * math.pi / 180)
    S[1, 0] = math.tan(-shear / 2 * math.pi / 180)
    T = np.eye(3)
    T[0, 2], T[1, 2] = 0.47 * dst_hw[1], 0.53 * dst_hw[0]
    return T @ S @ R @ P @ C


# (source, output, angle, scale, shear): the mosaic's 2s -> s crop, letterboxed
# images warped in place, rotation and shear, a small source
WARPS = [((256, 256), (128, 128), 0.0, 1.3, 0.0), ((256, 256), (128, 128), 7.0, 0.7, 3.0),
         ((96, 128), (128, 128), -20.0, 1.1, 5.0), ((60, 40), (64, 80), 45.0, 1.5, 10.0),
         ((128, 128), (128, 128), 0.0, 0.5, 0.0), ((320, 320), (160, 160), 3.0, 0.9, 1.0)]


@pytest.mark.parametrize("src,dst,angle,scale,shear", WARPS)
def test_warp_affine_matches_cv2(src, dst, angle, scale, shear):
    rng = np.random.default_rng(abs(int(angle * 10)) + src[0])
    im = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    M = _matrix(src, dst, angle, scale, shear, 0.0)[:2]
    got = cv.warp_affine(im, M, dst[::-1], border_value=(114, 114, 114)).astype(int)
    ref = cv2.warpAffine(im, M, dsize=dst[::-1], borderValue=(114, 114, 114)).astype(int)
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, ((d > 0).mean(), d.max())


@pytest.mark.parametrize("M", [np.array([[0.5, 0.0, 10.0], [0.0, 0.5, -7.0]]),
                               np.array([[1.0, 0.0, -64.0], [0.0, 1.0, -32.0]]),
                               np.array([[2.0, 0.0, 3.0], [0.0, 2.0, 5.0]])])
def test_warp_affine_bitexact_on_whole_pixels(M):
    """Scales of 1/2, 1 and 2 with whole-pixel shifts: the inverse map lands on
    pixels or their midpoints, so the float32 order of operations is moot."""
    im = np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    got = cv.warp_affine(im, M, (100, 90))
    np.testing.assert_array_equal(got, cv2.warpAffine(im, M, dsize=(100, 90),
                                                      borderValue=(114, 114, 114)))


@pytest.mark.parametrize("src,dst,persp", [((128, 128), (128, 128), 0.0007),
                                           ((256, 256), (128, 128), 0.0003),
                                           ((96, 128), (100, 90), 0.001)])
def test_warp_perspective_matches_cv2(src, dst, persp):
    im = np.random.default_rng(1).integers(0, 256, src + (3,), dtype=np.uint8)
    M = _matrix(src, dst, 5.0, 0.9, 2.0, persp)
    got = cv.warp_perspective(im, M, dst[::-1]).astype(int)
    ref = cv2.warpPerspective(im, M, dsize=dst[::-1], borderValue=(114, 114, 114)).astype(int)
    d = np.abs(got - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 3e-3, ((d > 0).mean(), d.max())


@pytest.mark.parametrize("center,angle,scale", [((0, 0), 17.3, 1.2), ((3.5, 2.0), -45.0, 0.5),
                                                ((320, 240), 0.0, 1.0), ((0, 0), 180.0, 0.9)])
def test_rotation_matrix_2d_equals_cv2(center, angle, scale):
    np.testing.assert_array_equal(cv.rotation_matrix_2d(center, angle, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))


def test_bgr_to_hsv_bitexact_on_every_colour():
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    bgr = np.stack([b, g, r], -1).reshape(-1, 3).astype(np.uint8)
    for width in (4096, 4099):  # rows of whole vectors, and rows with a tail
        im = bgr[:len(bgr) // width * width].reshape(-1, width, 3)
        np.testing.assert_array_equal(cv.bgr_to_hsv(im), cv2.cvtColor(im, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [256, 33, 1])
def test_hsv_to_bgr_bitexact_on_every_input(width):
    """Rows of 256 run in OpenCV's vector loop, rows of 1 in its scalar loop,
    rows of 33 in both."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 3).astype(np.uint8)
    if width == 1:
        hsv = hsv[::7]  # every seventh input: 1.7 M one-pixel rows take OpenCV long
    hsv = hsv[:len(hsv) // width * width].reshape(-1, width, 3)
    np.testing.assert_array_equal(cv.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def _polygons(kind, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(5, 80, 2))
        k = int(rng.integers(3, 12))
        if kind == "random":  # concave and self-intersecting
            pts = np.stack([rng.integers(0, w + 1, k), rng.integers(0, h + 1, k)], 1)
        elif kind in ("convex", "star"):
            a = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(1, min(h, w) / 1.5, 1 if kind == "convex" else k)
            c = rng.uniform(0, [w, h])
            pts = np.clip(np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)], 1), 0, [w, h])
        else:  # on and beyond every border, as clipped and flipped segments are
            pts = np.stack([rng.choice([0, w, int(rng.integers(0, w))], k),
                            rng.choice([0, h, int(rng.integers(0, h))], k)], 1)
            if kind == "outside":
                pts = pts + rng.integers(-3, 4, pts.shape)
        yield h, w, pts.astype(np.int32)


@pytest.mark.parametrize("kind", ["convex", "star", "random", "edges", "outside"])
def test_fill_poly_equals_cv2_draw_contours(kind):
    for h, w, pts in _polygons(kind, 300, seed=len(kind)):
        ref = np.zeros((h, w, 3), np.uint8)
        cv2.drawContours(ref, [pts], -1, (1, 1, 1), cv2.FILLED)
        got = cv.fill_poly(np.zeros((h, w, 3), np.uint8), pts, (1, 1, 1))
        np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w} {pts.tolist()}")


@pytest.mark.parametrize("src,dst", RESIZE_PAIRS + [((16, 16), (64, 64)), ((160, 160), (640, 640)),
                                                    ((640, 640), (480, 640))])
@pytest.mark.parametrize("kind", ["noise", "binary", "cropped"])
def test_resize_float32_linear_matches_cv2(src, dst, kind):
    """The float path of segm JSON rows: sigmoid-like masks, 0/1 masks and
    masks zero outside a box (the rows and columns with no nonzero tap are
    skipped, and must still come out 0)."""
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    im = rng.random(src).astype(np.float32)
    if kind == "binary":
        im = (im > 0.5).astype(np.float32)
    elif kind == "cropped":
        im[: src[0] // 3] = 0
        im[:, src[1] // 2:] = 0
    ref = cv2.resize(im, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = cv.resize(im, dst[::-1], "linear")
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.4e-7)
    near = np.abs(ref - 0.5) <= 2.4e-7
    np.testing.assert_array_equal((got > 0.5)[~near], (ref > 0.5)[~near])


def test_resize_float32_takes_linear_only():
    with pytest.raises(ValueError, match="linear"):
        cv.resize(np.zeros((8, 8), np.float32), (4, 4), "area")


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_contour_area_equals_cv2(dtype):
    """Shoelace in float64 over float32 vertices in OpenCV's order: equal
    values, so equal areas tie as they do in OpenCV (rasterize_masks sorts
    by them)."""
    rng = np.random.default_rng(13)
    for _ in range(500):
        n = int(rng.integers(1, 40))
        pts = rng.uniform(-50, 700, (n, 2))
        pts = (np.round(pts) if rng.random() < 0.3 else pts).astype(dtype)
        assert cv.contour_area(pts) == cv2.contourArea(pts)
