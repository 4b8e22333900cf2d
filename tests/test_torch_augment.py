"""The port's host augmentation (``yolov5_tpu_torch.data.augment``) against the
JAX package's (``yolov5_tpu.data.augment``, which calls OpenCV), each pair
drawing from ``np.random.default_rng`` generators of the same seed.

Bars: labels and segments within 1e-4 px and the same rows kept; images at
``data.cv``'s bar (bit-exact for HSV, flips, mixup and copy-paste; warps
within 1 level on at most 0.1% of the pixels, 0.3% with perspective)."""

import numpy as np
import pytest

from yolov5_tpu.data import augment as jax_aug
from yolov5_tpu_torch.data import augment as aug


def _image(seed, h=96, w=128):
    rng = np.random.default_rng(seed)
    im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    im[: h // 4] = 114  # a flat band, as letterbox borders are
    return im


def _boxes(seed, n, w, h):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [w * 0.8, h * 0.8], (n, 2))
    wh = rng.uniform(3, [w * 0.4, h * 0.4], (n, 2))
    cls = rng.integers(0, 3, (n, 1))
    return np.concatenate([cls, xy, np.minimum(xy + wh, [w, h])], 1).astype(np.float32)


def _segments(boxes):
    """A hexagon inside each box (px)."""
    out = []
    for _, x1, y1, x2, y2 in boxes:
        a = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        out.append(np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)], 1).astype(np.float32))
    return out


@pytest.mark.parametrize("shape", [(96, 128), (50, 70), (64, 64)])
@pytest.mark.parametrize("gains", [(0.015, 0.7, 0.4), (0.1, 0.9, 0.9), (0.0, 0.0, 0.0)])
def test_augment_hsv_bitexact(shape, gains):
    for seed in range(3):
        a, b = _image(seed, *shape), _image(seed, *shape)
        aug.augment_hsv(a, *gains, rng=np.random.default_rng(seed))
        jax_aug.augment_hsv(b, *gains, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)


def test_box_candidates_equal():
    rng = np.random.default_rng(0)
    b1, b2 = rng.uniform(0, 50, (2, 4, 40))
    b1[2:] += b1[:2]
    b2[2:] += b2[:2] * rng.uniform(0, 1.5, (2, 40))
    for kw in ({}, {"area_thr": 0.01}, {"wh_thr": 5, "ar_thr": 3}):
        np.testing.assert_array_equal(aug.box_candidates(b1, b2, **kw),
                                      jax_aug.box_candidates(b1, b2, **kw))


GEOMETRY = [dict(degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0),
            dict(degrees=10.0, translate=0.2, scale=0.9, shear=5.0, perspective=0.0),
            dict(degrees=5.0, translate=0.1, scale=0.5, shear=2.0, perspective=0.0007)]


@pytest.mark.parametrize("geo", GEOMETRY, ids=["scale", "rotate_shear", "perspective"])
@pytest.mark.parametrize("with_segments", [False, True])
@pytest.mark.parametrize("border", [(0, 0), (-32, -32)])
def test_random_perspective_matches_jax(geo, with_segments, border):
    h, w = 128, 128
    tol = 3e-3 if geo["perspective"] else 1e-3
    for seed in range(3):
        im = _image(seed, h, w)
        boxes = _boxes(seed, 6, w, h)
        segs = _segments(boxes) if with_segments else []
        got = aug.random_perspective(im.copy(), boxes.copy(), [s.copy() for s in segs],
                                     border=border, rng=np.random.default_rng(seed), **geo)
        ref = jax_aug.random_perspective(im.copy(), boxes.copy(), [s.copy() for s in segs],
                                         border=border, rng=np.random.default_rng(seed), **geo)
        d = np.abs(got[0].astype(int) - ref[0])
        assert got[0].shape == ref[0].shape and d.max() <= 1 and (d > 0).mean() <= tol
        assert got[1].shape == ref[1].shape
        np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
        assert len(got[2]) == len(ref[2])
        for a, b in zip(got[2], ref[2]):
            np.testing.assert_allclose(a, b, atol=1e-4)


def test_mixup_equal():
    a, b = _image(0), _image(1)
    la, lb = _boxes(0, 3, 128, 96), _boxes(1, 2, 128, 96)
    got = aug.mixup(a, la, b, lb, rng=np.random.default_rng(4))
    ref = jax_aug.mixup(a, la, b, lb, rng=np.random.default_rng(4))
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_copy_paste_equal(p):
    """Instances touching the canvas's right edge (x = w) included: the
    flipped polygons then start at x = 0."""
    for seed in range(4):
        im = _image(seed, 128, 160)
        boxes = _boxes(seed + 10, 5, 160, 128)
        boxes[0, 3] = 160.0  # an instance on the right edge
        segs = _segments(boxes)
        segs[0][:, 0] = np.clip(segs[0][:, 0] + 20, 0, 160)
        got = aug.copy_paste(im.copy(), boxes.copy(), [s.copy() for s in segs], p=p,
                             rng=np.random.default_rng(seed))
        ref = jax_aug.copy_paste(im.copy(), boxes.copy(), [s.copy() for s in segs], p=p,
                                 rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
        assert len(got[2]) == len(ref[2])
        for a, b in zip(got[2], ref[2]):
            np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("flip", ["flip_lr", "flip_ud"])
def test_flips_equal(flip):
    im = _image(2)
    boxes = _boxes(2, 4, 128, 96)
    segs = _segments(boxes)
    got_segs, ref_segs = [s.copy() for s in segs], [s.copy() for s in segs]
    got = getattr(aug, flip)(im, boxes.copy(), got_segs)
    ref = getattr(jax_aug, flip)(im, boxes.copy(), ref_segs)
    for x, y in zip(got + tuple(got_segs), ref + tuple(ref_segs)):
        np.testing.assert_array_equal(x, y)


def test_albumentations_hook_is_a_no_op_without_the_package():
    a, b = aug.Albumentations(128), jax_aug.Albumentations(128)
    assert (a.transform is None) == (b.transform is None)
    im, labels = _image(0), np.array([[0, 0.5, 0.5, 0.2, 0.2]], np.float32)
    if a.transform is None:
        out = a(im, labels, rng=np.random.default_rng(0))
        assert out[0] is im and out[1] is labels
