"""The port's on-device augmentation against the JAX package's
(yolov5_tpu.data.device_aug) and against OpenCV, on equal draws.

Tolerances: HSV bit-exact against JAX and cv2's RGB2HSV; the jitter against
the host cv2 LUT path within 1 level on < 5e-4 of the pixels (cv2's FMA in
HSV2RGB, as tests/test_device_aug.py allows the JAX package); matrices
within 1e-6; affine_sample within 1e-4; warped images within 1 level, boxes
within 1e-5 and keep masks exact; the mosaic against a float64 numpy
compose-then-warp within 1 level and against JAX ``mosaic_fused`` (bf16
resampling matmuls) within 3 levels."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5_tpu.data import device_aug as jax_aug
from yolov5_tpu_torch.data import device_aug as aug
from yolov5_tpu_torch.data.letterbox import letterbox
from yolov5_tpu_torch.utils.hyp import SCRATCH_LOW


def test_rgb_to_hsv_u8_bitexact(rng):
    im = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    got = np.stack([t.numpy() for t in aug.rgb_to_hsv_u8(torch.from_numpy(im))], -1)
    ref = np.stack([np.asarray(t) for t in jax_aug.rgb_to_hsv_u8(jnp.asarray(im))], -1)
    np.testing.assert_array_equal(got, ref)
    for b in range(2):
        np.testing.assert_array_equal(got[b], cv2.cvtColor(im[b], cv2.COLOR_RGB2HSV))


def test_hsv_jitter_lut_matches_jax_and_cv2(rng):
    from yolov5_tpu.data.augment import augment_hsv as host_hsv

    ims = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    ims[:, :8] = 114  # letterbox border gray
    r = (rng.uniform(-1, 1, (4, 3)) * [0.015, 0.7, 0.4] + 1).astype(np.float32)
    got = aug.hsv_jitter_lut(torch.from_numpy(ims), torch.from_numpy(r)).numpy()
    ref = np.asarray(jax_aug.hsv_jitter_lut(jnp.asarray(ims), jnp.asarray(r)))
    np.testing.assert_array_equal(got, ref)
    bad = 0
    for b in range(4):
        class _Gains:  # the host path draws its gains from rng.uniform
            def uniform(self, lo, hi, n, _r=r[b]):
                return (np.asarray(_r, np.float64) - 1) / [0.015, 0.7, 0.4]

        host = host_hsv(ims[b, ..., ::-1].copy(), rng=_Gains())[..., ::-1]
        d = np.abs(host.astype(int) - got[b].astype(int))
        assert d.max() <= 1
        bad += int((d > 0).sum())
    assert bad / got.size < 5e-4


def _jax_draws(key, bs, degrees, translate, scale, shear, perspective):
    """The values jax_aug._affine_matrices draws from ``key``, in the port's
    layout."""
    ks = jax.random.split(key, 6)
    u = lambda k, lo, hi, shape=(bs,): np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi))  # a writable copy
    draws = {"perspective": np.stack([u(ks[0], -perspective, perspective),
                                      u(ks[1], -perspective, perspective)], -1),
             "angle": u(ks[2], -degrees, degrees), "scale": u(ks[3], 1 - scale, 1 + scale),
             "shear": u(ks[4], -shear, shear, (bs, 2)),
             "translate": u(ks[5], 0.5 - translate, 0.5 + translate, (bs, 2))}
    return {k: torch.from_numpy(v) for k, v in draws.items()}


GEOMETRY = dict(degrees=10.0, translate=0.1, scale=0.5, shear=3.0, perspective=0.0005)


def test_affine_from_draws_matches_jax():
    key = jax.random.PRNGKey(3)
    M_ref, s_ref = jax_aug._affine_matrices(key, 4, 48, 64, **GEOMETRY,
                                            out_height=32, out_width=40)
    M, s = aug.affine_from_draws(_jax_draws(key, 4, **GEOMETRY), 48, 64, 32, 40)
    np.testing.assert_allclose(M.numpy(), np.asarray(M_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-7)


def test_affine_sample_matches_jax(rng):
    im = rng.uniform(0, 255, (2, 24, 32, 3)).astype(np.float32)
    M, _ = jax_aug._affine_matrices(jax.random.PRNGKey(1), 2, 24, 32, **GEOMETRY)
    M_inv = np.array(jnp.linalg.inv(M))  # a writable copy
    ref = np.asarray(jax.vmap(lambda i, m: jax_aug.affine_sample(i, m, 20, 28))(
        jnp.asarray(im), jnp.asarray(M_inv)))
    got = aug.affine_sample(torch.from_numpy(im), torch.from_numpy(M_inv), 20, 28).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    ident = aug.affine_sample(torch.from_numpy(im), torch.eye(3).repeat(2, 1, 1), 24, 32)
    np.testing.assert_allclose(ident.numpy(), im, atol=1e-4)


def _labelled_batch(rng, bs, h, w, m=6):
    ims = rng.integers(0, 256, (bs, h, w, 3), dtype=np.uint8)
    t = np.zeros((bs, m, 5), np.float32)
    t[..., 0] = rng.integers(0, 3, (bs, m))
    t[..., 1:3] = rng.uniform(0.1, 0.9, (bs, m, 2))
    t[..., 3:5] = rng.uniform(0.02, 0.5, (bs, m, 2))
    v = rng.uniform(size=(bs, m)) < 0.8
    return ims, t, v


@pytest.mark.parametrize("out_hw", [None, (48, 40)])
def test_random_perspective_matches_jax_on_equal_draws(rng, out_hw):
    ims, t, v = _labelled_batch(rng, 3, 64, 56)
    key = jax.random.PRNGKey(7)
    oh, ow = out_hw or (64, 56)
    ref_im, ref_t, ref_v = jax_aug.random_perspective(
        jnp.asarray(ims), jnp.asarray(t), jnp.asarray(v), key, **GEOMETRY, out_hw=out_hw)
    M, s = jax_aug._affine_matrices(key, 3, 64, 56, **GEOMETRY, out_height=oh, out_width=ow)
    got_im, got_t, got_v = aug.warp_perspective(
        torch.from_numpy(ims), torch.from_numpy(t), torch.from_numpy(v),
        torch.from_numpy(np.array(M)), torch.from_numpy(np.array(s)), out_hw)
    d = np.abs(got_im.numpy().astype(int) - np.asarray(ref_im).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-5)


def test_flips_match_jax(rng):
    ims, t, _ = _labelled_batch(rng, 2, 8, 12)
    for p, port, ref in ((1.0, aug.random_flip_lr, jax_aug.random_flip_lr),
                         (1.0, aug.random_flip_ud, jax_aug.random_flip_ud),
                         (0.0, aug.random_flip_lr, jax_aug.random_flip_lr)):
        gi, gt = port(torch.from_numpy(ims), torch.from_numpy(t), torch.Generator(), p)
        ri, rt = ref(jnp.asarray(ims), jnp.asarray(t), jax.random.PRNGKey(0), p)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))


def _mosaic_case(rng, s=64):
    images = np.full((3, s, s, 3), 114, np.uint8)
    hw = np.array([[48, 64], [64, 32], [40, 52]], np.int32)
    targets = np.zeros((3, 4, 5), np.float32)
    valid = np.zeros((3, 4), bool)
    for b in range(3):
        h, w = hw[b]
        images[b, :h, :w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        targets[b, :2] = [[b, 0.5, 0.5, 0.5, 0.5], [1, 0.2, 0.8, 0.3, 0.2]]
        valid[b, :2] = True
    idx = np.array([[0, 1, 2, 1], [1, 2, 0, 0]], np.int64)
    xc = np.array([70.0, 90.0], np.float32)  # whole px, as the port draws them
    yc = np.array([90.0, 57.0], np.float32)
    r = np.array([0.8, 1.3], np.float32)
    t = np.array([[0.50 * s, 0.55 * s], [0.45 * s, 0.6 * s]], np.float32)
    return images, hw, targets, valid, idx, xc, yc, r, t


def _numpy_compose_warp(images, hw, idx, xc, yc, r, t):
    """Float64 oracle: paste the four tiles on a 114 canvas, then sample it
    bilinearly at M^-1 (x, y), 114 outside."""
    s = images.shape[1]
    out = np.zeros((len(idx), s, s, 3))
    for b in range(len(idx)):
        canvas = np.full((2 * s, 2 * s, 3), 114.0)
        for k in range(4):
            h, w = hw[idx[b, k]]
            ox = xc[b] - w if k in (0, 2) else xc[b]
            oy = yc[b] - h if k in (0, 1) else yc[b]
            x1a, y1a = int(max(ox, 0)), int(max(oy, 0))
            x2a, y2a = int(min(ox + w, 2 * s)), int(min(oy + h, 2 * s))
            x1b, y1b = int(x1a - ox), int(y1a - oy)
            canvas[y1a:y2a, x1a:x2a] = images[idx[b, k]][y1b:y1b + y2a - y1a,
                                                         x1b:x1b + x2a - x1a]
        ys, xs = np.mgrid[0:s, 0:s].astype(np.float64)
        sx = (xs - (t[b, 0] - r[b] * s)) / r[b]
        sy = (ys - (t[b, 1] - r[b] * s)) / r[b]
        x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]

        def tap(yi, xi):
            inside = (xi >= 0) & (xi < 2 * s) & (yi >= 0) & (yi < 2 * s)
            v = canvas[yi.clip(0, 2 * s - 1), xi.clip(0, 2 * s - 1)]
            return np.where(inside[..., None], v, 114.0)

        out[b] = ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
                  + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy)
    return np.floor(out + 0.5).clip(0, 255).astype(np.uint8)


def test_mosaic_matches_compose_then_warp_and_jax_mosaic_fused(rng):
    images, hw, targets, valid, idx, xc, yc, r, t = _mosaic_case(rng)
    s = images.shape[1]
    M = np.zeros((2, 3, 3), np.float32)
    M[:, 0, 0] = M[:, 1, 1] = r
    M[:, 0, 2], M[:, 1, 2], M[:, 2, 2] = t[:, 0] - r * s, t[:, 1] - r * s, 1.0
    hw4 = hw[idx].astype(np.float32)
    got_im, got_t, got_v = aug.mosaic_warp(
        torch.from_numpy(images), torch.from_numpy(targets[idx]), torch.from_numpy(valid[idx]),
        torch.from_numpy(idx), torch.from_numpy(hw4), torch.from_numpy(xc),
        torch.from_numpy(yc), torch.from_numpy(M), torch.from_numpy(r))
    got_im = got_im.numpy().astype(int)

    oracle = _numpy_compose_warp(images, hw, idx, xc, yc, r, t).astype(int)
    assert np.abs(got_im - oracle).max() <= 1

    ref_im, ref_t, ref_v = jax_aug.mosaic_fused(
        jnp.asarray(images), jnp.asarray(hw4), jnp.asarray(targets[idx]),
        jnp.asarray(valid[idx]), jnp.asarray(idx.astype(np.int32)), jnp.asarray(xc),
        jnp.asarray(yc), jnp.asarray(r), jnp.asarray(t))
    d = np.abs(got_im - np.asarray(ref_im).astype(int))
    assert d.max() <= 3 and d.mean() < 0.5, (d.max(), d.mean())
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_mosaic_out_size_matches_jax_mosaic_fused(rng, scale):
    """The multi-scale size folded into the warp (``out_size``): the image
    against JAX ``mosaic_fused(out_size=...)`` within 3 levels, the labels
    those of the base size."""
    images, hw, targets, valid, idx, xc, yc, r, t = _mosaic_case(rng)
    s = images.shape[1]
    out = int(s * scale)
    M = np.zeros((2, 3, 3), np.float32)
    M[:, 0, 0] = M[:, 1, 1] = r
    M[:, 0, 2], M[:, 1, 2], M[:, 2, 2] = t[:, 0] - r * s, t[:, 1] - r * s, 1.0
    hw4 = hw[idx].astype(np.float32)
    args = (torch.from_numpy(images), torch.from_numpy(targets[idx]),
            torch.from_numpy(valid[idx]), torch.from_numpy(idx), torch.from_numpy(hw4),
            torch.from_numpy(xc), torch.from_numpy(yc), torch.from_numpy(M), torch.from_numpy(r))
    got_im, got_t, got_v = aug.mosaic_warp(*args, out_size=out)
    _, base_t, base_v = aug.mosaic_warp(*args)
    assert got_im.shape == (2, out, out, 3)
    assert torch.equal(got_t, base_t) and torch.equal(got_v, base_v)
    ref_im, ref_t, _ = jax_aug.mosaic_fused(
        jnp.asarray(images), jnp.asarray(hw4), jnp.asarray(targets[idx]),
        jnp.asarray(valid[idx]), jnp.asarray(idx.astype(np.int32)), jnp.asarray(xc),
        jnp.asarray(yc), jnp.asarray(r), jnp.asarray(t), out_size=out)
    d = np.abs(got_im.numpy().astype(int) - np.asarray(ref_im).astype(int))
    assert d.max() <= 3 and d.mean() < 0.5, (d.max(), d.mean())
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), atol=1e-5)


def test_mosaic_probability_zero_is_letterbox(rng):
    """No mosaic, no scale, no translate: each image comes out letterboxed
    (centered, 114 border) with its own labels."""
    s = 64
    images = np.full((4, s, s, 3), 114, np.uint8)
    hw = np.array([[48, 64], [64, 40], [32, 64], [64, 64]], np.int32)
    targets = np.zeros((4, 2, 5), np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.5, 0.5]
    valid = np.zeros((4, 2), bool)
    valid[:, 0] = True
    for b, (h, w) in enumerate(hw):
        images[b, :h, :w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    hyp = {"mosaic": 0.0, "scale": 0.0, "translate": 0.0}
    out, t, v = aug.mosaic_in_batch(torch.from_numpy(images), torch.from_numpy(hw),
                                    torch.from_numpy(targets), torch.from_numpy(valid),
                                    torch.Generator().manual_seed(0), hyp)
    for b, (h, w) in enumerate(hw):
        ref = letterbox(images[b, :h, :w], s, auto=False)[0]
        np.testing.assert_array_equal(out[b].numpy(), ref)
        tb = t[b][v[b]].numpy()
        assert len(tb) == 1
        np.testing.assert_allclose(tb[0, 1:3], [0.5, 0.5], atol=1e-6)


def test_device_augment_is_seeded_by_step(rng):
    """Full pipeline on a pool: same (seed, step) -> same batch; another
    step -> another batch; shapes, dtypes and label ranges hold."""
    s, n = 64, 6
    images = np.full((n, s, s, 3), 114, np.uint8)
    hw = np.tile(np.array([[48, 64]], np.int32), (n, 1))
    images[:, :48] = rng.integers(0, 255, (n, 48, s, 3), dtype=np.uint8)
    targets = np.zeros((n, 3, 5), np.float32)
    targets[:, :2] = [[0, 0.3, 0.4, 0.2, 0.3], [2, 0.7, 0.6, 0.3, 0.2]]
    valid = np.zeros((n, 3), bool)
    valid[:, :2] = True
    pool = {"images": torch.from_numpy(images), "hw": torch.from_numpy(hw),
            "targets": torch.from_numpy(targets), "valid": torch.from_numpy(valid)}
    hyp = {**SCRATCH_LOW, "degrees": 5.0}

    def run(step):
        gen = aug.aug_generator(3, step, "cpu")
        idx = torch.tensor([0, 2, 4])
        im, t, v = aug.mosaic_in_batch(pool["images"][idx], pool["hw"][idx],
                                       pool["targets"][idx], pool["valid"][idx], gen, hyp,
                                       pool=pool, self_idx=idx)
        return aug.device_augment({"images": im, "targets": t, "valid": v}, gen, hyp)

    a, b, c = run(5), run(5), run(6)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["images"], c["images"])
    assert a["images"].shape == (3, s, s, 3) and a["images"].dtype == torch.uint8
    assert a["targets"].shape == (3, 12, 5) and a["valid"].any()
    tv = a["targets"][a["valid"]]
    assert ((tv[:, 1:] >= 0) & (tv[:, 1:] <= 1)).all()


def test_mosaic_device_is_the_mosaic_of_its_tiles(rng):
    """Explicit 4-tile batches: the same canvas and warp as mosaic_warp on
    the tiles, for the same draws."""
    images, hw, targets, valid, idx, *_ = _mosaic_case(rng)
    tiles = torch.from_numpy(images[idx])  # (2, 4, s, s, 3)
    hw4 = torch.from_numpy(hw[idx])
    t4, v4 = torch.from_numpy(targets[idx]), torch.from_numpy(valid[idx])
    got = aug.mosaic_device(tiles, hw4, t4, v4, torch.Generator().manual_seed(3), SCRATCH_LOW)
    gen = torch.Generator().manual_seed(3)
    s = images.shape[1]
    c = torch.floor(torch.rand((2, 2), generator=gen) * s + 0.5 * s)
    draws = aug.draw_affine(gen, 2, 0.0, 0.1, 0.5, 0.0, 0.0, "cpu")
    M, scale = aug.affine_from_draws(draws, 2 * s, 2 * s, s, s)
    ref = aug.mosaic_warp(tiles.reshape(8, s, s, 3), t4, v4, torch.arange(8).reshape(2, 4),
                          hw4.float(), c[:, 0], c[:, 1], M, scale)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[0].shape == (2, s, s, 3) and got[1].shape == (2, 16, 5)
