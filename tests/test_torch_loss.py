"""The port's target assignment and detection loss against the JAX package:
yolov5_tpu_torch.train.{assigner,loss} vs yolov5_tpu.train.{assigner,loss}
on the same numpy-seeded maps and targets.

Tolerances: the assignment is exact (mask, gi, gj, a, tcls) and tbox within
1e-6; loss components and the gradients with respect to the raw maps within
1e-5 relative (f32 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5_tpu.train import assigner as jax_assigner
from yolov5_tpu.train import loss as jax_loss
from yolov5_tpu.train.trainer import scale_hyp as jax_scale_hyp
from yolov5_tpu.utils.hyp import SCRATCH_LOW
from yolov5_tpu_torch.train import assigner, loss
from yolov5_tpu_torch.train.trainer import scale_hyp

# yolov5n's anchors at strides 8, 16, 32, in stride units
ANCHORS = (((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119)),
           ((116, 90), (156, 198), (373, 326)))
STRIDES = (8, 16, 32)
APS = tuple(tuple((w / s, h / s) for w, h in lvl) for lvl, s in zip(ANCHORS, STRIDES))


def random_targets(rng, bs, m, nc, n_valid=None):
    """Padded targets: random boxes (some tiny or huge, so the anchor gate
    bites; some on the border cells), a random number of valid rows."""
    t = np.zeros((bs, m, 5), np.float32)
    v = np.zeros((bs, m), bool)
    for b in range(bs):
        n = int(rng.integers(1, m + 1)) if n_valid is None else n_valid
        t[b, :n, 0] = rng.integers(0, nc, n)
        t[b, :n, 1:3] = rng.uniform(0.0, 1.0, (n, 2))
        t[b, :n, 3:5] = np.exp(rng.uniform(np.log(0.005), np.log(0.9), (n, 2)))
        v[b, :n] = True
    # border cells: the first row of image 0 hugs the left/top edge, the
    # second the right/bottom edge
    t[0, 0, 1:5] = [0.01, 0.02, 0.05, 0.08]
    t[0, 1, 1:5] = [0.995, 0.99, 0.1, 0.05]
    v[0, :2] = True
    return t, v


def random_maps(rng, bs, imgsz, nc, scale=2.0):
    return [(rng.normal(0, scale, (bs, imgsz // s, imgsz // s, 3, 5 + nc))).astype(np.float32)
            for s in STRIDES]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_assigner_matches_jax(rng, level):
    t, v = random_targets(rng, 3, 12, 4)
    ny = nx = 128 // STRIDES[level]
    anchors = np.asarray(APS[level], np.float32)
    ref = jax_assigner.build_targets_level(jnp.asarray(t), jnp.asarray(v),
                                           jnp.asarray(anchors), ny, nx, 4.0)
    got = assigner.build_targets_level(torch.from_numpy(t), torch.from_numpy(v),
                                       torch.from_numpy(anchors), ny, nx, 4.0)
    assert np.asarray(ref["mask"]).any() and not np.asarray(ref["mask"]).all()
    for k in ("mask", "gi", "gj", "a", "tcls"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    m = np.asarray(ref["mask"])
    np.testing.assert_allclose(got["tbox"].numpy()[m], np.asarray(ref["tbox"])[m], atol=1e-6)


def test_assigner_border_cells_and_anchor_gate():
    """A target on the border cell gets no out-of-grid neighbour; one whose
    wh ratio to every anchor is >= anchor_t matches nothing."""
    t = np.array([[[0, 0.01, 0.01, 0.02, 0.02], [1, 0.99, 0.99, 0.05, 0.05],
                   [2, 0.5, 0.5, 0.9, 0.004]]], np.float32)
    v = np.ones((1, 3), bool)
    anchors = np.asarray(APS[0], np.float32)
    ref = jax_assigner.build_targets_level(jnp.asarray(t), jnp.asarray(v),
                                           jnp.asarray(anchors), 16, 16, 4.0)
    got = assigner.build_targets_level(torch.from_numpy(t), torch.from_numpy(v),
                                       torch.from_numpy(anchors), 16, 16, 4.0)
    for k in ("mask", "gi", "gj", "a", "tcls"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    mask = got["mask"].numpy()
    assert not mask[0, 2].any()  # the anchor gate
    assert mask[0, 0, :, 1:3].sum() == 0 and mask[0, 1, :, 3:5].sum() == 0  # borders


def test_loss_helpers_match_jax(rng):
    x = rng.normal(0, 3, (64,)).astype(np.float32)
    z = rng.uniform(0, 1, (64,)).astype(np.float32)
    m = (rng.uniform(size=64) > 0.5).astype(np.float32)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    jx, jz = jnp.asarray(x), jnp.asarray(z)
    for port, ref, kw in ((loss.bce_with_logits, jax_loss.bce_with_logits, {"pos_weight": 1.5}),
                          (loss.focal_scale, jax_loss.focal_scale, {}),
                          (loss.qfocal_scale, jax_loss.qfocal_scale, {}),
                          (loss.bce_blur_with_logits, jax_loss.bce_blur_with_logits, {})):
        np.testing.assert_allclose(port(tx, tz, **kw).numpy(), np.asarray(ref(jx, jz, **kw)),
                                   rtol=1e-5, atol=1e-7, err_msg=port.__name__)
    np.testing.assert_allclose(loss.masked_mean(tz, torch.from_numpy(m)).item(),
                               float(jax_loss.masked_mean(jz, jnp.asarray(m))), rtol=1e-6)
    assert loss.BALANCE == jax_loss.BALANCE


CASES = {
    "plain": ({}, 4),
    "focal": ({"fl_gamma": 1.5}, 4),
    "qfocal": ({"fl_gamma": 1.5, "fl_type": "qfocal"}, 4),
    "label_smoothing": ({"label_smoothing": 0.1, "cls_pw": 1.3, "obj_pw": 0.8}, 4),
    "nc1": ({}, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_loss_and_grads_match_jax(rng, case):
    """Total, components and d(total)/d(maps) against the JAX ComputeLoss."""
    extra, nc = CASES[case]
    bs, imgsz = 2, 128
    hyp = scale_hyp({**SCRATCH_LOW, **extra}, nl=3, nc=nc, imgsz=imgsz)
    assert hyp == jax_scale_hyp({**SCRATCH_LOW, **extra}, nl=3, nc=nc, imgsz=imgsz)
    t, v = random_targets(rng, bs, 10, nc)
    maps = random_maps(rng, bs, imgsz, nc)

    ref_fn = jax_loss.ComputeLoss(APS, nc, hyp)

    def ref_total(ms):
        total, comps = ref_fn(ms, jnp.asarray(t), jnp.asarray(v))
        return total, comps

    (ref_t, ref_c), ref_g = jax.value_and_grad(ref_total, has_aux=True)(
        [jnp.asarray(m) for m in maps])

    tmaps = [torch.from_numpy(m).requires_grad_() for m in maps]
    got_t, got_c = loss.ComputeLoss(APS, nc, hyp)(tmaps, torch.from_numpy(t),
                                                   torch.from_numpy(v))
    got_t.backward()

    np.testing.assert_allclose(got_t.item(), float(ref_t), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(got_c[k].item(), float(ref_c[k]), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
    if nc == 1:
        assert got_c["cls"].item() == 0.0
    for tm, g in zip(tmaps, ref_g):
        g = np.asarray(g)
        np.testing.assert_allclose(tm.grad.numpy(), g, rtol=1e-5, atol=1e-5 * np.abs(g).max())


def test_loss_without_targets_matches_jax(rng):
    """No valid target: only the obj term, against all-zero tobj."""
    nc = 3
    hyp = scale_hyp(SCRATCH_LOW, nl=3, nc=nc, imgsz=64)
    t = np.zeros((2, 4, 5), np.float32)
    v = np.zeros((2, 4), bool)
    maps = random_maps(rng, 2, 64, nc)
    ref_t, ref_c = jax_loss.ComputeLoss(APS, nc, hyp)([jnp.asarray(m) for m in maps],
                                                      jnp.asarray(t), jnp.asarray(v))
    got_t, got_c = loss.ComputeLoss(APS, nc, hyp)([torch.from_numpy(m) for m in maps],
                                                  torch.from_numpy(t), torch.from_numpy(v))
    assert got_c["box"].item() == 0.0 and got_c["cls"].item() == 0.0
    np.testing.assert_allclose(got_t.item(), float(ref_t), rtol=1e-5)
    np.testing.assert_allclose(got_c["obj"].item(), float(ref_c["obj"]), rtol=1e-5)


def test_obj_target_is_max_combined():
    """Two targets that claim one cell and anchor: tobj keeps the larger IoU
    (the JAX package's scatter-max), whichever comes last."""
    nc = 2
    hyp = scale_hyp(SCRATCH_LOW, nl=3, nc=nc, imgsz=64)
    t = np.array([[[0, 0.52, 0.52, 0.2, 0.2], [1, 0.53, 0.53, 0.21, 0.19]]], np.float32)
    v = np.ones((1, 2), bool)
    maps = [np.zeros((1, 64 // s, 64 // s, 3, 5 + nc), np.float32) for s in STRIDES]
    for order in ((0, 1), (1, 0)):
        tt, vv = t[:, order], v[:, order]
        ref_t, _ = jax_loss.ComputeLoss(APS, nc, hyp)([jnp.asarray(m) for m in maps],
                                                      jnp.asarray(tt), jnp.asarray(vv))
        got_t, _ = loss.ComputeLoss(APS, nc, hyp)([torch.from_numpy(m) for m in maps],
                                                  torch.from_numpy(tt), torch.from_numpy(vv))
        np.testing.assert_allclose(got_t.item(), float(ref_t), rtol=1e-6)
