"""Test-time augmentation and Ensemble: yolov5_tpu.infer and the port on the
same weights (yolov5n, nc 3, f32 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (assert_same_detection_sets, random_detector_weights,
                                      yolov5n_cfg)
from yolov5_tpu.infer import Detector as JaxDetector
from yolov5_tpu.infer import Ensemble as JaxEnsemble
from yolov5_tpu_torch.infer import Detector, Ensemble, ensemble, tta_scale
from yolov5_tpu_torch.models.weights import from_jax_variables

CFG = yolov5n_cfg(3)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Two .pt files of different random weights."""
    d = tmp_path_factory.mktemp("w")
    paths = []
    for seed in (0, 1):
        p = d / f"w{seed}.pt"
        torch.save({k: torch.from_numpy(v) for k, v in random_detector_weights(CFG, seed).items()},
                   p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("hw", [(96, 128), (576, 640)])
@pytest.mark.parametrize("ratio", [0.83, 0.67])
def test_tta_scale_matches_jax_resize(hw, ratio):
    """Antialiased bilinear, as jax.image.resize scales down: atol 2e-5, the
    same triangle filter summed in another order in f32 (without
    antialiasing the two differ by ~0.3 on noise)."""
    h, w = hw
    x = np.random.default_rng(h).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    nh, nw = int(h * ratio), int(w * ratio)
    ref = jax.image.resize(jnp.asarray(x), (2, nh, nw, 3), "bilinear")
    gs = 32
    ref = np.asarray(jnp.pad(ref, ((0, 0), (0, -int(-h * ratio // gs) * gs - nh),
                                   (0, -int(-w * ratio // gs) * gs - nw), (0, 0)),
                             constant_values=0.447))
    got = tta_scale(torch.from_numpy(x).permute(0, 3, 1, 2), ratio, gs).permute(0, 2, 3, 1)
    assert got.shape == ref.shape and got.shape[1] % gs == 0 and got.shape[2] % gs == 0
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_forward_tta_matches_jax(weights):
    """Decoded TTA predictions at 96x128 (three passes, one flipped): boxes
    within 5e-3 px + 1e-4 relative and scores within 1e-4, from raw maps
    that agree within 2e-3 (tests/test_torch_detector.py) and resized inputs
    within 2e-5."""
    jdet = JaxDetector(str(weights[0]), cfg=CFG, imgsz=128)
    det = Detector(from_jax_variables(jdet.variables), cfg=CFG, imgsz=128, device="cpu")
    ims = np.random.default_rng(0).integers(0, 255, (2, 96, 128, 3)).astype(np.uint8)
    ref = np.asarray(jdet._forward_tta(jdet.variables, jnp.asarray(ims)))
    got = det.forward_tta(ims).numpy()
    # passes at 96x128, 79x106 padded to 96x128, and 64x85 padded to 96x96
    # (h·ratio = 64.32 rounds up to three strides of 32)
    assert got.shape == ref.shape == (2, 3 * (2 * (12 * 16 + 6 * 8 + 3 * 4) + 12 * 12 + 6 * 6
                                              + 3 * 3), 8)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], atol=5e-3, rtol=1e-4)
    np.testing.assert_allclose(got[..., 4:], ref[..., 4:], atol=1e-4)
    kw = dict(conf_thres=0.01, max_det=100, max_nms=512, augment=True)
    dets = det(ims, **kw)
    assert int(dets.valid.sum()) > 0
    assert_same_detection_sets(dets, jdet(ims, **kw), atol=5e-3, rtol=1e-4)


def test_ensemble_matches_jax(weights):
    """Two members' decoded predictions, concatenated, then one NMS."""
    jdets = [JaxDetector(str(p), cfg=CFG, imgsz=64) for p in weights]
    dets = [Detector(from_jax_variables(j.variables), cfg=CFG, imgsz=64, device="cpu")
            for j in jdets]
    ims = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    ens, jens = Ensemble(dets), JaxEnsemble(jdets)
    # decoded boxes reach ~150 px: f32 differences of the maps scale with them
    np.testing.assert_allclose(ens.forward(ims).numpy(),
                               np.asarray(jens._forward(None, jnp.asarray(ims))),
                               atol=2e-3, rtol=1e-4)
    kw = dict(conf_thres=0.01, max_det=100, max_nms=512)
    got = ens(ims, **kw)
    assert int(got.valid.sum()) > 0 and ens.nc == 3 and ens.stride == dets[0].stride
    assert_same_detection_sets(got, jens(ims, **kw), atol=1e-3, rtol=1e-4)
    sub = ens(ims, classes=[1], **kw)
    assert set(sub.classes[sub.valid].tolist()) <= {1}
    with pytest.raises(ValueError, match="TTA"):
        ens(ims, augment=True)
    built = ensemble([str(p) for p in weights], cfg=CFG, imgsz=64, device="cpu")
    for a, b in zip(built.detectors, dets):
        for x, y in zip(a.forward_maps(ims), b.forward_maps(ims)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-4)
