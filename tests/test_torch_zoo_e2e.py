"""yolov3-tiny, yolov5s-ghost and yolov5s-transformer end to end, port
against the JAX package on the same seeded variables (width 0.125, depth
0.33, f32 on the CPU): the detections of the port's Detector (BN folded,
NMS from the raw maps) against the JAX model's unfused maps through its
``non_max_suppression_from_maps`` (equal counts, boxes within 1e-3 px),
and one train step's loss (within 1e-5 relative) and gradients (within
3e-3 of each tensor's largest entry, the tolerance of
tests/test_torch_train_step.py: two f32 convolution libraries summing in
other orders, through train-mode BN). A gradient that is zero in exact
arithmetic is rounding noise in both packages: the transformer's biases
add a constant per channel that C3TR's cv3 BN, in train mode, takes away
again (~3e-9 against a largest gradient of ~0.5). Every tensor is held
within 3e-3 of its largest entry or of 1e-5 of the model's largest
gradient, whichever is more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_same_detection_sets, nchw, zoo_pair
from yolov5_tpu.ops.nms import non_max_suppression_from_maps as jax_nms_from_maps
from yolov5_tpu.train import loss as jax_loss
from yolov5_tpu.utils.hyp import SCRATCH_LOW
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.models.yolo import DetectionModel
from yolov5_tpu_torch.train import loss, trainer

CONFIGS = ["yolov3-tiny", "yolov5s-ghost", "yolov5s-transformer"]
IMGSZ = 128


@pytest.mark.parametrize("name", CONFIGS)
def test_detections_match_jax(name):
    cfg, jm, variables, _ = zoo_pair(name)
    images = np.random.default_rng(7).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    maps = jm.apply(variables, jnp.asarray(images, jnp.float32) / 255.0)
    # max_det above the candidate count: no cut among near-equal scores
    kw = dict(conf_thres=0.01, iou_thres=0.45, max_det=2048, max_nms=4096)
    ref = jax_nms_from_maps(maps, jm.anchors, jm.stride, nc=jm.nc, **kw)
    det = Detector(from_jax_variables(variables), cfg=cfg, imgsz=IMGSZ, device="cpu")
    assert det.stride == jm.stride
    got = det(images, **kw)
    assert int(got.valid.sum()) > 0
    assert_same_detection_sets(got, ref, atol=1e-3)


def _targets(rng, bs=2, m=6):
    t = np.zeros((bs, m, 5), np.float32)
    v = np.zeros((bs, m), bool)
    for b in range(bs):
        n = 3 + b
        t[b, :n, 0] = rng.integers(0, 3, n)
        t[b, :n, 1:3] = rng.uniform(0.15, 0.85, (n, 2))
        t[b, :n, 3:5] = rng.uniform(0.05, 0.5, (n, 2))
        v[b, :n] = True
    return t, v


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_loss_and_grads_match_jax(name):
    cfg, jm, variables, _ = zoo_pair(name)
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    t, v = _targets(rng)
    nl = len(jm.stride)
    hyp = trainer.scale_hyp(SCRATCH_LOW, nl=nl, nc=3, imgsz=IMGSZ)
    jloss = jax_loss.ComputeLoss(jm.anchors_per_stride, 3, hyp)

    def loss_of(params):
        out, _ = jm.module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jloss(out, jnp.asarray(t), jnp.asarray(v))[0]

    ref_total, ref_grads = jax.jit(jax.value_and_grad(loss_of))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    port = DetectionModel(cfg)
    port.load_state_dict(from_jax_variables(variables))
    assert port.anchors_per_stride == jm.anchors_per_stride
    total, _ = loss.ComputeLoss(port.anchors_per_stride, 3, hyp)(
        port.train()(nchw(x)), torch.from_numpy(t), torch.from_numpy(v))
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
    ref = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, ref_grads)})
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(ref)
    floor = 1e-5 * max(float(r.abs().max()) for r in ref.values())
    for k, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                   atol=3e-3 * max(np.abs(r).max(), floor), err_msg=k)
