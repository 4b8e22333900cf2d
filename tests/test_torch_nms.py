"""yolov5_tpu_torch NMS functions against yolov5_tpu.ops.nms on the same
inputs, over multi_label, agnostic, class_filter, mask coefficients and
merge. Detections are compared as tests/test_nms.py::_assert_same_detections
does: equal valid masks, every valid field within atol 1e-4 (boxes of a few
hundred px and scores in [0, 1], from the same f32 arithmetic up to the
order of a few sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import assert_same_detections
from yolov5_tpu.ops import nms as jax_nms
from yolov5_tpu_torch.models.layers import decode
from yolov5_tpu_torch.ops import nms


def _prediction(rng, bs=2, n=400, nc=3, nm=0):
    """A decoded head output (bs, n, 5+nc+nm), as tests/test_nms.py makes it."""
    pred = np.zeros((bs, n, 5 + nc + nm), np.float32)
    pred[..., 0:2] = rng.uniform(50, 250, (bs, n, 2))
    pred[..., 2:4] = rng.uniform(10, 50, (bs, n, 2))
    pred[..., 4] = rng.uniform(0, 1, (bs, n))
    pred[..., 5:5 + nc] = rng.uniform(0, 1, (bs, n, nc))
    if nm:
        pred[..., 5 + nc:] = rng.normal(size=(bs, n, nm))
    return pred


def _maps(rng, bs=2, nc=7, nm=0, levels=((12, 16, 3), (6, 8, 3)), strides=(8, 16)):
    """Raw logit head maps + anchors in pixels, as tests/test_nms.py makes them."""
    no = 5 + nc + nm
    maps, anchors = [], []
    for (ny, nx, na), s in zip(levels, strides):
        maps.append(rng.normal(0, 2.0, (bs, ny, nx, na, no)).astype(np.float32))
        anchors.append((rng.uniform(0.5, 4.0, (na, 2)) * s).astype(np.float32))
    return maps, anchors, list(strides)


OPTIONS = [
    dict(),
    dict(multi_label=True),
    dict(agnostic=True),
    dict(class_filter=np.array([True, False, True])),
    dict(merge=True),
    dict(multi_label=True, agnostic=True),
    dict(max_det=5),
]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "-".join(o) or "default")
def test_non_max_suppression_matches_jax(rng, opts):
    pred = _prediction(rng)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=50, max_nms=512)
    kw.update(opts)
    cf = kw.pop("class_filter", None)
    ref = jax_nms.non_max_suppression(
        jnp.asarray(pred), class_filter=None if cf is None else jnp.asarray(cf), **kw)
    got = nms.non_max_suppression(torch.from_numpy(pred), class_filter=cf, **kw)
    assert int(got.valid.sum()) > 0
    assert_same_detections(got, ref)


def test_non_max_suppression_mask_coeffs(rng):
    pred = _prediction(rng, bs=1, n=60, nc=2, nm=8)
    kw = dict(nc=2, max_nms=128, max_det=20)
    ref = jax_nms.non_max_suppression(jnp.asarray(pred), **kw)
    got = nms.non_max_suppression(torch.from_numpy(pred), **kw)
    assert tuple(got.masks.shape) == (1, 20, 8)
    assert_same_detections(got, ref)
    rows = nms.detections_to_numpy(got)[0]
    np.testing.assert_allclose(rows, jax_nms.detections_to_numpy(ref)[0], atol=1e-4)


MAP_OPTIONS = [
    dict(),
    dict(multi_label=True),
    dict(nm=4),
    dict(multi_label=True, nm=4),
    dict(agnostic=True),
    dict(merge=True),
    dict(class_filter=np.array([1, 0, 1, 0, 1, 0, 1], bool)),
]


@pytest.mark.parametrize("opts", MAP_OPTIONS, ids=lambda o: "-".join(o) or "default")
def test_from_maps_matches_jax(rng, opts):
    """non_max_suppression_from_maps against the JAX function, and against
    the port's own decode-then-NMS (the same candidate set by construction)."""
    opts = dict(opts)
    nc, nm = 7, opts.pop("nm", 0)
    maps, anchors, strides = _maps(rng, nc=nc, nm=nm)
    cf = opts.pop("class_filter", None)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=50, max_nms=256, nc=nc, **opts)
    ref = jax_nms.non_max_suppression_from_maps(
        [jnp.asarray(m) for m in maps], anchors, strides,
        class_filter=None if cf is None else jnp.asarray(cf), **kw)
    t_maps = [torch.from_numpy(m) for m in maps]
    got = nms.non_max_suppression_from_maps(t_maps, anchors, strides, class_filter=cf, **kw)
    assert int(got.valid.sum()) > 0
    assert_same_detections(got, ref)
    decoded = nms.non_max_suppression(decode(t_maps, anchors, strides, nc=nc),
                                      class_filter=cf, **kw)
    assert_same_detections(got, decoded)


def test_from_maps_bf16_maps_and_global_reselect(rng):
    """bf16 maps (ties in score are common) and a cap below one level's size,
    so the per-level select and the global re-select both cut."""
    nc = 4
    maps, anchors, strides = _maps(rng, nc=nc)
    t_maps = [torch.from_numpy(m).to(torch.bfloat16) for m in maps]
    j_maps = [jnp.asarray(m.float().numpy()).astype(jnp.bfloat16) for m in t_maps]
    kw = dict(conf_thres=0.1, iou_thres=0.5, max_det=40, max_nms=100, nc=nc)
    ref = jax_nms.non_max_suppression_from_maps(j_maps, anchors, strides, **kw)
    got = nms.non_max_suppression_from_maps(t_maps, anchors, strides, **kw)
    assert int(got.valid.sum()) > 0
    assert_same_detections(got, ref)


def test_from_maps_walks_in_score_order_under_the_cap(rng):
    """With fewer candidates than max_nms the levels' candidates are still
    sorted globally before suppression, so from_maps equals decode-then-NMS
    (yolov5_tpu walks them level by level there; see ROADMAP.md)."""
    nc = 5
    maps, anchors, strides = _maps(rng, nc=nc)
    t_maps = [torch.from_numpy(m) for m in maps]
    kw = dict(conf_thres=0.2, iou_thres=0.45, max_det=60, max_nms=4096, nc=nc)
    got = nms.non_max_suppression_from_maps(t_maps, anchors, strides, **kw)
    ref = nms.non_max_suppression(decode(t_maps, anchors, strides, nc=nc), **kw)
    assert int(got.valid.sum()) == 2 * 60  # max_det cuts: order matters
    assert_same_detections(got, ref)
