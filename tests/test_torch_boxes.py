"""yolov5_tpu_torch host code and box ops against their JAX-package originals:
box geometry, letterbox and its inverse, the YAML graph specs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolov5_tpu.data.letterbox import letterbox as jax_letterbox
from yolov5_tpu.infer import scale_boxes_np as jax_scale_boxes_np
from yolov5_tpu.models import yolo as jax_yolo
from yolov5_tpu.ops import boxes as jax_boxes
from yolov5_tpu_torch.data.letterbox import letterbox, scale_boxes_np
from yolov5_tpu_torch.models import yolo
from yolov5_tpu_torch.ops import boxes


def _boxes(rng, n):
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(1, 80, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_converters_and_clip(rng):
    b = _boxes(rng, 50)
    t = torch.from_numpy(b)
    # elementwise f32 arithmetic in the same order: equal to the last ulp
    for port, ref in ((boxes.xyxy2xywh, jax_boxes.xyxy2xywh),
                      (boxes.xywh2xyxy, jax_boxes.xywh2xyxy)):
        np.testing.assert_allclose(port(t).numpy(), np.asarray(ref(jnp.asarray(b))),
                                   rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(boxes.clip_boxes(t, (200, 150)).numpy(),
                                  np.asarray(jax_boxes.clip_boxes(jnp.asarray(b), (200, 150))))


@pytest.mark.parametrize("name,kw", [
    ("xywhn2xyxy", dict(w=640, h=480, padw=12, padh=-3)),
    ("xyxy2xywhn", dict(w=320, h=416)),
    ("xyxy2xywhn", dict(w=320, h=416, clip=True, eps=1e-3)),
    ("xyn2xy", dict(w=640, h=352, padw=4, padh=8)),
])
def test_normalized_box_converters_match_jax(rng, name, kw):
    """The normalized converters equal the JAX package's within 1e-6."""
    if name == "xyn2xy":
        x = rng.uniform(-0.1, 1.1, (40, 2)).astype(np.float32)
    elif name == "xywhn2xyxy":
        x = np.concatenate([rng.uniform(0, 1, (40, 2)), rng.uniform(0.01, 0.5, (40, 2))],
                           -1).astype(np.float32)
    else:  # pixel corners, some past the image for clip
        x = _boxes(rng, 40) * np.float32(1.2) - np.float32(10)
    got = getattr(boxes, name)(torch.from_numpy(x), **kw).numpy()
    ref = np.asarray(getattr(jax_boxes, name)(jnp.asarray(x), **kw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_package_reexports_match_jax():
    """``yolov5_tpu_torch.ops`` and ``.models`` export the names the JAX
    package's ``ops`` and ``models`` export, each the port's function."""
    import yolov5_tpu.models as jax_models
    import yolov5_tpu.ops as jax_ops
    import yolov5_tpu_torch.models as port_models
    import yolov5_tpu_torch.ops as port_ops
    from yolov5_tpu_torch.ops import nms

    assert sorted(port_ops.__all__) == sorted(jax_ops.__all__)
    assert sorted(port_models.__all__) == sorted(jax_models.__all__)
    for name in port_ops.__all__:
        assert getattr(port_ops, name) is getattr(
            nms if name == "non_max_suppression" else boxes, name)
    for name in port_models.__all__:
        assert getattr(port_models, name) is getattr(yolo, name)


def test_box_iou(rng):
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    got = boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_boxes.box_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)  # f32 rounding only


def _xywh(rng, n):
    return np.concatenate([rng.uniform(0, 20, (n, 2)), rng.uniform(0.5, 12, (n, 2))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["IoU", "GIoU", "DIoU", "CIoU"])
@pytest.mark.parametrize("xywh", [True, False])
def test_bbox_iou_matches_jax(rng, kind, xywh):
    """Elementwise IoU variants within 1e-6, and CIoU's gradient (alpha
    carries none) within 1e-5."""
    a = _xywh(rng, 64)
    b = a + rng.normal(0, 1.5, a.shape).astype(np.float32)  # overlapping pairs
    b[:, 2:] = np.abs(b[:, 2:]) + 0.5
    if not xywh:  # corner boxes
        a, b = (np.concatenate([x[:, :2], x[:, :2] + x[:, 2:]], -1) for x in (a, b))
    flags = {kind: True} if kind != "IoU" else {}
    got = boxes.bbox_iou(torch.from_numpy(a), torch.from_numpy(b), xywh=xywh, **flags)
    ref = jax_boxes.bbox_iou(jnp.asarray(a), jnp.asarray(b), xywh=xywh, **flags)
    assert got.shape == (64, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)

    import jax

    ta = torch.from_numpy(a).requires_grad_()
    boxes.bbox_iou(ta, torch.from_numpy(b), xywh=xywh, **flags).sum().backward()
    ga = jax.grad(lambda x: jax_boxes.bbox_iou(x, jnp.asarray(b), xywh=xywh, **flags).sum())(
        jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=1e-5)


def test_bbox_ioa_wh_iou_smooth_bce(rng):
    a, b = _boxes(rng, 20), _boxes(rng, 12)
    np.testing.assert_allclose(boxes.bbox_ioa(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_boxes.bbox_ioa(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)
    wa, wb = _xywh(rng, 20)[:, 2:], _xywh(rng, 9)[:, 2:]
    np.testing.assert_allclose(boxes.wh_iou(torch.from_numpy(wa), torch.from_numpy(wb)).numpy(),
                               np.asarray(jax_boxes.wh_iou(jnp.asarray(wa), jnp.asarray(wb))),
                               atol=1e-6)
    for eps in (0.0, 0.1, 0.3):
        assert boxes.smooth_bce(eps) == jax_boxes.smooth_bce(eps)


def test_scale_boxes(rng):
    b = _boxes(rng, 20)
    for img0 in ((480, 640), (640, 320), (377, 500)):
        got = boxes.scale_boxes((640, 640), torch.from_numpy(b), img0).numpy()
        ref = np.asarray(jax_boxes.scale_boxes((640, 640), jnp.asarray(b), img0))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(scale_boxes_np((640, 640), b, img0),
                                      jax_scale_boxes_np((640, 640), b, img0))


def test_make_divisible():
    for x in (1, 7.5, 8, 16.01, 1024 * 0.25, 3 * 0.33):
        assert boxes.make_divisible(x) == jax_boxes.make_divisible(x)


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (640, 640), (320, 640),
                                   (300, 500), (1000, 750)])
@pytest.mark.parametrize("auto", [False, True])
def test_letterbox_matches_jax(rng, shape, auto):
    """Padding-only shapes and resizes; the numpy border equals cv2's."""
    im = rng.integers(0, 255, (*shape, 3)).astype(np.uint8)
    got, ratio, pad = letterbox(im, 640, auto=auto)
    ref, ratio_r, pad_r = jax_letterbox(im, 640, auto=auto)
    np.testing.assert_array_equal(got, ref)
    assert (ratio, pad) == (ratio_r, pad_r)


def test_letterbox_pad_only_needs_no_opencv(rng, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)  # any import of cv2 now fails
    im = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
    out, _, (dw, dh) = letterbox(im, 640)
    assert out.shape == (640, 640, 3) and (dw, dh) == (0.0, 80.0)
    assert (out[:80] == 114).all() and (out[80:560] == im).all()


@pytest.mark.parametrize("path", sorted(p.name for p in jax_yolo.CONFIG_DIR.glob("*.yaml")
                                        if p.stem != "anchors"))
def test_parse_graph_matches_jax(path):
    """The copied parser gives the JAX package's specs for every bundled YAML."""
    assert yolo.CONFIG_DIR.samefile(jax_yolo.CONFIG_DIR)
    cfg = yolo.load_config(path)  # resolved against the bundled configs
    ref_cfg = jax_yolo.load_config(path)
    assert {k: v for k, v in cfg.items() if k != "yaml_file"} == \
        {k: v for k, v in ref_cfg.items() if k != "yaml_file"}
    specs, save, ch = yolo.parse_graph(cfg)
    r_specs, r_save, r_ch = jax_yolo.parse_graph(ref_cfg)
    assert [vars(s) for s in specs] == [vars(s) for s in r_specs]
    assert (save, ch) == (r_save, r_ch)
    if specs[-1].args and specs[-1].args[1]:
        for strides in ((8, 16, 32), (32, 16, 8)):
            assert yolo.check_anchor_order(specs[-1].args[1], strides) == \
                jax_yolo.check_anchor_order(r_specs[-1].args[1], strides)
