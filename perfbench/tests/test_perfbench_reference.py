"""The plain reference against the port on the CPU (yolov5n at 128 px), and
the yardstick's operation counts against the published ones."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.core import compare, flops, weights
from perfbench.reference import nms as ref_nms
from perfbench.reference import yolo
from perfbench.tests.helpers import HERE

YOLOV5N = HERE / "yolov5n.yaml"


@pytest.fixture(scope="module")
def model_and_weights():
    cfg = yolo.load_yaml(YOLOV5N)
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (4, 128, 128, 3), dtype=torch.uint8, generator=gen)
    sd, measured, _ = weights.calibrated(cfg, 2**33 + 5, [x], 0.25, 30, False, torch.device("cpu"))
    return cfg, sd, x, measured


def test_calibration_hits_its_count(model_and_weights):
    _, _, _, measured = model_and_weights
    assert measured == pytest.approx(30, abs=1)


def test_calibration_on_kept_detections():
    cfg = yolo.load_yaml(YOLOV5N)
    x = torch.randint(0, 256, (4, 128, 128, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(4))
    nms = {"iou_thres": 0.45, "max_det": 1000, "max_nms": 2048}
    sd, measured, _ = weights.calibrated(cfg, 9, [x], 0.25, 12, False, torch.device("cpu"), nms=nms)
    xi = x.permute(0, 3, 1, 2).float() / 255.0
    rows = ref_nms.nms(yolo.decode(yolo.Model(cfg, sd)(xi), cfg), 0.25, 0.45, 1000, 2048)
    assert sum(len(r) for r in rows) / len(rows) == pytest.approx(measured)
    assert measured == pytest.approx(12, abs=1)


def test_reference_forward_equals_port(model_and_weights):
    from yolov5_tpu_torch.models.layers import decode
    from yolov5_tpu_torch.models.weights import load_weights
    from yolov5_tpu_torch.models.yolo import DetectionModel

    cfg, sd, x, _ = model_and_weights
    port = DetectionModel(str(YOLOV5N))
    assert load_weights(port, sd) == []
    port.eval()
    xi = x.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        theirs = port(xi.contiguous(memory_format=torch.channels_last))
        ours = yolo.Model(cfg, sd)(xi.contiguous())
    for a, b in zip(theirs, ours):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-4)  # f32, two conv layouts
    assert port.stride == tuple(yolo.strides_of(cfg))
    anchors = tuple(torch.tensor(a, dtype=torch.float32) for a in port.anchors)
    torch.testing.assert_close(decode(theirs, anchors, port.stride),
                               yolo.decode(ours, cfg), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("multi_label", [False, True])
def test_reference_nms_equals_port(model_and_weights, multi_label):
    from yolov5_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression

    cfg, sd, x, _ = model_and_weights
    pred = yolo.decode(yolo.Model(cfg, sd)(x.permute(0, 3, 1, 2).float() / 255.0), cfg)
    conf = 0.1 if multi_label else 0.25
    ours = ref_nms.nms(pred, conf, 0.45, 300, 30720, multi_label=multi_label)
    theirs = detections_to_numpy(non_max_suppression(pred, conf, 0.45, multi_label=multi_label,
                                                     max_det=300))
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        np.testing.assert_allclose(a[:, :6], b[:, :6], rtol=1e-5, atol=1e-4)
    strides = yolo.row_strides(cfg, 128, 128)
    assert max(compare.detection_gaps(theirs, pred, ours, strides, conf, 0.45, 300)) < 1e-4


def test_greedy_counts_the_ious_it_needs():
    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, 9], [20, 20, 30, 30], [21, 20, 30, 30],
                           [50, 50, 60, 60]]], dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6, 0.0]])
    keep, needed = ref_nms.greedy(boxes, scores, 0.5, 300)
    assert keep.tolist() == [[True, False, True, False, False]]
    # 1 meets kept 0 (suppressed); 2 meets 0; 3 meets 0 then 2 (suppressed)
    assert needed.tolist() == [1 + 1 + 2]
    keep, needed = ref_nms.greedy(boxes, scores, 0.5, 1)  # stops at the first keep
    assert keep.tolist() == [[True, False, False, False, False]] and needed.tolist() == [0]


@pytest.mark.parametrize("name, params, gflops", [("yolov5s", 7235389, 16.5),
                                                  ("yolov5x", 86749405, 205.7)])
def test_flops_against_published(name, params, gflops):
    cfg = yolo.load_yaml(HERE.parent / "configs" / f"{name}.yaml")
    assert 2 * flops.conv_macs(cfg, 640, 640, bn=True) / 1e9 == pytest.approx(gflops, rel=0.005)
    shapes = yolo.leaf_shapes(cfg)
    assert sum(int(np.prod(s)) for k, s in shapes.items() if "running" not in k) == params


def test_roofline_bounds():
    # K2 at b32 x 640² bf16, c2 32: 288 MB at 3.35 TB/s bound it
    assert flops.stem_bound_s(32, 640, 640, 32, 2) == pytest.approx(
        (32 * 3 * 640 * 640 + 32 * 32 * 320 * 320) * 2 / 3.35e12)
    # K1: bytes where the walk needs few IoUs, operations where it needs many
    assert flops.nms_bound_s(1000, 2048, 0) == pytest.approx((20 * 1000 + 2048) / 3.35e12)
    assert flops.nms_bound_s(1000, 2048, 10**7) == pytest.approx(17e7 / 67e12)
