"""The plain reference against the port on a P6 graph on the CPU (yolov5n6
at 256 px: four Detect levels, strides 8-64), through ``infer.Detector`` and
the NMS from the raw maps, and the yardstick's counts of yolov5x6 against
the published ones."""

from __future__ import annotations

import copy
import json
import time

import numpy as np
import pytest
import torch

from perfbench.core import compare, data, flops, p6_weights, spec, weights
from perfbench.reference import nms as ref_nms
from perfbench.reference import yolo
from perfbench.run import assemble
from perfbench.runners import detect_batch_p6
from perfbench.tests import helpers
from perfbench.tests.helpers import HERE
from perfbench.tests.test_perfbench_faults import _altered, _half

YOLOV5N6 = HERE / "yolov5n6.yaml"
IMGSZ = 256
NMS = {"iou_thres": 0.45, "max_det": 1000, "max_nms": 2048}


@pytest.fixture(scope="module")
def p6():
    """yolov5n6's seeded weights calibrated as a detect cell's (30 kept
    detections an image), its 256 px batch and the port's Detector on them."""
    from yolov5_tpu_torch.infer import Detector

    cfg = yolo.load_yaml(YOLOV5N6)
    x = torch.randint(0, 256, (3, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(6))
    sd, measured, _ = p6_weights.calibrated(cfg, 2**33 + 6, [x], 0.25, 30, False,
                                            torch.device("cpu"), nms=NMS)
    det = Detector(sd, cfg=str(YOLOV5N6), imgsz=IMGSZ, device="cpu")
    xi = x.permute(0, 3, 1, 2).float() / 255.0
    return cfg, sd, x, yolo.Model(cfg, sd)(xi.contiguous()), det, measured


def test_p6_calibration_keeps_its_count(p6):
    assert p6[-1] == pytest.approx(30, abs=1)


def test_p6_raw_maps_equal_reference(p6):
    cfg, _, x, ours, det, _ = p6
    theirs = det.forward_maps(x)
    assert len(theirs) == len(ours) == 4
    for a, b, s in zip(theirs, ours, yolo.strides_of(cfg)):
        assert a.shape == b.shape == (3, IMGSZ // s, IMGSZ // s, 3, 85)
        # f32 both, BN folded into the port's convs and kept apart in the
        # reference's, two conv layouts: the reference test's tolerance
        torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-4)
    assert det.stride == tuple(yolo.strides_of(cfg))
    for a, b in zip(det.anchors, yolo.anchors_px(cfg)):
        torch.testing.assert_close(a, b)


def test_p6_detections_from_maps_equal_reference(p6):
    from yolov5_tpu_torch.ops.nms import detections_to_numpy

    cfg, _, x, maps, det, _ = p6
    pred = yolo.decode(maps, cfg)
    ours = ref_nms.nms(pred, 0.25, **NMS)
    theirs = detections_to_numpy(det(x, conf_thres=0.25, **NMS))
    assert sum(len(r) for r in ours) > 30  # the walk has work on every level's rows
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        # the reference test's tolerance: both select and suppress exactly in
        # f32, and the port's boxes decode from maps within the tolerance above
        np.testing.assert_allclose(a[:, :6], b[:, :6], rtol=1e-5, atol=1e-4)
    strides = yolo.row_strides(cfg, IMGSZ, IMGSZ)
    assert max(compare.detection_gaps(theirs, pred, ours, strides, 0.25, 0.45, 1000)) < 1e-4


@pytest.mark.parametrize("name, params, gflops", [("yolov5x6", 140794780, 209.8)])
def test_flops_against_published(name, params, gflops):
    """The frozen YAML's parameter count is 140 794 780 (published: 140.7 M)
    and its GFLOPs at 640 with BN 210.01 (published: 209.8)."""
    cfg = yolo.load_yaml(HERE.parent / "configs" / f"{name}.yaml")
    assert 2 * flops.conv_macs(cfg, 640, 640, bn=True) / 1e9 == pytest.approx(gflops, rel=0.005)
    shapes = yolo.leaf_shapes(cfg)
    assert sum(int(np.prod(s)) for k, s in shapes.items() if "running" not in k) == params
    assert params == pytest.approx(140.7e6, rel=0.001)
    # at the cell's 1280 px, folded: 838.3 GFLOPs an image
    assert flops.model_flops(cfg, 1280, 1280) / 1e9 == pytest.approx(838.3, abs=0.05)


def test_p6_weights_halve_the_bn_scales():
    cfg = yolo.load_yaml(YOLOV5N6)
    base = weights._draw(cfg, torch.Generator().manual_seed(5), torch.device("cpu"))
    ours = p6_weights.draw(cfg, torch.Generator().manual_seed(5), torch.device("cpu"))
    assert base.keys() == ours.keys()
    for k, v in base.items():
        if k.endswith("bn.weight"):
            torch.testing.assert_close(ours[k], v * p6_weights.BN_GAIN, rtol=0, atol=0)
            assert 0.05 <= float(ours[k].min()) <= float(ours[k].max()) <= 0.15
        else:
            assert torch.equal(ours[k], v), k


CELL = "yolov5x6.detect-b32-1280"
SMALL = {"batch": 2, "pool_batches": 2, "frame_hw": [216, 384], "imgsz": 256, "half": False,
         "det_per_img": 30, "trace_batches": 2}


def _small_cell():
    """The P6 cell with yolov5n6 at 256 px and small traffic, on the CPU:
    frames of 384x216 resized to 256x144 before the letterbox, as the
    cell's 1080p frames to 1280x720."""
    cell = copy.deepcopy(spec.cell(CELL))
    cfg = json.loads((HERE.parent / "configs" / "yolov5x6.json").read_text())
    cfg["yaml"] = str(YOLOV5N6)
    cell.config = cfg
    cell.traffic.update(SMALL)
    return cell


def _run(monkeypatch=None, fault=None):
    if fault is not None:
        from yolov5_tpu_torch.infer import Detector

        inner = Detector.__call__
        monkeypatch.setattr(Detector, "__call__", lambda self, *a, **k: fault(inner(self, *a, **k)))
    cell = _small_cell()
    ctx = helpers.Ctx(cell, t_start=time.perf_counter())
    result = spec.runner(cell.traffic["kind"]).run(ctx)
    device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return cell, result, assemble(cell, result, False, device), ctx


@pytest.mark.parametrize("frame_hw, s, hw", [((1080, 1920), 1280, (720, 1280)),
                                             ((216, 384), 256, (144, 256)),
                                             ((300, 200), 256, (256, 171))])
def test_p6_resize_is_yolov5s(frame_hw, s, hw):
    """The frames scaled to yolov5's letterbox size by cv2.INTER_LINEAR's
    sampling: OpenCV rounds its weights to 11 bits, so a value may differ
    by one."""
    cv2 = pytest.importorskip("cv2")
    ims = data.frames(data.generator(7, torch.device("cpu")), 2, *frame_hw)
    ours = detect_batch_p6.resize(ims, s)
    assert ours.shape == (2, *hw, 3) and ours.dtype == torch.uint8
    for a, b in zip(ims.numpy(), ours.numpy()):
        theirs = cv2.resize(a, hw[::-1], interpolation=cv2.INTER_LINEAR)
        assert np.abs(theirs.astype(int) - b.astype(int)).max() <= 1
    same = data.frames(data.generator(7, torch.device("cpu")), 1, hw[0], s)
    assert detect_batch_p6.resize(same, s) is same


def test_p6_cell_pool_is_resized_then_padded():
    cell = _small_cell()
    d = spec.runner(cell.traffic["kind"]).Runner(helpers.Ctx(cell))
    d.inputs()
    assert [tuple(b.shape) for b in d.batches] == [(2, 256, 256, 3)] * 2
    top = data.pads(144, 256, 256, 256)[0]
    pool = torch.cat(d.batches)
    assert (pool[:, :top] == data.PAD).all() and (pool[:, top + 144:] == data.PAD).all()
    ims = data.frames(data.generator(2 * d.ctx.seed + 1, torch.device("cpu")), 4, 216, 384)
    assert torch.equal(pool[:, top:top + 144], detect_batch_p6.resize(ims, 256))


def test_p6_cell_sound_run_is_correct():
    cell, result, line, ctx = _run()
    assert cell.traffic["kind"] == "detect_batch_p6"
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"detect_img_s", "setup_s"}
    assert result["attempted"] > 0
    assert result["layer"]["stem_bound_s"] == flops.stem_bound_s(2, 256, 256, 16, 4)
    calibrated = [n["detections_per_image_calibrated"] for n in ctx.notes
                  if "detections_per_image_calibrated" in n]
    assert calibrated == [pytest.approx(30, abs=1)]


@pytest.mark.parametrize("fault", [_half, _altered], ids=["half_batch", "answer_altered"])
def test_p6_cell_broken_path_is_not_correct(monkeypatch, fault):
    line = _run(monkeypatch, fault)[2]
    assert not line["correct"], line["checks"]


def test_p6_cell_control_is_not_correct():
    """The reference in float8 in the program's place fails a limit."""
    cell = _small_cell()
    d = spec.runner(cell.traffic["kind"]).Runner(helpers.Ctx(cell))
    d.prepare()
    readings = d.readings(d.control_outputs("fp8"), d.reference())
    assert any(readings[k] > v for k, v in cell.limits.items()), readings
