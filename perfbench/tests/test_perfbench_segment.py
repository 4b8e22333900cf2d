"""The segmentation validation cell driven on the CPU at a small size
(yolov5n-seg at 128 px, f32, the port's plain kernels): a sound run is
correct; a run with the mask path broken underneath (masks from a
neighbouring detection's coefficients, prototypes shifted one pixel, the GT
masks dropped, the mask matching's IoU thresholds moved, the NMS gathering
each detection's coefficients from the next candidate or the next kept
row), or with the control (the reference in float8) in the program's
place, is not; and the mask stage's yardstick."""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest

from perfbench.core import flops, segment_flops, spec
from perfbench.run import assemble
from perfbench.tests import helpers

CELL = "yolov5x-seg.segval-b32"
DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def small_cell(**traffic) -> spec.Cell:
    """The cell with yolov5n-seg, 8 images of two shapes, long side 128."""
    cell = copy.deepcopy(spec.cell(CELL))
    cell.config = dict(cell.config, yaml=str(helpers.HERE / "yolov5n-seg.yaml"))
    cell.traffic.update({"batch": 4, "images": 8, "imgsz": 128, "half": False,
                         "shapes": [[72, 128], [128, 96]], "workers": 2}, **traffic)
    return cell


def _run():
    cell = small_cell()
    ctx = helpers.Ctx(cell, t_start=time.perf_counter())
    result = spec.runner(cell.traffic["kind"]).run(ctx)
    return cell, result, assemble(cell, result, False, DEVICE), ctx


def test_sound_run_is_correct():
    cell, result, line, ctx = _run()
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"val_img_s", "setup_s"}
    assert result["attempted"] > 0
    readings = [n["readings"] for n in ctx.notes if "readings" in n][0]
    assert readings["map.box"] > 0 and readings["map.mask"] > 0  # the matching is exercised
    assert readings["mask_gap.pairs"] > 20
    bounds = result["layer"]["nms_bounds_s"]  # K1's, a batch
    assert len(bounds) == 2 and all(b > 0 for b in bounds)


def _neighbour_coefficients(monkeypatch):
    from yolov5_tpu_torch.train import run_segment

    inner = run_segment.process_mask
    monkeypatch.setattr(run_segment, "process_mask",
                        lambda protos, c, boxes, hw, upsample=False:
                        inner(protos, c.roll(1, 0), boxes, hw, upsample=upsample))


def _protos_shifted(monkeypatch):
    from yolov5_tpu_torch.infer_segment import Segmenter

    inner = Segmenter.forward

    def forward(self, images):
        preds, proto = inner(self, images)
        return preds, proto.roll(1, 2)

    monkeypatch.setattr(Segmenter, "forward", forward)


def _gt_masks_dropped(monkeypatch):
    from yolov5_tpu_torch.data import dataset

    inner = dataset.rasterize_masks
    monkeypatch.setattr(dataset, "rasterize_masks", lambda *a, **k: np.zeros_like(inner(*a, **k)))


def _mask_thresholds_moved(monkeypatch):
    from yolov5_tpu_torch.train import run_segment

    inner = run_segment.process_batch
    monkeypatch.setattr(run_segment, "process_batch",
                        lambda d, lab, iouv, iou=None:
                        inner(d, lab, iouv if iou is None else iouv + 0.05, iou=iou))


def _next_candidate_coefficients(monkeypatch):
    from yolov5_tpu_torch.ops import nms

    inner = nms._suppress_and_pack
    monkeypatch.setattr(nms, "_suppress_and_pack",
                        lambda scores, boxes, cls, masks, **k:
                        inner(scores, boxes, cls, masks.roll(-1, 1), **k))


def _next_kept_coefficients(monkeypatch):
    from yolov5_tpu_torch.ops import nms

    inner = nms._suppress_and_pack

    def pack(*a, **k):
        d = inner(*a, **k)
        return d._replace(masks=d.masks.roll(-1, 1))

    monkeypatch.setattr(nms, "_suppress_and_pack", pack)


@pytest.mark.parametrize("fault", [_neighbour_coefficients, _protos_shifted, _gt_masks_dropped,
                                   _mask_thresholds_moved, _next_candidate_coefficients,
                                   _next_kept_coefficients],
                         ids=["neighbour_coefficients", "protos_shifted", "gt_masks_dropped",
                              "mask_thresholds_moved", "next_candidate_coefficients",
                              "next_kept_coefficients"])
def test_broken_mask_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, _, line, _ = _run()
    assert not line["correct"], line["checks"]


def test_control_is_not_correct():
    """The reference in float8 in the program's place fails a limit."""
    cell = small_cell()
    d = spec.runner(cell.traffic["kind"]).Runner(helpers.Ctx(cell))
    try:
        d.prepare()
        readings = d.readings(d.control_outputs("fp8"), d.reference())
    finally:
        d.close()
    assert any(readings[k] > v for k, v in cell.limits.items()), readings


def test_mask_stage_bound():
    # 300 masks and 8 GT instances of a 640² input, bf16 prototypes at 160²:
    # the operations bound it
    ops = 2.0 * (300 * 160 * 160 * 32 + 4 * 308 * 640 * 640 + 8 * 300 * 640 * 640)
    assert segment_flops.mask_stage_ops(300, 8, 640, 160, 160, 32) == ops
    nbytes = 160 * 160 * 32 * 2 + 300 * 36 * 4 + 160 * 160 * 4 + 8 * 300 * 4
    assert segment_flops.mask_stage_bytes(300, 8, 160, 160, 32, 2) == nbytes
    assert segment_flops.mask_stage_bound_s([(300, 8)] * 2, 640, 160, 160, 32, 2) == (
        pytest.approx(2 * ops / flops.PEAK_F32))
    # a few small masks: the bytes bound it
    assert segment_flops.mask_stage_bound_s([(1, 1)], 32, 160, 160, 32, 4) == pytest.approx(
        segment_flops.mask_stage_bytes(1, 1, 160, 160, 32, 4) / flops.PEAK_BYTES)


def test_span_roofline_reads_the_spans(monkeypatch):
    from types import SimpleNamespace

    from perfbench.core import program_spans

    spans = [SimpleNamespace(name="segval.masks", device_ms=2.0),
             SimpleNamespace(name="segval.masks", device_ms=6.0),
             SimpleNamespace(name="segval.nms", device_ms=50.0)]
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    result = {"layer": {"mask_bounds_s": [0.001, 0.003]}}
    assert segment_flops.span_roofline_pct(result, "segval.masks", "mask_bounds_s") == (
        pytest.approx(50.0))
    assert segment_flops.span_roofline_pct({"layer": {}}, "segval.masks", "mask_bounds_s") is None
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    assert segment_flops.span_roofline_pct(result, "segval.masks", "mask_bounds_s") is None


def test_seg_flops_against_published():
    from perfbench.reference import segment, yolo

    cfg = yolo.load_yaml(spec.ROOT / "perfbench" / "configs" / "yolov5x-seg.yaml")
    # ultralytics/yolov5 v7.0's segmentation table: 88.8 M parameters, 265.7 GFLOPs
    assert segment.params(cfg) == 88819517
    assert 2 * segment_flops.conv_macs(cfg, 640, 640, bn=True) / 1e9 == pytest.approx(265.7,
                                                                                      rel=0.005)
    assert segment_flops.model_flops(cfg, 640, 640) == 2 * segment_flops.conv_macs(cfg, 640, 640)
