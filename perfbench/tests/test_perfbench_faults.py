"""A run driven on the CPU at a small size, past the look for a card: a
sound run is correct, and a run with the timed path broken underneath (half
of each batch left out; an answer altered where it is produced; the val
pass's matching against its labels broken), or with the control (the
reference in float8) in the program's place, is not."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench.core import spec
from perfbench.run import assemble
from perfbench.tests import helpers

DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _run(name):
    cell = helpers.small_cell(name)
    ctx = helpers.Ctx(cell, t_start=time.perf_counter())
    result = spec.runner(cell.traffic["kind"]).run(ctx)
    return cell, result, assemble(cell, result, False, DEVICE), ctx


def _half(dets):
    valid = dets.valid.clone()
    valid[valid.shape[0] // 2:] = False
    return dets._replace(valid=valid)


def _altered(dets):
    """Each image's first detection moved by its own size and 16 px."""
    boxes = dets.boxes.clone()
    wh = boxes[:, 0, 2:] - boxes[:, 0, :2]
    boxes[:, 0] += torch.cat([wh, wh], -1) + 16.0
    return dets._replace(boxes=boxes)


def _patch_detect(monkeypatch, fault):
    from yolov5_tpu_torch.infer import Detector

    inner = Detector.__call__
    monkeypatch.setattr(Detector, "__call__", lambda self, *a, **k: fault(inner(self, *a, **k)))


def _patch_val(monkeypatch, fault):
    from yolov5_tpu_torch.eval import evaluator

    inner = evaluator.non_max_suppression
    monkeypatch.setattr(evaluator, "non_max_suppression", lambda *a, **k: fault(inner(*a, **k)))


CELLS = {"yolov5s.detect-b32": _patch_detect, "yolov5x.val-b32": _patch_val}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    cell, result, line, ctx = _run(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["attempted"] > 0
    if "map_recomputed_gap" in line["checks"]:  # labels that the detections match
        assert [n["map"] for n in ctx.notes if "map" in n][0] > 0.1


@pytest.mark.parametrize("fault", [_half, _altered], ids=["half_batch", "answer_altered"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    CELLS[name](monkeypatch, fault)
    _, _, line, _ = _run(name)
    assert not line["correct"], line["checks"]


def _unscaled(monkeypatch):
    """Detections matched in the letterbox's pixels, labels in the image's."""
    from yolov5_tpu_torch.eval import evaluator

    monkeypatch.setattr(evaluator, "_scale_to_native", lambda boxes, lb_hw, native_hw: boxes.copy())


def _iou_shifted(monkeypatch):
    """Every IoU threshold of the matching 0.05 too high."""
    from yolov5_tpu_torch.eval import evaluator

    inner = evaluator.process_batch
    monkeypatch.setattr(evaluator, "process_batch", lambda d, lab, iouv: inner(d, lab, iouv + 0.05))


@pytest.mark.parametrize("fault", [_unscaled, _iou_shifted], ids=["no_native_scaling", "iou_shifted"])
def test_broken_matching_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, _, line, _ = _run("yolov5x.val-b32")
    assert not line["correct"], line["checks"]
    assert line["checks"]["map_recomputed_gap"]["value"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(name):
    """The reference in float8 in the program's place fails a limit."""
    cell = helpers.small_cell(name)
    ctx = helpers.Ctx(cell)
    d = spec.runner(cell.traffic["kind"]).Runner(ctx)
    try:
        d.prepare()
        readings = d.readings(d.control_outputs("fp8"), d.reference())
    finally:
        d.close()
    assert any(readings[k] > v for k, v in cell.limits.items()), readings
