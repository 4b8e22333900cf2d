"""The import check, the run without a card, and the window arithmetic."""

from __future__ import annotations

import math
import subprocess
import sys

import pytest

from perfbench.core import env, spec, stats


def test_import_check_compares_whole_top_level_names():
    found = env.forbidden_modules({"jax.numpy": 1, "yolov5_tpu.ops.nms": 1, "tensorflow": 1,
                                   "yolov5_tpu_torch.infer": 1, "jaxtyping": 1, "flax": 1})
    assert found == ["flax", "jax", "tensorflow", "yolov5_tpu"]
    assert env.forbidden_modules({"yolov5_tpu_torch": 1, "yolov5_tpu_torch.ops": 1}) == []


def test_run_without_a_card_prints_no_result():
    """This machine has no CUDA card: the run exits 1 and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           spec.benchmark()["workloads"][0]["name"], "--seed", "3000000000",
                           "--seconds", "1"], cwd=spec.ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "no result" in proc.stderr


def test_window_rate_is_all_work_over_all_time():
    ticks = iter([0.0, 0.4, 1.0, 1.7, 2.6])
    w = stats.Window(lambda: next(ticks), 2.0)
    assert not w.done(32) and not w.done(32) and not w.done(32)
    assert w.done(16)  # the first completion at or past 2 s closes the window
    assert w.units == 112 and w.events == 4
    assert w.rate == pytest.approx(112 / 2.6)


def test_percentile_takes_every_request():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs[:95] + [None] * 5, 95) == math.inf  # failures are late
    assert stats.percentile([3.0], 95) == 3.0


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [100.0, 101.0, 99.0, 100.5, 99.5, 100.0]
    q1, q2, q3 = __import__("statistics").quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)
