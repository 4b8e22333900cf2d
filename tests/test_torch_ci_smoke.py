"""The port's CI smoke matrix (``yolov5_tpu_torch.ci_smoke``) on the CPU at
64 px: its build matrix covers every config of the JAX package's zoo, the
detect chain (train 1 epoch, val, detect, export ckpt) writes what it
should, and the whole matrix passes and prints ``CI SMOKE PASSED`` last."""

import torch

from yolov5_tpu.models.yolo import CONFIG_DIR as JAX_CONFIG_DIR
from yolov5_tpu_torch import ci_smoke

CPU = torch.device("cpu")


def test_build_matrix_covers_the_jax_zoo(capsys):
    built = ci_smoke.build_matrix(CPU)
    jax_models = [p for p in JAX_CONFIG_DIR.glob("*.yaml") if p.stem != "anchors"]
    assert built == len(jax_models) == 28
    assert "[models] built 28 configs OK" in capsys.readouterr().out


def test_detect_chain(tmp_path, capsys):
    r = ci_smoke.detect_chain(tmp_path, 64, CPU)
    assert {"map50", "map", "mp", "mr"} <= set(r)
    run = tmp_path / "runs" / "det"
    assert (run / "last.ckpt").exists() and (run / "last.fused.ckpt").exists()
    assert len(list((tmp_path / "det" / "images" / "val").glob("*.jpg"))) == 8
    out = capsys.readouterr().out
    for step in ("1-epoch train OK", "val OK", "predict OK (8 images)", "export OK"):
        assert f"[detect] {step}" in out


def test_ci_smoke_main_passes(capsys):
    assert ci_smoke.main(["--device", "cpu", "--imgsz", "64"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "CI SMOKE PASSED"
    marks = [line.split("]")[0] + "]" for line in out if line.startswith("[")]
    assert marks == ["[models]"] + ["[detect]"] * 4 + ["[segment]", "[classify]"]
