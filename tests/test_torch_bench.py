"""The port's benchmark entry points on the CPU at yolov5n 64 px:
``yolov5_tpu_torch.bench`` (one JSON line last, in the root ``bench.py``'s
schema, with the CPU run's metric named apart from the card's) and
``yolov5_tpu_torch.benchmarks`` (every available export format through its
parity gate against the native forward, the unavailable ones reported, val
rows with the mAP floor), and that neither these nor any module of the port
imports JAX or the JAX package."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from yolov5_tpu_torch import bench, benchmarks

REPO = Path(__file__).resolve().parents[1]
EXTRAS = {"mfu_pct", "gflops_per_img", "device_ms_per_img", "with_dispatch_img_s",
          "with_dispatch_ms_per_img", "with_dispatch_over_device", "serve_e2e_nms_img_s",
          "serve_e2e_nms_ms_per_img", "nms_ms_per_img_p50", "nms_eval30k_ms_per_img_p50",
          "train_img_s", "train_ms_per_img", "train_vs_v100_300ep_2d", "batch", "device",
          "kernels"}


def test_bench_cpu_line(capsys):
    """One well-formed JSON line last: the root bench.py's keys, the metric
    with a _cpu suffix, every extras key, finite positive rates, no MFU and
    the CPU as the device."""
    res = bench.main(cfg="yolov5n", imgsz=64, batch=2, k=2, device="cpu", dtype="float32")
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line == json.loads(json.dumps(res))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert line["metric"] == "yolov5n_64_f32_images_per_sec_per_chip_b2_cpu"
    assert line["unit"] == "img/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / (1000 / 0.9))
    ex = line["extras"]
    assert set(ex) == EXTRAS
    assert ex["mfu_pct"] is None and ex["batch"] == 2
    assert ex["device"]["platform"] == "cpu" and ex["device"]["power_limit_w"] is None
    assert ex["kernels"] == {"greedy_nms": 0, "stem_conv": 0}  # plain versions on the CPU
    for k in EXTRAS - {"mfu_pct", "batch", "device", "kernels"}:
        assert np.isfinite(ex[k]) and ex[k] > 0, k
    assert ex["device_ms_per_img"] == pytest.approx(1000 / line["value"])
    assert ex["gflops_per_img"] == pytest.approx(0.0447, rel=0.02)  # yolov5n at 64 px


def test_entry_points_raise_without_a_card():
    """Without --device cpu each entry point runs on the card, and raises
    where there is none (no quiet fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolov5_tpu_torch import ci_smoke

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.cli(["--cfg", "yolov5n", "--imgsz", "64", "--batch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.main(["--cfg", "yolov5n", "--imgsz", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ci_smoke.main(["--imgsz", "64"])
    with pytest.raises(ValueError, match="dtype"):
        bench.main(cfg="yolov5n", imgsz=64, batch=1, device="cpu", dtype="float16")


def test_fp_gate():
    """The gate passes a close copy and fails a shifted, a decorrelated or a
    misshapen output."""
    ref = np.random.default_rng(0).uniform(0, 640, (1, 252, 8)).astype(np.float32)
    assert benchmarks.fp_gate(ref + 0.5, ref)[0]
    shifted = ref.copy()
    shifted[0, 7, :4] += 4.0
    ok, diff, _ = benchmarks.fp_gate(shifted, ref)
    assert not ok and diff == pytest.approx(4.0, abs=1e-3)
    small = ref / 640  # every difference under 3, but no correlation left
    shuffled = np.random.default_rng(1).permutation(small.ravel()).reshape(ref.shape)
    ok, diff, corr = benchmarks.fp_gate(shuffled, small)
    assert not ok and diff < 3 and abs(corr) < 0.1
    assert benchmarks.fp_gate(ref[:, :100], ref) == (False, -1.0, -1.0)


@pytest.fixture(scope="module")
def shapes_yaml(tmp_path_factory):
    from yolov5_tpu_torch.data.synthetic import generate_shapes_dataset

    root = tmp_path_factory.mktemp("bm_data")
    cfg = generate_shapes_dataset(root / "shapes", n_images=4, img_size=64, seed=2,
                                  splits=(("train", 1.0), ("val", 1.0)))
    path = root / "shapes.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_benchmarks_formats_and_val_rows(tmp_path, shapes_yaml, capsys):
    """Every available format passes its gate, the TensorFlow rows (the JAX
    package's saved_model, pb (frozen graph), tflite and tflite-int8) where
    TensorFlow is installed, else reported unavailable with the reason,
    never as failures; with --data and --hard-fail one val row per format
    Detector opens (native, the fused ckpt, the onnx) and the floor
    assertion passes."""
    import importlib.util

    from yolov5_tpu_torch.export import export_formats

    rows = benchmarks.main(["--cfg", "yolov5n", "--imgsz", "64", "--device", "cpu",
                            "--output-dir", str(tmp_path), "--data", str(shapes_yaml),
                            "--hard-fail", "-1"])
    out = capsys.readouterr().out
    assert "mAP floor -1.0 passed for all 3 validated formats" in out
    by = {r["format"]: r for r in rows}
    for fmt in ("torch (native)", "ckpt (fused)", "pt2", "onnx (port runtime)"):
        assert by[fmt]["ok"] and by[fmt]["max_abs_diff"] < 1e-3 and by[fmt]["ms"] > 0, fmt
    assert by["onnx (cv2.dnn)"]["ok"] or "unavailable" in by["onnx (cv2.dnn)"]["note"]
    for name, _, ok, note in export_formats():
        if not ok:
            assert by[name]["note"] == f"unavailable: {note}" and not by[name]["ok"]
    if importlib.util.find_spec("tensorflow") is not None:
        for fmt in ("saved_model", "pb (frozen graph)", "tflite"):
            assert by[fmt]["ok"] and by[fmt]["max_abs_diff"] < 1e-3 and by[fmt]["ms"] > 0, fmt
        assert by["tflite-int8"]["ok"] and by["tflite-int8"]["obj_corr"] > 0.9
        assert np.isfinite(by["tflite-int8"]["max_abs_diff"])
    else:
        assert by["saved_model"]["note"] == "unavailable: tensorflow not installed"
    assert sorted(f for f in by if f.startswith("val (")) == [
        "val (ckpt)", "val (native)", "val (onnx)"]
    maps = [by[f"val ({f})"]["map50_95"] for f in ("native", "ckpt", "onnx")]
    assert all(np.isfinite(m) and m >= 0 for m in maps)
    assert json.loads(out[out.index("["):out.index("]\n") + 1]) == json.loads(json.dumps(rows))


def test_benchmarks_hard_fail_floor(tmp_path, shapes_yaml):
    """A floor above what the weights reach fails, naming the formats."""
    with pytest.raises(AssertionError, match="below the mAP floor 0.5"):
        benchmarks.run(cfg="yolov5n", imgsz=64, device="cpu", output_dir=str(tmp_path),
                       data=str(shapes_yaml), hard_fail=0.5)


def test_port_never_imports_jax():
    """No module of yolov5_tpu_torch imports jax, flax or yolov5_tpu (a grep
    of the package's sources), and the new entry points load none of them
    (nor OpenCV) on import."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|yolov5_tpu)(\.|\s|$)", re.M)
    bad = [str(p.relative_to(REPO)) for p in (REPO / "yolov5_tpu_torch").rglob("*.py")
           if pat.search(p.read_text())]
    assert not bad, bad
    code = ("import sys, yolov5_tpu_torch.bench, yolov5_tpu_torch.benchmarks, "
            "yolov5_tpu_torch.ci_smoke, yolov5_tpu_torch.data.synthetic, "
            "yolov5_tpu_torch.ops, yolov5_tpu_torch.models\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'yolov5_tpu', 'cv2')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
