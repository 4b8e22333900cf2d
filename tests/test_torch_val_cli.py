"""python -m yolov5_tpu_torch.val against the root val.py: the same JSON
result line (keys, and metrics within 1e-4) on the same .ckpt and data."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from tests.torch_port_helpers import save_jax_checkpoint, write_shapes_dataset, yolov5n_cfg

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = write_shapes_dataset(root / "data", [(48, 64), (64, 48), (64, 64), (40, 64)] * 2,
                                ext=".bmp")
    (root / "data.yaml").write_text(yaml.safe_dump(data))
    save_jax_checkpoint(yolov5n_cfg(3), root / "best.ckpt")
    return root


def _cli(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_matches_root_val(case):
    common = ["--data", str(case / "data.yaml"), "--weights", str(case / "best.ckpt"),
              "--imgsz", "64", "--batch-size", "3", "--save-txt", "--exist-ok",
              "--project", str(case / "runs")]
    port = _result(_cli(["-m", "yolov5_tpu_torch.val", "--device", "cpu", *common,
                         "--save-json", str(case / "port.json"), "--name", "port"], REPO))
    ref = _result(_cli([str(REPO / "val.py"), "--device", "cpu", *common,
                        "--save-json", str(case / "jax.json"), "--name", "jax"], REPO))
    assert port.keys() == ref.keys()
    assert {"mp", "mr", "map50", "map", "fitness", "speed_ms", "images", "json", "coco",
            "save_dir"} <= port.keys()
    assert port["images"] == ref["images"] == 8
    for k in ("map50", "map"):
        assert abs(port[k] - ref[k]) <= 1e-4
    assert len(list(Path(port["save_dir"], "labels").glob("*.txt"))) == 8


def test_cli_speed_task(case):
    res = _result(_cli(["-m", "yolov5_tpu_torch.val", "--device", "cpu", "--task", "speed",
                        "--data", str(case / "data.yaml"), "--weights", str(case / "best.ckpt"),
                        "--imgsz", "64", "--no-verbose"], REPO))
    assert res["images"] == 8 and res["speed_total_ms"] > 0


def test_cli_without_card_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli(["-m", "yolov5_tpu_torch.val", "--data", str(case / "data.yaml"),
                 "--imgsz", "64"], REPO)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert '"map50"' not in proc.stdout
