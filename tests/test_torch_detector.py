"""The whole serving slice: yolov5_tpu.infer.Detector and
yolov5_tpu_torch.infer.Detector on the same weights and the same uint8
batch (yolov5n, fp32 on the CPU), plus the port's import hygiene."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_same_detection_sets, random_state_dict
from yolov5_tpu.infer import Detector as JaxDetector
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.models.yolo import DetectionModel

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights_pt(tmp_path_factory):
    """A reference-format .pt of random yolov5n weights with non-trivial BN
    statistics and Detect biases near 0, so that NMS sees real candidates."""
    rng = np.random.default_rng(5)
    sd = random_state_dict(DetectionModel("yolov5n"), rng)
    for i in range(3):
        sd[f"model.24.m.{i}.bias"] = rng.normal(-1.0, 0.5, (255,)).astype(np.float32)
    path = tmp_path_factory.mktemp("w") / "yolov5n_random.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("imgsz", [64, 160])
def test_detector_matches_jax(weights_pt, imgsz):
    """Raw maps within 2e-3 (tests/test_full_model_parity.py); detections:
    equal valid counts, boxes within 1e-3 (tests/test_nms.py:298). Random
    weights give many scores that agree to ~1e-8, so candidates of
    near-equal score may trade places between the packages: detections are
    matched one to one rather than rank by rank."""
    jdet = JaxDetector(str(weights_pt), cfg="yolov5n", imgsz=imgsz)
    det = Detector(from_jax_variables(jdet.variables), cfg="yolov5n", imgsz=imgsz, device="cpu")
    ims = np.random.default_rng(imgsz).integers(0, 255, (2, imgsz, imgsz, 3)).astype(np.uint8)

    ref_maps = jdet._forward_maps(jdet._flat_params, jdet._prep_images(ims))
    maps = det.forward_maps(ims)
    for m, r in zip(maps, ref_maps):
        assert tuple(m.shape) == r.shape
        np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=2e-3)

    # a cap below the candidate count (504 at 64 px): yolov5_tpu then sorts
    # the levels' candidates globally, as the port always does
    kw = dict(conf_thres=0.01, max_nms=256, max_det=100)
    ref = jdet(ims, **kw)
    got = det(ims, **kw)
    assert int(got.valid.sum()) > 0
    assert_same_detection_sets(got, ref, atol=1e-3)


def test_detector_pt_weights_and_classes(weights_pt):
    """The port's own .pt path gives the same maps as the from-JAX weights,
    and a class filter keeps only the requested classes."""
    jdet = JaxDetector(str(weights_pt), cfg="yolov5n", imgsz=64)
    a = Detector(from_jax_variables(jdet.variables), cfg="yolov5n", imgsz=64, device="cpu")
    b = Detector(str(weights_pt), cfg="yolov5n", imgsz=64, device="cpu")
    ims = np.random.default_rng(1).integers(0, 255, (1, 64, 64, 3)).astype(np.uint8)
    for x, y in zip(a.forward_maps(ims), b.forward_maps(ims)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-4)
    dets = b(ims, conf_thres=0.01, classes=[0, 2])
    assert set(dets.classes[dets.valid].tolist()) <= {0, 2}


def test_detector_unfused_matches_jax(weights_pt):
    """Detector(fuse=False) runs the eval-mode model with its BN (no K2 on
    the stem) and gives the JAX Detector(fuse=False)'s decoded predictions
    on the same weights within 1e-4 of their largest value; folded weights
    refuse to run unfused."""
    from yolov5_tpu_torch.models.weights import fuse_conv_bn

    jdet = JaxDetector(str(weights_pt), cfg="yolov5n", imgsz=64, fuse=False)
    det = Detector(str(weights_pt), cfg="yolov5n", imgsz=64, device="cpu", fuse=False)
    assert det.fused is False and jdet.fused is False
    assert det.model.model[0].bn is not None and not det.model.model[0].stem
    ims = np.random.default_rng(9).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    ref = np.asarray(jdet._forward(jdet.variables, ims))
    got = det.forward(ims).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())
    assert Detector(str(weights_pt), cfg="yolov5n", imgsz=64, device="cpu").fused is True
    folded = fuse_conv_bn(det.model.state_dict())
    with pytest.raises(ValueError, match="BN-folded"):
        Detector(folded, cfg="yolov5n", imgsz=64, device="cpu", fuse=False)


def test_hub_load_takes_fuse():
    """hub.load and the named factories take fuse, as the JAX hub does."""
    from yolov5_tpu_torch import hub

    det = hub.load("yolov5n", imgsz=64, fuse=False, device="cpu")
    assert det.fused is False and det.model.model[0].bn is not None
    assert hub.yolov5n(imgsz=64, fuse=False, device="cpu").fused is False
    assert hub.yolov5n(imgsz=64, device="cpu").fused is True


def test_detector_bf16_runs_and_warmup():
    det = Detector(cfg="yolov5n", imgsz=64, half=True, device="cpu")
    det.warmup(batch_size=1)
    maps = det.forward_maps(np.zeros((1, 64, 64, 3), np.uint8))
    assert maps[0].dtype == torch.bfloat16 and torch.isfinite(maps[0].float()).all()


def test_detector_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(cfg="yolov5n", imgsz=64, device="cuda")


def test_detector_defaults_to_the_card():
    """Without ``device`` the Detector runs on CUDA, so on a machine without
    a card it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(cfg="yolov5n", imgsz=64)


def test_port_imports_no_jax():
    """yolov5_tpu_torch and chip_smoke load neither JAX nor yolov5_tpu, nor, on
    import, OpenCV or PIL."""
    code = ("import sys, yolov5_tpu_torch, yolov5_tpu_torch.infer, "
            "yolov5_tpu_torch.data.letterbox, yolov5_tpu_torch._build, chip_smoke, "
            "yolov5_tpu_torch.eval.evaluator, yolov5_tpu_torch.data.dataset, "
            "yolov5_tpu_torch.utils.checkpoint, yolov5_tpu_torch.val, "
            "yolov5_tpu_torch.detect, yolov5_tpu_torch.segment, yolov5_tpu_torch.serve, "
            "yolov5_tpu_torch.hub, yolov5_tpu_torch.results, yolov5_tpu_torch.infer_segment, "
            "yolov5_tpu_torch.data.sources, yolov5_tpu_torch.ops.masks, "
            "yolov5_tpu_torch.utils.net, yolov5_tpu_torch.utils.font, "
            "yolov5_tpu_torch.data.cv, yolov5_tpu_torch.data.augment, "
            "yolov5_tpu_torch.train.run, yolov5_tpu_torch.train.prefetch, "
            "yolov5_tpu_torch.train.evolve, yolov5_tpu_torch.train.run_segment, "
            "yolov5_tpu_torch.eval.rle, yolov5_tpu_torch.ops.rasterize, "
            "yolov5_tpu_torch.parallel.distributed, yolov5_tpu_torch.parallel.mesh, "
            "yolov5_tpu_torch.utils.loggers, yolov5_tpu_torch.utils.plots, "
            "yolov5_tpu_torch.train.hpo, yolov5_tpu_torch.hpo, "
            "yolov5_tpu_torch.train.run_classify, yolov5_tpu_torch.classify\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'yolov5_tpu', 'cv2', 'PIL')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_chip_smoke_refuses_without_card(tmp_path):
    """Without CUDA, or alone in a directory, chip_smoke exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
