"""CI smoke matrix of the port on generated data: the counterpart of
``tools/ci_smoke.py`` (the JAX package's, unchanged), the reference's
per-workload CI contract (.github/workflows/ci-testing.yml:89-143):

  models:   build every config of ``hub.list_models()`` on the device
  detect:   train 1 epoch -> val -> detect -> export ckpt
  segment:  train 1 epoch (scratch) -> its validation
  classify: train 2 epochs -> its validation's top-1

    python -m yolov5_tpu_torch.ci_smoke                 # on the card
    python -m yolov5_tpu_torch.ci_smoke --device cpu --imgsz 64

The data comes from ``data/synthetic.py`` (JPEGs: OpenCV writes and reads
them) in a temporary directory, removed at the end. On the card every
validation runs kernels K1 and K2. Exits non-zero on the first failure and
prints ``CI SMOKE PASSED`` last.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import yaml


def build_matrix(device):
    """Build every bundled config on ``device``; returns how many."""
    import torch

    from yolov5_tpu_torch.hub import list_models
    from yolov5_tpu_torch.models import DetectionModel, SegmentationModel

    built = 0
    for name in list_models():
        model = (SegmentationModel if "-seg" in name else DetectionModel)(name).to(device)
        params = list(model.parameters())
        assert sum(p.numel() for p in params) > 0, name
        assert all(p.device.type == torch.device(device).type for p in params), name
        built += 1
    print(f"[models] built {built} configs OK")
    return built


def _shapes_yaml(root, name, s, seed, segments=False):
    from yolov5_tpu_torch.data.synthetic import generate_shapes_dataset

    cfg = generate_shapes_dataset(Path(root) / name, n_images=16, img_size=s, seed=seed,
                                  splits=(("train", 1.0), ("val", 0.5)), segments=segments)
    path = Path(root) / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def detect_chain(root, s, device):
    """Train yolov5n for 1 epoch, then val, detect and export ckpt on its
    last.ckpt. Returns the val results."""
    from yolov5_tpu_torch.eval.evaluator import run as val_run
    from yolov5_tpu_torch.export import run as export_run
    from yolov5_tpu_torch.infer import run as detect_run
    from yolov5_tpu_torch.train.run import run as train_run

    data = _shapes_yaml(root, "det", s, seed=0)
    _, _, save_dir = train_run(data=str(data), cfg="yolov5n", epochs=1, batch_size=8, imgsz=s,
                               project=str(Path(root) / "runs"), name="det", exist_ok=True,
                               workers=2, noautoanchor=True, patience=0, device=device)
    last = Path(save_dir) / "last.ckpt"
    assert last.exists(), last
    print("[detect] 1-epoch train OK")
    r = val_run(data=str(data), weights=str(last), imgsz=s, batch_size=8, verbose=False,
                device=device)
    assert "map50" in r
    print(f"[detect] val OK (map50={r['map50']:.3f})")
    results, _ = detect_run(weights=str(last), source=str(Path(root) / "det" / "images" / "val"),
                            imgsz=s, project=str(Path(root) / "runs-detect"), verbose=False,
                            device=device)
    assert len(results)
    print(f"[detect] predict OK ({len(results)} images)")
    arts = export_run(weights=str(last), include=("ckpt",), imgsz=s, device=device)
    assert arts.get("ckpt"), arts
    print("[detect] export OK")
    return r


def segment_chain(root, s, device):
    """Train yolov5n-seg for 1 epoch from scratch, with its validation."""
    from yolov5_tpu_torch.train.run_segment import run as seg_run

    data = _shapes_yaml(root, "seg", s, seed=1, segments=True)
    _, results, save_dir = seg_run(data=str(data), cfg="yolov5n-seg", epochs=1, batch_size=8,
                                   imgsz=s, project=str(Path(root) / "runs-seg"), name="seg",
                                   exist_ok=True, workers=2, device=device)
    assert (Path(save_dir) / "last.ckpt").exists()
    print("[segment] 1-epoch train + val OK")
    return results


def classify_chain(root, s, device):
    """Train a yolov5n classifier for 2 epochs; returns its best top-1."""
    from yolov5_tpu_torch.data.synthetic import generate_classify_dataset
    from yolov5_tpu_torch.train.run_classify import run as cls_run

    generate_classify_dataset(Path(root) / "cls", n_per_class=8, img_size=s, seed=0)
    top1, save_dir = cls_run(data=str(Path(root) / "cls"), cfg="yolov5n", epochs=2,
                             batch_size=8, imgsz=s, project=str(Path(root) / "runs-cls"),
                             name="cls", exist_ok=True, device=device)
    assert (Path(save_dir) / "last.ckpt").exists()
    print(f"[classify] 2-epoch train OK (top1={top1:.3f})")
    return top1


def main(argv=None):
    from yolov5_tpu_torch.infer import resolve_device

    ap = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.ci_smoke")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--imgsz", type=int, default=96)
    opt = ap.parse_args(argv)
    device = resolve_device(opt.device, "ci_smoke")
    with tempfile.TemporaryDirectory(prefix="ci_smoke_") as root:
        build_matrix(device)
        detect_chain(root, opt.imgsz, device)
        segment_chain(root, opt.imgsz, device)
        classify_chain(root, opt.imgsz, device)
    print("CI SMOKE PASSED")
    return 0


if __name__ == "__main__":
    main()
