"""Hub-style model loading (the reference hubconf.py equivalent), the port
of ``yolov5_tpu/hub.py``.

    import yolov5_tpu_torch.hub as hub
    det = hub.load("yolov5s")                      # seeded random weights
    det = hub.load("path/to/best.ckpt")            # trained checkpoint
    det = hub.load("yolov5s.pt", cfg="yolov5s")    # torch reference weights
    seg = hub.load("yolov5s-seg", task="segment")  # SegmentationModel
    cls = hub.load("yolov5s", task="classify")     # ClassificationModel
    cls = hub.load("best.ckpt", task="classify")   # a classifier checkpoint

No weight downloads happen here; point ``load`` at local files.
``list_models()`` enumerates the bundled config zoo. Everything runs on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from yolov5_tpu_torch.models.yolo import CONFIG_DIR


def list_models():
    """The bundled model configs (anchors.yaml, a table of anchor presets,
    is not one)."""
    return sorted(p.stem for p in CONFIG_DIR.glob("*.yaml") if p.stem != "anchors")


def load(name_or_path="yolov5s", cfg=None, imgsz=640, half=False, fuse=True, task="detect",
         device="cuda"):
    """A ready ``infer.Detector`` (BN folded unless ``fuse`` is False), or
    for ``task="segment"`` an eval-mode ``SegmentationModel`` on ``device``,
    or for ``task="classify"`` an eval-mode ``ClassificationModel``: seeded
    random weights for a config name, BN folded from a ``.ckpt``/``.pt``
    path (``fuse`` is for the Detector only, as in the JAX package). (The
    JAX package hands every ``.ckpt``/``.pt`` path to its Detector, whatever
    the task.)"""
    s = str(name_or_path)
    if task == "classify":
        from yolov5_tpu_torch.infer import resolve_device
        from yolov5_tpu_torch.models.yolo import ClassificationModel
        from yolov5_tpu_torch.train.run_classify import load_classifier

        if s.endswith((".ckpt", ".pt")):
            return load_classifier(s, cfg=cfg or "yolov5s", device=device)[0]
        return ClassificationModel(cfg or s).to(resolve_device(device, "hub.load")).eval()
    if task == "detect" or s.endswith((".ckpt", ".pt")):
        from yolov5_tpu_torch.infer import Detector

        if s.endswith((".ckpt", ".pt")):
            return Detector(s, cfg=cfg or "yolov5s", imgsz=imgsz, half=half, device=device,
                            fuse=fuse)
        return Detector(None, cfg=s, imgsz=imgsz, half=half, device=device, fuse=fuse)
    if task == "segment":
        from yolov5_tpu_torch.infer import resolve_device
        from yolov5_tpu_torch.models.yolo import SegmentationModel

        return SegmentationModel(cfg or s).to(resolve_device(device, "hub.load")).eval()
    raise ValueError(f"unknown task {task}")


# torch.hub-style named factories
def _factory(name):
    def f(weights="", imgsz=640, **kw):
        return load(weights or name, cfg=name, imgsz=imgsz, **kw)

    f.__name__ = name.replace("-", "_")
    return f


for _n in ("yolov5n", "yolov5s", "yolov5m", "yolov5l", "yolov5x",
           "yolov5n6", "yolov5s6", "yolov5m6", "yolov5l6", "yolov5x6"):
    globals()[_n] = _factory(_n)
