"""yolov5_tpu_torch.results and hub against the JAX package's: predict's
records on paths, numpy arrays and PIL images equal JAX's (boxes within
1e-3 px), the Results accessors, list_models, and hub.load for detect and
segment on an explicit device."""

import numpy as np
import pytest
import torch
from PIL import Image

import yolov5_tpu.hub as jax_hub
import yolov5_tpu.results as jax_results
import yolov5_tpu_torch.hub as hub
import yolov5_tpu_torch.results as results
from tests.torch_port_helpers import assert_same_records, save_jax_checkpoint, yolov5n_cfg
from yolov5_tpu_torch.data.imageio import imwrite
from yolov5_tpu_torch.infer import Detector
from yolov5_tpu_torch.models.yolo import ClassificationModel, SegmentationModel

IMGSZ = 192  # above the from-maps NMS's 2048-candidate cap (ROADMAP, Open items 3)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("results")
    ckpt = save_jax_checkpoint(yolov5n_cfg(3), root / "best.ckpt")
    rng = np.random.default_rng(0)
    ims = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in
           ((144, 192), (192, 160), (192, 192))]
    imwrite(root / "a.bmp", ims[0])
    sources = [str(root / "a.bmp"), ims[1][..., ::-1].copy(),
               Image.fromarray(ims[2][..., ::-1].copy())]
    return root, ckpt, sources


def test_predict_records_match_jax(case):
    _, ckpt, sources = case
    ref = jax_results.predict(jax_hub.load(str(ckpt), imgsz=IMGSZ), sources, conf_thres=0.3)
    got = results.predict(hub.load(str(ckpt), imgsz=IMGSZ, device="cpu"), sources,
                          conf_thres=0.3)
    assert len(got) == len(ref) == 3
    for a, b in zip(got.records(), ref.records()):
        assert len(a) > 0
        assert_same_records(a, b)
    for im, rim in zip(got.images, ref.images):
        np.testing.assert_array_equal(im, rim)


def test_results_accessors(case, tmp_path, capsys):
    _, ckpt, sources = case
    r = results.predict(Detector(str(ckpt), imgsz=IMGSZ, device="cpu"), sources,
                        conf_thres=0.3)
    r.print()
    out = capsys.readouterr().out
    assert "image 0: 192x144" in out and "speed:" in out
    frames = r.pandas()
    assert [len(f) for f in frames] == [len(x) for x in r.records()]
    assert list(frames[0].columns) == ["xmin", "ymin", "xmax", "ymax", "confidence", "class",
                                       "name"]
    rendered = r.render()
    assert [x.shape for x in rendered] == [x.shape for x in r.images]
    assert any((a != b).any() for a, b in zip(rendered, r.images))
    d = r.save(tmp_path / "saved")
    assert sorted(p.name for p in d.iterdir()) == ["image0.jpg", "image1.jpg", "image2.jpg"]
    # cv2.imwrite refuses an empty image, here as in the JAX package: keep
    # the boxes that cut at least one pixel
    r.rows = [x[(x[:, 2].astype(int) > x[:, 0].astype(int))
                & (x[:, 3].astype(int) > x[:, 1].astype(int))] for x in r.rows]
    crops = r.crop(tmp_path / "crops")
    assert len(crops) == sum(len(x) for x in r.records())
    assert len(list((tmp_path / "crops").rglob("*.jpg"))) == len(crops)


def test_list_models_matches_jax():
    """The JAX package's list but anchors.yaml, a table of anchor presets
    that no hub.load can build (ROADMAP §3)."""
    assert hub.list_models() == [m for m in jax_hub.list_models() if m != "anchors"]
    assert {"yolov5s", "yolov5n-seg"} <= set(hub.list_models())


def test_hub_load_detect_and_segment(case):
    _, ckpt, _ = case
    det = hub.yolov5n(imgsz=64, device="cpu")
    assert isinstance(det, Detector) and det.imgsz == 64 and det.device.type == "cpu"
    assert hub.load(str(ckpt), device="cpu").names == {0: "class0", 1: "class1", 2: "class2"}
    seg = hub.load("yolov5n-seg", task="segment", device="cpu")
    assert isinstance(seg, SegmentationModel) and not seg.training
    x = torch.zeros(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        maps, proto = seg(x)
    assert maps[0].shape[-1] == 5 + 80 + 32 and proto.shape == (1, 16, 16, 32)
    cls = hub.load("yolov5n", task="classify", device="cpu")
    assert isinstance(cls, ClassificationModel) and not cls.training and cls.nc == 1000
    with pytest.raises(ValueError, match="unknown task"):
        hub.load("yolov5s", task="pose", device="cpu")


def test_hub_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for kw in ({}, {"task": "segment"}, {"task": "classify"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hub.load("yolov5n-seg" if kw else "yolov5n", **kw)
