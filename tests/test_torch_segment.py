"""Segmentation predict of yolov5_tpu_torch against the JAX package
(yolov5n-seg, f32, on the CPU, the same weights): the model's maps and
prototypes, the weight keys of the Segment head, the mask ops, the numpy
border follower against cv2.findContours, and infer_segment.run and its CLI."""

import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolov5_tpu.infer_segment as jax_seg
from tests.torch_port_helpers import (random_segmenter_weights, save_jax_checkpoint, seg_cfg,
                                      write_shapes_dataset)
from yolov5_tpu.models import SegmentationModel as JaxSegmentationModel
from yolov5_tpu.models.weights import import_torch_weights
from yolov5_tpu.models.weights import torch_key_to_flax as jax_torch_key_to_flax
from yolov5_tpu.ops import masks as jax_masks
from yolov5_tpu_torch import infer_segment
from yolov5_tpu_torch.models.weights import (from_jax_variables, fuse_conv_bn, load_weights,
                                             to_jax_variables, torch_key_to_flax)
from yolov5_tpu_torch.models.yolo import SegmentationModel
from yolov5_tpu_torch.ops import masks

REPO = Path(__file__).resolve().parents[1]
CFG = seg_cfg(3)


@pytest.fixture(scope="module")
def weights():
    """Random yolov5n-seg weights in the reference torch layout, and the JAX
    model's variables imported from them."""
    sd = random_segmenter_weights(CFG, 3)
    jm = JaxSegmentationModel(CFG)
    variables, missed = import_torch_weights(jm, sd)
    assert not missed
    return sd, jm, variables


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("imgsz", [64, 96])
def test_segmentation_model_matches_jax(weights, imgsz):
    """Maps and proto of the unfused and of the BN-folded port model against
    the JAX model's (unfused, as infer_segment runs it), within 1e-4 of each
    tensor's largest value; proto is (bs, hm, wm, nm), a view of the
    channels_last Proto output."""
    sd, jm, variables = weights
    x = np.random.default_rng(imgsz).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    ref_maps, ref_proto = jm.apply(variables, jnp.asarray(x), train=False)
    for fused in (False, True):
        model = SegmentationModel(CFG, fused=fused).eval()
        state = from_jax_variables(variables)
        assert not load_weights(model, fuse_conv_bn(state) if fused else state)
        assert model.model[0].stem == fused  # the folded stem is K2's
        with torch.no_grad():
            maps, proto = model(_nchw(x))
        assert proto.shape == (2, imgsz // 4, imgsz // 4, 32)
        assert proto.is_contiguous()
        for got, ref in [*zip(maps, ref_maps), (proto, ref_proto)]:
            ref = np.asarray(ref)
            assert got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert model.nm == 32 and model.stride == (8, 16, 32)


def test_segment_head_weight_keys(weights, tmp_path):
    """The Segment head's keys (model.24.m.{i}, model.24.proto.cv{1,2,3})
    map to the JAX paths as the JAX package maps them, survive
    to_jax_variables -> from_jax_variables, fold (no BN left), and a .pt
    in the reference layout loads into the Segmenter directly."""
    sd, _, variables = weights
    keys = [k for k in sd if k.startswith("model.24.")]
    assert {"model.24.proto.cv1.conv.weight", "model.24.proto.cv3.bn.running_var",
            "model.24.m.2.bias"} <= set(keys)
    for k in keys:
        coll, path, _ = jax_torch_key_to_flax(k)
        assert torch_key_to_flax(k) == (coll, path)
    state = from_jax_variables(variables)
    assert set(state) == set(sd)
    back = from_jax_variables(to_jax_variables(state))
    for k in state:
        np.testing.assert_array_equal(back[k].numpy(), state[k].numpy())
    fused = fuse_conv_bn(state)
    assert not [k for k in fused if ".bn." in k] and "model.24.proto.cv2.conv.bias" in fused
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "seg.pt")
    seg = infer_segment.Segmenter(str(tmp_path / "seg.pt"), cfg=CFG, device="cpu")
    x = np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3), dtype=np.uint8)
    seg2 = infer_segment.Segmenter(state, cfg=CFG, device="cpu")
    for a, b in zip(seg.forward(x), seg2.forward(x)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_segmentation_model_rejects_a_detect_config():
    with pytest.raises(ValueError, match="Detect head"):
        SegmentationModel("yolov5n")


# ---------------------------------------------------------------------------
# mask ops
# ---------------------------------------------------------------------------

def _mask_case(seed, n=5, hm=24, wm=32, nm=8):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (hm, wm, nm)).astype(np.float32)
    coeffs = rng.normal(0, 1, (n, nm)).astype(np.float32)
    xy = rng.uniform(-10, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], 1).astype(np.float32)
    return protos, coeffs, boxes


def test_crop_mask_matches_jax():
    from yolov5_tpu.train.loss import crop_mask as jax_crop_mask

    rng = np.random.default_rng(0)
    m = rng.uniform(0, 1, (6, 20, 30)).astype(np.float32)
    boxes = np.array([[0, 0, 30, 20], [3.5, 2.2, 10.5, 9.9], [-5, -5, 4, 4], [29, 19, 40, 40],
                      [10, 10, 10, 10], [7, 3, 8, 4]], np.float32)
    got = masks.crop_mask(torch.from_numpy(m), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_crop_mask(jnp.asarray(m),
                                                                jnp.asarray(boxes))))


@pytest.mark.parametrize("upsample", [False, True])
def test_process_mask_matches_jax(upsample):
    protos, coeffs, boxes = _mask_case(1)
    got = masks.process_mask(torch.from_numpy(protos), torch.from_numpy(coeffs),
                             torch.from_numpy(boxes), (96, 128), upsample=upsample).numpy()
    ref = np.asarray(jax_masks.process_mask(jnp.asarray(protos), jnp.asarray(coeffs),
                                            jnp.asarray(boxes), (96, 128), upsample=upsample))
    assert got.shape == ref.shape == ((5, 96, 128) if upsample else (5, 24, 32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(masks.masks_to_binary(torch.from_numpy(got)).numpy(),
                                  np.asarray(jax_masks.masks_to_binary(ref)))


@pytest.mark.parametrize("case", ["pad", "resize", "single", "one", "ratio_pad"])
def test_scale_image_matches_jax(case):
    """scale_image (F.interpolate) against the JAX one (cv2.resize
    INTER_LINEAR) within 1e-5, shapes included: (h0, w0, n), or (h0, w0)
    for a 2D input or n = 1, as cv2.resize gives them."""
    rng = np.random.default_rng(2)
    m = {"pad": rng.uniform(0, 1, (64, 64, 3)), "resize": rng.uniform(0, 1, (64, 64, 4)),
         "single": rng.uniform(0, 1, (64, 64)), "one": rng.uniform(0, 1, (64, 64, 1)),
         "ratio_pad": rng.uniform(0, 1, (64, 64, 2))}[case].astype(np.float32)
    im0 = {"pad": (48, 64), "resize": (100, 75), "single": (30, 64), "one": (64, 40),
           "ratio_pad": (40, 64)}[case]
    ratio_pad = ((1.0, 1.0), (0.0, 12.0)) if case == "ratio_pad" else None
    got = masks.scale_image(m, im0, ratio_pad)
    ref = jax_masks.scale_image(m, im0, ratio_pad)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# masks2segments: the numpy border follower against cv2.findContours
# ---------------------------------------------------------------------------

def _named_masks():
    """Masks with several parts, holes, parts inside holes, edges touched,
    one-pixel parts, diagonal links, and nothing."""
    out = {}
    m = np.zeros((20, 24), np.uint8)
    m[2:8, 3:10] = 1
    m[12:18, 14:22] = 1
    m[5, 18] = 1
    out["parts"] = m
    m = np.zeros((21, 21), np.uint8)
    m[2:19, 2:19] = 1
    m[6:15, 6:15] = 0
    m[9:12, 9:12] = 1  # a part inside the hole: not an outer border
    out["hole"] = m
    out["edges"] = np.pad(np.ones((6, 8), np.uint8), ((0, 4), (3, 0)))
    out["full"] = np.ones((7, 9), np.uint8)
    out["pixels"] = (np.arange(81).reshape(9, 9) % 7 == 0).astype(np.uint8)
    out["diagonal"] = np.eye(10, dtype=np.uint8)
    out["line"] = np.zeros((5, 12), np.uint8)
    out["line"][2, 1:11] = 1
    out["empty"] = np.zeros((16, 16), np.uint8)
    yy, xx = np.mgrid[:64, :80]
    out["ring"] = (((yy - 30) ** 2 + (xx - 40) ** 2 < 600)
                   & ((yy - 30) ** 2 + (xx - 40) ** 2 > 150)).astype(np.uint8)
    return out


def _assert_same_contours(m):
    ref = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
    got = masks.find_external_contours(m)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(_named_masks()))
def test_find_external_contours_equals_cv2(name):
    _assert_same_contours(_named_masks()[name])


@pytest.mark.parametrize("seed", range(8))
def test_find_external_contours_equals_cv2_on_random_masks(seed):
    """Noise, overlapping rectangles and discs with holes, at random sizes:
    every contour equal to cv2's, point for point and in its order."""
    rng = np.random.default_rng(seed)
    for t in range(60):
        h, w = rng.integers(1, 40, 2)
        kind = t % 3
        if kind == 0:
            m = rng.random((h, w)) < rng.uniform(0.1, 0.9)
        elif kind == 1:
            m = np.zeros((h, w), bool)
            for _ in range(rng.integers(0, 6)):
                y0, x0 = rng.integers(0, h), rng.integers(0, w)
                m[y0:y0 + rng.integers(1, 12), x0:x0 + rng.integers(1, 12)] ^= True
        else:
            yy, xx = np.mgrid[:h, :w]
            m = np.zeros((h, w), bool)
            for _ in range(rng.integers(1, 4)):
                cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(1, 12)
                m ^= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        _assert_same_contours(m.astype(np.uint8))


@pytest.mark.parametrize("strategy", ["largest", "concat"])
def test_masks2segments_matches_jax(strategy):
    named = _named_masks()
    stack = np.stack([np.pad(m, ((0, 64 - m.shape[0]), (0, 80 - m.shape[1])))
                      for m in named.values()]).astype(bool)
    got = masks.masks2segments(stack, strategy)
    ref = jax_masks.masks2segments(stack, strategy)
    assert len(got) == len(ref) == len(named)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_masks2segments_needs_no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    ring = _named_masks()["ring"]
    segs = masks.masks2segments(ring[None].astype(bool))
    assert len(segs) == 1 and len(segs[0]) > 20


# ---------------------------------------------------------------------------
# infer_segment.run and the CLI
# ---------------------------------------------------------------------------

IMGSZ = 128
CONF = 0.145  # 2-50 instances an image with these weights (OpenCV 5's resize,
# which the JAX run calls, takes at most 128 channels)


@pytest.fixture(scope="module")
def seg_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    write_shapes_dataset(root / "data", [(96, 128), (128, 96), (128, 128), (80, 128)],
                         ext=".bmp")
    save_jax_checkpoint(CFG, root / "seg.ckpt", weights=random_segmenter_weights)
    return root, root / "data" / "images" / "val"


def test_infer_segment_matches_jax(seg_case):
    """The same rows (boxes within 1e-3 px, scores within 1e-5, coefficients
    within 1e-4), binary masks equal but where the mask is within 1e-4 of
    0.5, the same polygon txts and images written at their sources' sizes."""
    root, src = seg_case
    kw = dict(weights=str(root / "seg.ckpt"), source=str(src), imgsz=IMGSZ, conf_thres=CONF,
              save_txt=True, project=str(root / "runs"), exist_ok=True, verbose=False)
    ref, ref_dir = jax_seg.run(name="jax", **kw)
    got, got_dir = infer_segment.run(name="port", device="cpu", **kw)
    assert [p for p, *_ in got] == [p for p, *_ in ref]
    assert [len(r) for _, r, _ in got] == [len(r) for _, r, _ in ref]
    assert sum(len(r) for _, r, _ in got) >= 10
    seg = infer_segment.Segmenter(str(root / "seg.ckpt"), device="cpu")
    for (path, a, ma), (_, b, mb) in zip(ref, got):
        if not len(a):
            assert ma is None and mb is None
            continue
        np.testing.assert_allclose(b[:, :4], a[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(b[:, 4], a[:, 4], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(b[:, 5], a[:, 5])
        np.testing.assert_allclose(b[:, 6:], a[:, 6:], rtol=0, atol=1e-4)
        assert mb.dtype == bool and mb.shape == ma.shape == (len(a), IMGSZ, IMGSZ)
        # the port's continuous masks, to find the pixels at the 0.5 edge
        im = cv2.imread(path)
        from yolov5_tpu_torch.data.letterbox import letterbox

        _, proto = seg.forward(letterbox(im, IMGSZ)[0][None, ..., ::-1].copy())
        soft = masks.process_mask(proto[0], torch.from_numpy(b[:, 6:]),
                                  torch.from_numpy(b[:, :4]), (IMGSZ, IMGSZ), True).numpy()
        differ = ma != mb
        assert not (differ & (np.abs(soft - 0.5) > 1e-4)).any()
    txts = sorted(p.name for p in (ref_dir / "labels").glob("*.txt"))
    assert txts == sorted(p.name for p in (got_dir / "labels").glob("*.txt"))
    for name in txts:
        assert (got_dir / "labels" / name).read_text() == (ref_dir / "labels" / name).read_text()
    for p in src.iterdir():
        assert cv2.imread(str(got_dir / p.name)).shape == cv2.imread(str(p)).shape


def test_segment_cli_predict(seg_case):
    """python -m yolov5_tpu_torch.segment predict --device cpu end to end:
    the polygon txts of infer_segment.run, and the root segment.py predict's
    image files."""
    root, src = seg_case
    common = ["--weights", str(root / "seg.ckpt"), "--source", str(src), "--imgsz", str(IMGSZ),
              "--conf-thres", str(CONF), "--project", str(root / "cli")]
    proc = subprocess.run([sys.executable, "-m", "yolov5_tpu_torch.segment", "predict",
                           "--device", "cpu", "--save-txt", *common, "--name", "port"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _, ref_dir = jax_seg.run(weights=str(root / "seg.ckpt"), source=str(src), imgsz=IMGSZ,
                             conf_thres=CONF, save_txt=True, project=str(root / "cli"),
                             name="jax", verbose=False)
    port_dir = root / "cli" / "port"
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in ref_dir.iterdir())
    for p in (ref_dir / "labels").glob("*.txt"):
        assert (port_dir / "labels" / p.name).read_text() == p.read_text()


@pytest.mark.parametrize("cmd", ["train", "val"])
def test_segment_cli_train_val_not_ported(cmd, seg_case):
    """train and val are ported now: each runs on the card by default and
    raises without one; train needs --data unless it resumes."""
    from yolov5_tpu_torch.segment import main, parse_opt

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, src = seg_case
    data = root / "seg.yaml"
    data.write_text(f"path: {root / 'data'}\nval: images/val\ntrain: images/val\nnc: 3\n")
    argv = [cmd, "--data", str(data), "--imgsz", "64"]
    if cmd == "val":
        argv += ["--weights", str(root / "seg.ckpt")]
    assert parse_opt(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    if cmd == "train":
        with pytest.raises(SystemExit):
            parse_opt(["train"])


def test_segmenter_defaults_to_the_card(seg_case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_segment.run(weights=str(seg_case[0] / "seg.ckpt"), source=str(seg_case[1]),
                          project=str(seg_case[0] / "nocard"))
