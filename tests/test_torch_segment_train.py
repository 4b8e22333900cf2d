"""The segmentation training side of yolov5_tpu_torch against the JAX package
(yolov5n-seg, f32, on the CPU): the device rasterizer, the loader's mask
batches and host rasterizer, the device cache's polygons, the deterministic
core of the segmentation device augmentation, ComputeSegmentLoss, one train
step, and ``segment train`` then ``segment val`` end to end without OpenCV.

Tolerances: masks and rasterized pixels equal; polygon areas within 1e-6
of the shoelace terms' magnitudes (the sums run in another order); warped labels within
1e-4 px; loss components within 1e-5 relative and seg_overflow equal; one
train step's detection losses within 1e-5 relative, its mask loss and total
within 1e-4 and the updated parameters within 5e-5 of each tensor's largest
value (f32 convolutions summed in other orders: see the test)."""

import copy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_port_helpers import random_state_dict, seg_cfg, write_polygon_dataset
from yolov5_tpu.data import dataset as jax_dataset
from yolov5_tpu.data import device_aug as jax_aug
from yolov5_tpu.data import device_cache as jax_cache
from yolov5_tpu.models import SegmentationModel as JaxSegmentationModel
from yolov5_tpu.models.weights import import_torch_weights
from yolov5_tpu.ops import rasterize as jax_raster
from yolov5_tpu.train import loss as jax_loss
from yolov5_tpu.train import optim as jax_optim
from yolov5_tpu.train import trainer as jax_trainer
from yolov5_tpu.utils.hyp import SCRATCH_LOW
from yolov5_tpu_torch.data import dataset, device_aug, device_cache
from yolov5_tpu_torch.models.weights import from_jax_variables
from yolov5_tpu_torch.models.yolo import SegmentationModel
from yolov5_tpu_torch.ops import rasterize
from yolov5_tpu_torch.train import loss, optim, trainer

REPO = Path(__file__).resolve().parents[1]
CFG = seg_cfg(3)
SHAPES = [(96, 128), (128, 96), (128, 128), (64, 128)]


def _polygons(rng, m, v, span, floor):
    """m star-shaped polygons of v vertices in a span x span frame (some
    reaching past its edges); floored like the training path's vertices."""
    c = rng.uniform(-0.1 * span, 1.1 * span, (m, 1, 2))
    r = rng.uniform(2, 0.4 * span, (m, 1, 1))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (m, v)), 1)
    rad = r[..., 0] * rng.uniform(0.4, 1.0, (m, v))
    p = np.stack([c[..., 0] + rad * np.cos(ang), c[..., 1] + rad * np.sin(ang)], -1)
    return (np.floor(p) if floor else p).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/rasterize.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["floored", "subpixel", "self_crossing"])
def test_rasterize_matches_jax(kind):
    """rasterize and rasterize_overlap pixel-equal to the JAX functions on
    star-shaped (floored or subpixel) and random self-crossing polygons,
    invalid slots among them; polygon_areas within 1e-6 of the sum of the
    shoelace terms' magnitudes where the polygon has all V vertices (the
    training path's case)."""
    rng = np.random.default_rng(["floored", "subpixel", "self_crossing"].index(kind))
    hm, wm, v = 40, 48, 32
    for _ in range(6):
        if kind == "self_crossing":
            poly = rng.uniform(-5, 52, (7, v, 2)).astype(np.float32)
        else:
            poly = _polygons(rng, 7, v, 48, kind == "floored")
        nv = np.where(rng.random(7) < 0.75, v, 0).astype(np.int32)
        jp, jn = jnp.asarray(poly), jnp.asarray(nv)
        tp, tn = torch.from_numpy(poly), torch.from_numpy(nv)
        np.testing.assert_array_equal(rasterize.rasterize(tp, tn, hm, wm).numpy(),
                                      np.asarray(jax_raster.rasterize(jp, jn, hm, wm)))
        np.testing.assert_array_equal(rasterize.rasterize_overlap(tp, tn, hm, wm).numpy(),
                                      np.asarray(jax_raster.rasterize_overlap(jp, jn, hm, wm)))
        full = nv == v
        # the shoelace terms' magnitudes: the scale of the sums' rounding
        p64 = poly.astype(np.float64)
        terms = np.abs(p64[..., 0] * np.roll(p64[..., 1], -1, 1)
                       - np.roll(p64[..., 0], -1, 1) * p64[..., 1]).sum(1)
        np.testing.assert_allclose(rasterize.polygon_areas(tp, tn).numpy()[full],
                                   np.asarray(jax_raster.polygon_areas(jp, jn))[full],
                                   rtol=0, atol=1e-6 * terms[full].max())


def test_rasterize_batches_and_short_polygons():
    """A batch dimension rasterizes image by image; a polygon with fewer
    vertices than V closes at its last real vertex and has its true area
    (the JAX function gives NaN there)."""
    rng = np.random.default_rng(3)
    poly = torch.from_numpy(_polygons(rng, 6, 16, 40, True)).reshape(2, 3, 16, 2)
    nv = torch.tensor([[16, 0, 16], [16, 16, 0]])
    both = rasterize.rasterize_overlap(poly, nv, 40, 40)
    for b in range(2):
        torch.testing.assert_close(both[b], rasterize.rasterize_overlap(poly[b], nv[b], 40, 40))
    square = torch.tensor([[[2.0, 2.0], [12.0, 2.0], [12.0, 12.0], [2.0, 12.0], [0.0, 0.0]]])
    assert float(rasterize.polygon_areas(square, torch.tensor([4]))) == 100.0
    m = rasterize.rasterize(square, torch.tensor([4]), 16, 16)[0]
    assert m[2:13, 2:13].all() and m.sum() == 11 * 11  # the outline is painted
    assert not rasterize.rasterize(square, torch.tensor([2]), 16, 16).any()


def test_densify_and_resample_match_jax():
    rng = np.random.default_rng(4)
    for n in (3, 7, 32, 50):
        pts = rng.uniform(0, 1, (n, 2)).astype(np.float32)
        for v in (16, 32):
            np.testing.assert_array_equal(rasterize.densify_polygon(pts, v),
                                          jax_raster.densify_polygon(pts, v))
            np.testing.assert_array_equal(rasterize.resample_polygon(pts, v),
                                          jax_raster.resample_polygon(pts, v))


# ---------------------------------------------------------------------------
# the loader's masks and the device cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [True, False])
def test_rasterize_masks_matches_jax(overlap):
    """The host rasterizer (cv.fill_poly and contour_area) against the JAX
    one (cv2.fillPoly and cv2.contourArea), overlapping polygons included."""
    rng = np.random.default_rng(5)
    for _ in range(10):
        n = int(rng.integers(1, 8))
        segs = [p for p in _polygons(rng, n, int(rng.integers(3, 40)), 128, False)]
        labels = np.zeros((n, 5), np.float32)
        got = dataset.rasterize_masks(segs, labels, 32, 32, 128, overlap=overlap)
        ref = jax_dataset.rasterize_masks(segs, labels, 32, 32, 128, overlap=overlap)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg_set")
    write_polygon_dataset(root, SHAPES * 3, split="train", seed=1)
    d = write_polygon_dataset(root, SHAPES * 2, split="val", seed=2)
    d["train"] = "images/train"
    path = root / "seg.yaml"
    path.write_text(yaml.safe_dump(d))
    return root, path


@pytest.mark.parametrize("overlap", [True, False])
def test_loader_mask_batches_match_jax(seg_data, overlap):
    """Validation batches with masks equal the JAX loader's; augmented
    training batches (mosaic, HSV, flips per seed) equal but for the host
    warp's one-level pixels: labels within 1e-4, masks equal on >= 99.5% of
    their pixels (a vertex that lands on a pixel edge may truncate the other
    way)."""
    root, _ = seg_data
    kw = dict(img_size=128, batch_size=4, workers=1, max_labels=16, masks=True, mask_ratio=4,
              overlap=overlap)
    _, val = dataset.create_loader(str(root / "images" / "val"), **kw)
    _, jval = jax_dataset.create_loader(str(root / "images" / "val"), **kw)
    for g, r in zip(val, jval):
        for k in ("images", "targets", "valid", "masks"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["masks"].shape == ((4, 32, 32) if overlap else (4, 16, 32, 32))
        assert g["masks"].any()
    hyp = dict(SCRATCH_LOW, fliplr=0.5, flipud=0.3)
    _, train = dataset.create_loader(str(root / "images" / "train"), augment=True, hyp=hyp,
                                     cache=False, seed=3, **kw)
    _, jtrain = jax_dataset.create_loader(str(root / "images" / "train"), augment=True,
                                          hyp=hyp, cache=False, seed=3, **kw)
    for g, r in zip(train, jtrain):
        np.testing.assert_allclose(g["targets"], r["targets"], atol=1e-4)
        np.testing.assert_array_equal(g["valid"], r["valid"])
        assert (g["masks"] == r["masks"]).mean() >= 0.995


def test_quad_with_masks_raises(seg_data):
    root, _ = seg_data
    with pytest.raises(ValueError, match="segmentation masks"):
        dataset.create_loader(str(root / "images" / "train"), img_size=96, batch_size=4,
                              augment=True, quad=True, masks=True)


def test_device_cache_segments_match_jax(seg_data):
    """Polygons densified to V vertices, content-normalised, float16, row j
    label j's; the byte count the same."""
    root, _ = seg_data
    ds = dataset.YOLODataset(str(root / "images" / "train"), img_size=96, augment=True)
    jds = jax_dataset.YOLODataset(str(root / "images" / "train"), img_size=96, augment=True)
    got = device_cache.build_cache_arrays(ds, 16, segments_v=32)
    ref = jax_cache.build_cache_arrays(jds, 16, segments_v=32)
    assert got["segments"].dtype == np.float16 and got["segments"].shape == (12, 16, 32, 2)
    for k in ("images", "hw", "targets", "valid", "segments"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (device_cache.cache_nbytes(ds, 16, segments_v=32)
            == jax_cache.cache_nbytes(jds, 16, segments_v=32))


# ---------------------------------------------------------------------------
# data/device_aug.py, segmentation side
# ---------------------------------------------------------------------------

def _mosaic_inputs(rng, bs=3, m=4, v=32, s=64):
    hw4 = np.stack([rng.integers(32, s + 1, (bs, 4)), rng.integers(32, s + 1, (bs, 4))],
                   -1).astype(np.float32)
    seg4 = rng.uniform(0, 1, (bs, 4, m, v, 2)).astype(np.float32)
    lo, hi = seg4.min(3), seg4.max(3)
    t4 = np.concatenate([rng.integers(0, 3, (bs, 4, m, 1)), (lo + hi) / 2, hi - lo],
                        -1).astype(np.float32)
    valid4 = rng.random((bs, 4, m)) < 0.8
    xc = rng.integers(s // 2, 3 * s // 2, bs).astype(np.float32)
    yc = rng.integers(s // 2, 3 * s // 2, bs).astype(np.float32)
    r = rng.uniform(0.5, 1.5, bs).astype(np.float32)
    t = (rng.uniform(0.4, 0.6, (bs, 2)) * s).astype(np.float32)
    return seg4, hw4, t4, valid4, xc, yc, r, t, s


def test_seg_mosaic_labels_match_jax():
    """The polygons through the separable warp, the boxes re-derived from
    them and the candidates filter, on forced draws."""
    rng = np.random.default_rng(6)
    for _ in range(4):
        args = _mosaic_inputs(rng)
        got = device_aug._seg_mosaic_labels(*[torch.from_numpy(a) for a in args[:-1]], args[-1])
        ref = jax_aug._seg_mosaic_labels(*[jnp.asarray(a) for a in args[:-1]], args[-1])
        s = args[-1]
        np.testing.assert_allclose(got[0].numpy() * s, np.asarray(ref[0]) * s, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy() * s, np.asarray(ref[1]) * s, atol=1e-4)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        assert 0 < got[2].sum() < got[2].numel()


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_seg_flips_match_jax(p):
    """Images, labels and polygons flipped (p = 1) or not (p = 0) as the JAX
    functions flip them."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    targets = rng.uniform(0, 1, (2, 5, 5)).astype(np.float32)
    segments = rng.uniform(0, 1, (2, 5, 8, 2)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for port, jax_fn in ((device_aug.random_flip_lr_seg, jax_aug.random_flip_lr_seg),
                         (device_aug.random_flip_ud_seg, jax_aug.random_flip_ud_seg)):
        got = port(*[torch.from_numpy(a) for a in (images, targets, segments)], gen, p)
        ref = jax_fn(*[jnp.asarray(a) for a in (images, targets, segments)],
                     jax_aug.jax.random.PRNGKey(0), p)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("overlap", [True, False])
def test_rasterize_batch_masks_matches_jax(overlap):
    rng = np.random.default_rng(8)
    segs = (_polygons(rng, 2 * 6, 32, 40, False) / np.float32(40)).reshape(2, 6, 32, 2)
    valid = rng.random((2, 6)) < 0.7
    got = device_aug.rasterize_batch_masks(torch.from_numpy(segs), torch.from_numpy(valid),
                                           24, 20, overlap=overlap)
    ref = jax_aug.rasterize_batch_masks(jnp.asarray(segs), jnp.asarray(valid), 24, 20,
                                        overlap=overlap)
    assert got.shape == ((2, 24, 20) if overlap else (2, 6, 24, 20))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_device_augment_seg_composes_and_fills(seg_data):
    """The whole device augmentation from the cache: seeded by the step,
    boxes within the output, and the masks those of the returned polygons;
    a rotation hyp raises."""
    root, _ = seg_data
    ds = dataset.YOLODataset(str(root / "images" / "train"), img_size=64, augment=True)
    cache = {k: torch.from_numpy(v)
             for k, v in device_cache.build_cache_arrays(ds, 8, segments_v=32).items()}
    hyp = dict(SCRATCH_LOW, flipud=0.5)
    idx = torch.arange(4)
    batch = {k: cache[k][idx] for k in ("images", "hw", "targets", "valid", "segments")}

    def run(step):
        gen = device_aug.aug_generator(0, step, "cpu")
        return device_aug.device_augment_seg(batch, gen, hyp, (16, 16), pool=cache,
                                             self_idx=idx)

    a, b, c = run(0), run(0), run(1)
    assert a["images"].shape == (4, 64, 64, 3) and a["masks"].shape == (4, 16, 16)
    for k in a:
        torch.testing.assert_close(a[k], b[k])
    assert not torch.equal(a["images"], c["images"])
    assert a["valid"].any()
    t = a["targets"][a["valid"]]
    assert (t[:, 1:] >= 0).all() and (t[:, 1:] <= 1).all()
    torch.testing.assert_close(a["masks"], device_aug.rasterize_batch_masks(
        a["segments"], a["valid"], 16, 16))
    assert set(a["masks"].unique().tolist()) <= set(range(33))
    with pytest.raises(ValueError, match="separable"):
        device_aug.mosaic_in_batch_seg(batch["images"], batch["hw"], batch["targets"],
                                       batch["segments"], batch["valid"],
                                       torch.Generator().manual_seed(0), dict(hyp, degrees=5.0))


# ---------------------------------------------------------------------------
# train/loss.py: ComputeSegmentLoss
# ---------------------------------------------------------------------------

def _loss_inputs(rng, bs=2, m=6, img=64, nc=3, nm=8, overlap=True):
    maps = [rng.normal(0, 1, (bs, img // s, img // s, 3, 5 + nc + nm)).astype(np.float32)
            for s in (8, 16, 32)]
    proto = rng.normal(0, 1, (bs, img // 4, img // 4, nm)).astype(np.float32)
    t = np.zeros((bs, m, 5), np.float32)
    t[..., 0] = rng.integers(0, nc, (bs, m))
    t[..., 1:3] = rng.uniform(0.2, 0.8, (bs, m, 2))
    t[..., 3:5] = rng.uniform(0.05, 0.5, (bs, m, 2))
    valid = rng.random((bs, m)) < 0.8
    hm = img // 4
    if overlap:
        masks = rng.integers(0, m + 1, (bs, hm, hm)).astype(np.int32)
    else:
        masks = (rng.random((bs, m, hm, hm)) < 0.3).astype(np.uint8)
    return maps, proto, t, valid, masks


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("seg_k", [256, 7])
def test_compute_segment_loss_matches_jax(overlap, seg_k):
    """box, obj, cls, seg and the total within 1e-5 relative, seg_overflow
    equal (seg_k 7 overflows at every level)."""
    rng = np.random.default_rng(9)
    maps, proto, t, valid, masks = _loss_inputs(rng, overlap=overlap)
    anchors = ((1.25, 1.625), (2.0, 3.75), (4.125, 2.875)), ((1.875, 3.8125), (3.875, 2.8125),
                                                             (3.6875, 7.4375)), \
        ((3.625, 2.8125), (4.875, 6.1875), (11.65625, 10.1875))
    hyp = trainer.scale_hyp(SCRATCH_LOW, nl=3, nc=3, imgsz=64)
    port = loss.ComputeSegmentLoss(anchors, 3, hyp, nm=8, overlap=overlap, seg_k=seg_k)
    ref = jax_loss.ComputeSegmentLoss(anchors, 3, hyp, nm=8, overlap=overlap, seg_k=seg_k)
    total, comps = port(([torch.from_numpy(x) for x in maps], torch.from_numpy(proto)),
                        torch.from_numpy(t), torch.from_numpy(valid), torch.from_numpy(masks))
    rtotal, rcomps = ref(([jnp.asarray(x) for x in maps], jnp.asarray(proto)), jnp.asarray(t),
                         jnp.asarray(valid), jnp.asarray(masks))
    np.testing.assert_allclose(total.item(), float(rtotal), rtol=1e-5)
    for k in ("box", "obj", "cls", "seg"):
        np.testing.assert_allclose(comps[k].item(), float(rcomps[k]), rtol=1e-5, err_msg=k)
    assert comps["seg_overflow"].item() == float(rcomps["seg_overflow"])
    assert (comps["seg_overflow"].item() > 0) == (seg_k == 7)
    # without masks it is the detection loss
    det, dcomps = port(([torch.from_numpy(x) for x in maps], torch.from_numpy(proto)),
                       torch.from_numpy(t), torch.from_numpy(valid))
    assert set(dcomps) == {"box", "obj", "cls"}
    assert det.item() < total.item()


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _seg_batch(rng, bs=2, img=64, m=5):
    images = rng.integers(0, 256, (bs, img, img, 3), dtype=np.uint8)
    t = np.zeros((bs, m, 5), np.float32)
    v = np.zeros((bs, m), bool)
    masks = np.zeros((bs, img // 4, img // 4), np.int32)
    for b in range(bs):
        n = 2 + b
        t[b, :n, 0] = rng.integers(0, 3, n)
        t[b, :n, 1:3] = rng.uniform(0.25, 0.75, (n, 2))
        t[b, :n, 3:5] = rng.uniform(0.1, 0.4, (n, 2))
        v[b, :n] = True
        for j in range(n):
            x, y, w, h = t[b, j, 1:] * (img // 4)
            masks[b, int(y - h / 2):int(y + h / 2), int(x - w / 2):int(x + w / 2)] = j + 1
    return {"images": images, "targets": t, "valid": v, "masks": masks}


def test_one_seg_train_step_matches_jax():
    """One step of each package on the same yolov5n-seg weights and batch
    (64 px, b2, f32, masks as index maps): box, obj and cls within 1e-5
    relative, seg and the total within 1e-4, parameters, BN statistics and
    EMA after the step within 5e-5 of each tensor's largest value. The two
    packages' f32 convolutions sum in other orders (the train-mode maps
    differ by ~6e-5 relative, tests/test_torch_train_step.py), and the mask
    term sums products of the coefficient and prototype maps over three
    (bs, K, hm, wm) grids: 0.6-4.6e-5 relative over seeds, as the
    parameters' 1.2-5.3e-5 after one step (the detection step's test holds
    them to 5e-5 as well)."""
    rng = np.random.default_rng(10)
    port = SegmentationModel(CFG)
    sd = random_state_dict(port, rng)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    jm = JaxSegmentationModel(CFG, packed_stem=False)
    jm.variables, missed = import_torch_weights(jm, sd)
    assert not missed
    hyp = trainer.scale_hyp(SCRATCH_LOW, nl=3, nc=3, imgsz=64)
    sched = dict(epochs=3, steps_per_epoch=5, batch_size=2, nbs=2)
    tx = jax_optim.build_optimizer(jm.params, hyp, **sched)
    jstate = jax_trainer.init_train_state(jm, tx)
    jstep = jax_trainer.make_train_step(
        jm, jax_loss.ComputeSegmentLoss(jm.anchors_per_stride, 3, hyp, nm=32), tx,
        has_masks=True, mask_shape=(16, 16))
    state = trainer.init_train_state(port, optim.Optimizer(dict(port.named_parameters()), hyp,
                                                           **sched))
    step = trainer.make_train_step(loss.ComputeSegmentLoss(port.anchors_per_stride, 3, hyp,
                                                           nm=32),
                                   dtype=torch.float32, has_masks=True, mask_shape=(16, 16))
    batch = _seg_batch(rng)
    jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(m[k].item(), float(jm_[k]), rtol=1e-5, err_msg=k)
    for k in ("seg", "total"):
        np.testing.assert_allclose(m[k].item(), float(jm_[k]), rtol=1e-4, err_msg=k)
    assert m["seg_overflow"].item() == float(jm_["seg_overflow"]) == 0

    def sd_of(variables):
        return {k: v.numpy() for k, v in from_jax_variables(variables).items()}

    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ref = sd_of({"params": jstate.params, "batch_stats": jstate.batch_stats})
    ema = {k: v.numpy() for k, v in {**state.ema.params, **state.ema.batch_stats}.items()}
    ref_ema = sd_of({"params": jstate.ema.params, "batch_stats": jstate.ema.batch_stats})
    for what, g, r in (("after one step", got, ref), ("ema", ema, ref_ema)):
        for k, rv in r.items():
            np.testing.assert_allclose(g[k], rv, rtol=5e-5, atol=5e-5 * np.abs(rv).max(),
                                       err_msg=f"{what} {k}")


def test_device_aug_seg_step_trains(seg_data):
    """A step through the device cache with device augmentation: finite
    losses that feed the mask term, the same on a replay of the state."""
    root, _ = seg_data
    ds = dataset.YOLODataset(str(root / "images" / "train"), img_size=64, augment=True)
    cache = {k: torch.from_numpy(v)
             for k, v in device_cache.build_cache_arrays(ds, 8, segments_v=32).items()}
    model = SegmentationModel(CFG)
    hyp = trainer.scale_hyp(SCRATCH_LOW, nl=3, nc=3, imgsz=64)
    opt = optim.Optimizer(dict(model.named_parameters()), hyp, epochs=1, steps_per_epoch=2,
                          batch_size=4)
    state = trainer.init_train_state(model, opt)
    twin = copy.deepcopy(state)
    step = trainer.make_train_step(loss.ComputeSegmentLoss(model.anchors_per_stride, 3, hyp),
                                   device_aug_hyp=SCRATCH_LOW, dtype=torch.float32,
                                   has_masks=True, mask_shape=(16, 16))
    _, m = step(state, {"idx": torch.arange(4)}, cache)
    _, m2 = step(twin, {"idx": torch.arange(4)}, cache)
    assert np.isfinite(m["total"].item()) and m["seg"].item() > 0
    torch.testing.assert_close(m["total"], m2["total"])


# ---------------------------------------------------------------------------
# segment train -> segment val, without OpenCV
# ---------------------------------------------------------------------------

def test_segment_train_then_val_without_cv2(seg_data, tmp_path):
    """``segment train`` for one epoch (host augmentation, in-process
    loader) then ``segment val`` on its best.ckpt, with cv2 unimportable:
    results.csv holds finite losses, both checkpoints carry the seg cfg and
    the live anchors, and val reproduces the epoch's EMA validation."""
    _, data = seg_data
    code = f"""
import json, sys
sys.modules["cv2"] = None
from yolov5_tpu_torch.segment import main
tr = main(["train", "--device", "cpu", "--data", {str(data)!r}, "--cfg", "yolov5n-seg",
           "--imgsz", "64", "--batch-size", "4", "--epochs", "1", "--dtype", "float32",
           "--workers", "1", "--project", {str(tmp_path)!r}, "--name", "a"])
va = main(["val", "--device", "cpu", "--data", {str(data)!r}, "--imgsz", "64",
           "--batch-size", "4", "--workers", "1",
           "--weights", tr["save_dir"] + "/best.ckpt"])
assert "cv2" not in [m for m in sys.modules if sys.modules[m] is not None]
print("RESULT", json.dumps({{"train": tr, "val": va}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    out = json.loads(proc.stdout.split("RESULT ", 1)[1])
    run_dir = Path(out["train"]["save_dir"])
    import csv

    with open(run_dir / "results.csv") as f:
        row = list(csv.DictReader(f))[0]
    for k in ("box", "obj", "cls", "seg", "total"):
        assert np.isfinite(float(row[f"train/{k}"])), k
    meta = yaml.safe_load((run_dir / "best.ckpt.json").read_text())
    assert meta["cfg"]["head"][-1][2] == "Segment" and len(meta["anchors"]) == 3
    for part in ("box", "mask"):
        for k in ("map50", "map"):
            assert out["val"][part][k] == pytest.approx(float(row[f"val/{part}_{k}"]),
                                                        abs=1e-9), (part, k)
    assert out["val"]["fitness"] == pytest.approx(out["train"]["fitness"], abs=1e-9)


def test_segment_cli_defaults_to_the_card(seg_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yolov5_tpu_torch.segment import main

    _, data = seg_data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--data", str(data), "--epochs", "1", "--imgsz", "64"])
