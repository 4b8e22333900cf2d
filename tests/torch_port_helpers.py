"""Shared inputs and comparisons for the tests that hold yolov5_tpu_torch
against the JAX package (tests/test_torch_*.py). Every input is drawn with
numpy from a seed and handed to both packages."""

import numpy as np
import torch

# The suite runs in several pytest-xdist worker processes, and every worker
# imports this module when it collects. With torch's default of one OpenMP
# thread per core in each worker, the workers' threads starve each other and
# the port's convolutions run tens of times slower than alone (a 4 s
# training test took 281 s beside five other workers); one thread each
# keeps every test near its serial time.
torch.set_num_threads(1)


def random_state_dict(module: torch.nn.Module, rng: np.random.Generator) -> dict:
    """Numpy values for every entry of ``module.state_dict()``: conv weights
    U(±1/sqrt(fan_in)), biases U(±0.5), and non-trivial BN affine parameters
    and running statistics so that BN folding is exercised."""
    sd = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_mean"):
            a = rng.normal(0.0, 0.2, shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif ".bn." in f".{k}" and k.endswith("weight"):
            a = rng.uniform(0.5, 1.5, shape)
        elif ".bn." in f".{k}" and k.endswith("bias"):
            a = rng.normal(0.0, 0.1, shape)
        elif k.endswith("weight"):
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            a = rng.uniform(-bound, bound, shape)
        else:
            a = rng.uniform(-0.5, 0.5, shape)
        sd[k] = a.astype(np.float32)
    return sd


def load_numpy_state_dict(module: torch.nn.Module, sd: dict) -> None:
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)


def random_sorted_boxes(rng, k, span=200.0):
    """k xyxy boxes and descending scores in (0.01, 1), as tests/test_nms.py."""
    xy = rng.uniform(0, span, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1.0, k).astype(np.float32))[::-1].copy()
    return boxes, scores


def truncate_after(keep: np.ndarray, max_det: int) -> np.ndarray:
    """A keep mask with every entry after its max_det-th True cleared (the
    early exit of the port's greedy suppression)."""
    keep = np.array(keep, bool)
    for row in keep.reshape(-1, keep.shape[-1]):
        kept = np.flatnonzero(row)
        row[kept[max_det:]] = False
    return keep


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype != torch.bool else x.cpu().numpy()
    return np.asarray(x)


def assert_same_detections(a, b, atol=1e-4):
    """Two padded Detections agree on every valid entry (the semantics of
    tests/test_nms.py::_assert_same_detections)."""
    va, vb = to_numpy(a.valid), to_numpy(b.valid)
    assert (va == vb).all(), "valid masks differ"
    for field in ("boxes", "scores", "classes", "masks"):
        xa, xb = to_numpy(getattr(a, field)), to_numpy(getattr(b, field))
        assert xa.shape == xb.shape, field
        np.testing.assert_allclose(xa[va], xb[va], atol=atol, err_msg=field)


def assert_same_detection_sets(a, b, atol=1e-3, rtol=0.0):
    """Per image, the same valid count and a one-to-one match of detections
    (same class, box and score within atol + rtol·|b|). For two packages
    whose scores agree only to a few ulps: near-equal scores may swap
    places."""
    va, vb = to_numpy(a.valid), to_numpy(b.valid)
    assert (va == vb).all(), "valid masks differ"
    for i in range(va.shape[0]):
        rows = [np.concatenate([to_numpy(d.boxes)[i], to_numpy(d.scores)[i][:, None],
                                to_numpy(d.classes)[i][:, None]], 1)[v[i]]
                for d, v in ((a, va), (b, vb))]
        free = np.ones(len(rows[1]), bool)
        for r in rows[0]:
            close = np.abs(rows[1][:, :5] - r[:5]) <= atol + rtol * np.abs(rows[1][:, :5])
            hit = free & (rows[1][:, 5] == r[5]) & close.all(1)
            assert hit.any(), f"image {i}: no match for detection {r}"
            free[np.flatnonzero(hit)[0]] = False


def write_shapes_dataset(root, shapes, ext=".jpg", nc=3, seed=0, write=None, split="val"):
    """A YOLO-layout dataset under ``root``: ``images/{split}/{i:03d}{ext}``
    of the given (h, w) shapes (noise, 1-4 noisy rectangles of ``nc``
    classes in separate cells) and ``labels/{split}/{i:03d}.txt``.
    ``write(path, bgr)`` writes an image (default ``cv2.imwrite``). Returns
    a data dict for ``check_dataset`` with that split as ``val``."""
    from pathlib import Path

    if write is None:
        import cv2

        def write(p, im):
            assert cv2.imwrite(str(p), im)

    root = Path(root)
    (root / "images" / split).mkdir(parents=True, exist_ok=True)
    (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        # textured everywhere: flat areas give runs of equal scores, whose
        # order at the max_det cut is decided by float rounding
        im = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        rows = []
        for cell in range(int(rng.integers(1, 5))):
            cx0, cy0 = (cell % 2) * w / 2, (cell // 2) * h / 2
            bw, bh = rng.uniform(0.2, 0.45) * w, rng.uniform(0.2, 0.45) * h
            x0 = int(cx0 + rng.uniform(0, w / 2 - bw))
            y0 = int(cy0 + rng.uniform(0, h / 2 - bh))
            x1, y1 = x0 + int(bw), y0 + int(bh)
            c = int(rng.integers(0, nc))
            color = np.array((60 + 60 * c, 255 - 60 * c, 40 * (c + 1)))
            im[y0:y1, x0:x1] = (color + rng.integers(-30, 30, (y1 - y0, x1 - x0, 3))).clip(0, 255)
            rows.append(f"{c} {(x0 + x1) / 2 / w:.6f} {(y0 + y1) / 2 / h:.6f} "
                        f"{(x1 - x0) / w:.6f} {(y1 - y0) / h:.6f}")
        write(root / "images" / split / f"{i:03d}{ext}", im)
        (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return {"path": str(root), "val": f"images/{split}", "nc": nc,
            "names": [f"c{j}" for j in range(nc)]}


def yolov5n_cfg(nc=3):
    """The yolov5n config as a dict with ``nc`` classes."""
    import yaml

    from yolov5_tpu_torch.models.yolo import CONFIG_DIR

    with open(CONFIG_DIR / "yolov5n.yaml") as f:
        return {**yaml.safe_load(f), "nc": nc}


def random_detector_weights(cfg, seed):
    """random_state_dict of the model of ``cfg`` with conv weights 2.5x
    larger, so that features survive the depth and scores differ from cell
    to cell (else a run of near-equal scores meets the max_det cut, and
    rounding decides what is kept), and Detect biases near 0, so that NMS
    sees real candidates at low thresholds."""
    from yolov5_tpu_torch.models.yolo import DetectionModel

    rng = np.random.default_rng(seed)
    sd = random_state_dict(DetectionModel(cfg), rng)
    for k in list(sd):
        if k.endswith("conv.weight"):
            sd[k] = sd[k] * np.float32(2.5)
        elif k.startswith("model.24.m.") and k.endswith("bias"):
            sd[k] = rng.normal(-1.0, 0.5, sd[k].shape).astype(np.float32)
    return sd


def seg_cfg(nc=3):
    """The yolov5n-seg config as a dict with ``nc`` classes."""
    import yaml

    from yolov5_tpu_torch.models.yolo import CONFIG_DIR

    with open(CONFIG_DIR / "yolov5n-seg.yaml") as f:
        return {**yaml.safe_load(f), "nc": nc}


def random_segmenter_weights(cfg, seed, imgsz=128):
    """random_state_dict of the segmentation model of ``cfg`` with the BN
    running statistics of a batch of noise images (so that every layer's
    output is normalised and the scores vary from cell to cell through the
    whole depth), Segment head weights 0.03x (small logits, so that the two
    packages' f32 roundings stay within 1e-3 px of a box) and its biases
    near -1."""
    from yolov5_tpu_torch.models.yolo import SegmentationModel

    rng = np.random.default_rng(seed)
    model = SegmentationModel(cfg)
    sd = random_state_dict(model, rng)
    for k in sd:
        if k.startswith("model.24.m."):
            sd[k] = (rng.normal(-1.0, 0.5, sd[k].shape).astype(np.float32) if k.endswith("bias")
                     else sd[k] * np.float32(0.03))
    load_numpy_state_dict(model, sd)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0  # the running statistics become the batch's
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, imgsz, imgsz)).astype(np.float32))
    with torch.no_grad():
        model.train()(x.contiguous(memory_format=torch.channels_last))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def assert_same_rows(a, b, atol=1e-3):
    """Two per-image lists of (n, 6) [x1, y1, x2, y2, conf, cls] detections:
    equal counts per image and a one-to-one match (same class, box and
    score within atol; near-equal scores may trade places)."""
    assert len(a) == len(b)
    for i, (ra, rb) in enumerate(zip(a, b)):
        assert len(ra) == len(rb), f"image {i}: {len(ra)} vs {len(rb)} detections"
        free = np.ones(len(rb), bool)
        for r in ra:
            hit = free & (rb[:, 5] == r[5]) & (np.abs(rb[:, :5] - r[:5]) <= atol).all(1)
            assert hit.any(), f"image {i}: no match for detection {r}"
            free[np.flatnonzero(hit)[0]] = False


def assert_same_records(got, ref, box_atol=1e-3, box_rtol=1e-5, conf_atol=1e-5):
    """Two lists of detection records ({xmin, ymin, xmax, ymax, confidence,
    class, name}): a one-to-one match, same class and name, box within
    box_atol px + box_rtol of its largest coordinate (the f32 rounding of
    boxes a few hundred px wide) and confidence within conf_atol
    (near-equal scores may trade places)."""
    coords = ("xmin", "ymin", "xmax", "ymax")
    assert len(got) == len(ref)
    free = np.ones(len(got), bool)
    for r in ref:
        tol = box_atol + box_rtol * max(abs(r[k]) for k in coords)
        hit = [i for i, g in enumerate(got) if free[i] and g["class"] == r["class"]
               and g["name"] == r["name"] and abs(g["confidence"] - r["confidence"]) <= conf_atol
               and all(abs(g[k] - r[k]) <= tol for k in coords)]
        assert hit, r
        free[hit[0]] = False


def save_jax_checkpoint(cfg, path, anchors=None, ema=True, dtype=np.float32,
                        weights=random_detector_weights):
    """A .ckpt written by yolov5_tpu.utils.checkpoint.save_checkpoint of
    random weights of ``cfg``, drawn by ``weights(cfg, seed)`` (EMA weights
    different from the raw ones)."""
    from types import SimpleNamespace

    from yolov5_tpu.models import DetectionModel
    from yolov5_tpu.models.weights import import_torch_weights
    from yolov5_tpu.utils.checkpoint import save_checkpoint

    model = DetectionModel(cfg, anchors=anchors)
    raw, _ = import_torch_weights(model, weights(cfg, 1))
    avg, _ = import_torch_weights(model, weights(cfg, 2))
    cast = lambda t: {k: cast(v) if isinstance(v, dict) else np.asarray(v).astype(dtype)
                      for k, v in t.items()}
    raw, avg = cast(raw), cast(avg)
    state = SimpleNamespace(
        params=raw["params"], batch_stats=raw["batch_stats"], step=17, opt_state=None,
        ema=SimpleNamespace(params=avg["params"] if ema else None,
                            batch_stats=avg["batch_stats"] if ema else None, updates=9))
    save_checkpoint(path, state, model, epoch=3, best_fitness=0.25)
    return path


def write_polygon_dataset(root, shapes, nc=3, seed=0, split="val", ext=".bmp"):
    """A YOLO-layout segmentation set under ``root``: ``images/{split}/
    {i:03d}{ext}`` of the given (h, w) shapes (24-bit BMP, written with
    numpy) with 1-4 filled polygons of ``nc`` classes in separate cells of
    a 2x2 grid (triangles and 12-vertex ellipses, so that neither the fill
    nor the crop is a rectangle), and ``labels/{split}/{i:03d}.txt`` with
    every label a polygon. Returns a data dict for ``check_dataset`` with
    that split as ``val``."""
    from pathlib import Path

    from yolov5_tpu_torch.data.cv import fill_poly
    from yolov5_tpu_torch.data.imageio import imwrite

    root = Path(root)
    (root / "images" / split).mkdir(parents=True, exist_ok=True)
    (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    colors = ((90, 200, 40), (230, 60, 120), (40, 120, 250), (200, 200, 60))
    for i, (h, w) in enumerate(shapes):
        im = rng.integers(0, 80, (h, w, 3)).astype(np.uint8)
        rows = []
        for cell in rng.permutation(4)[:int(rng.integers(1, 5))]:
            cx = (cell % 2 + rng.uniform(0.35, 0.65)) * w / 2
            cy = (cell // 2 + rng.uniform(0.35, 0.65)) * h / 2
            rx, ry = rng.uniform(0.2, 0.45) * w / 2, rng.uniform(0.2, 0.45) * h / 2
            n = 3 if rng.random() < 0.5 else 12
            ang = rng.uniform(0, 2 * np.pi) + np.arange(n) * 2 * np.pi / n
            poly = np.stack([cx + rx * np.cos(ang), cy + ry * np.sin(ang)], 1)
            c = int(rng.integers(0, nc))
            fill_poly(im, np.round(poly).astype(np.int32), colors[c % len(colors)])
            rows.append(f"{c} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in poly))
        imwrite(root / "images" / split / f"{i:03d}{ext}", im)
        (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return {"path": str(root), "val": f"images/{split}", "nc": nc,
            "names": [f"c{j}" for j in range(nc)]}


CLASS_COLORS = ((200, 60, 40), (40, 180, 60), (50, 70, 220), (210, 200, 50), (160, 60, 200),
                (40, 200, 200), (240, 130, 30), (120, 120, 120), (250, 250, 250), (20, 20, 20))


def write_imagefolder(root, classes, n_per_class, shapes, ext=".bmp", seed=0):
    """An ImageFolder under ``root``: ``{class}/{i:03d}{ext}`` for each name
    of ``classes``, ``n_per_class`` images each, of the (h, w) ``shapes`` in
    turn: noise around the class's colour (``CLASS_COLORS``, so that a
    classifier can learn the classes) with one noisy rectangle of another
    colour. BMPs are written with numpy, other suffixes with cv2. Returns
    the number of images. ``chip_smoke.py`` writes its sets the same way."""
    from pathlib import Path

    from yolov5_tpu_torch.data.imageio import imwrite

    root = Path(root)
    rng = np.random.default_rng(seed)
    k = 0
    for c, name in enumerate(classes):
        (root / name).mkdir(parents=True, exist_ok=True)
        base = np.array(CLASS_COLORS[c % len(CLASS_COLORS)], np.int16)[::-1]  # BGR
        for i in range(n_per_class):
            h, w = shapes[k % len(shapes)]
            im = (base + rng.integers(-60, 60, (h, w, 3))).clip(0, 255).astype(np.uint8)
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            y1, x1 = y0 + int(rng.integers(h // 8, h // 2)), x0 + int(rng.integers(w // 8, w // 2))
            im[y0:y1, x0:x1] = rng.integers(0, 256, 3)
            path = root / name / f"{i:03d}{ext}"
            if ext == ".bmp":
                imwrite(path, im)
            else:
                import cv2

                assert cv2.imwrite(str(path), im)
            k += 1
    return k


# ---------------------------------------------------------------------------
# The model zoo (tests/test_torch_zoo_*.py)
# ---------------------------------------------------------------------------

def small_cfg(name, nc=3, width=0.125, depth=0.33):
    """A bundled config (or a config dict) with ``nc`` classes at a reduced
    width and depth."""
    from yolov5_tpu_torch.models.yolo import load_config

    return {**load_config(name), "nc": nc, "width_multiple": width, "depth_multiple": depth}


def zoo_imgsz(cfg):
    """The smallest square input the tests feed a config: 64 px, 128 px where
    the strides reach 128 (P7)."""
    anchors = cfg.get("anchors")
    return 128 if isinstance(anchors, list) and len(anchors) > 4 else 64


def random_jax_variables(variables, rng):
    """New numpy leaves for the JAX package's ``variables`` tree: kernels
    U(±1.5/sqrt(fan_in)), conv and Dense biases U(±0.2), BN scales
    U(0.5, 1.5), BN biases N(0, 0.1), running means N(0, 0.2) and variances
    U(0.5, 1.5), AconC's p1, p2 N(0, 1) and beta U(0.5, 1.5)."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + [k])
                continue
            shape = np.shape(v)
            bn = bool(path) and (path[-1] == "bn" or path[-1].endswith("_bn"))
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.uniform(-1.5, 1.5, shape) / np.sqrt(fan_in)
            elif k in ("scale", "var", "beta"):
                a = rng.uniform(0.5, 1.5, shape)
            elif k == "mean":
                a = rng.normal(0.0, 0.2, shape)
            elif k == "bias":
                a = rng.normal(0.0, 0.1, shape) if bn else rng.uniform(-0.2, 0.2, shape)
            else:  # p1, p2
                a = rng.normal(0.0, 1.0, shape)
            out[k] = a.astype(np.float32)
        return out

    return {coll: walk(tree, []) for coll, tree in variables.items()}


def nchw(x):
    """An NHWC numpy batch as an NCHW channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def assert_maps_close(got, ref, rel=1e-4, what="map"):
    """Each tensor of got within rel of its reference's largest magnitude."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = to_numpy(g), np.asarray(r, np.float32)
        assert g.shape == r.shape, (what, i, g.shape, r.shape)
        assert np.isfinite(r).all(), (what, i)
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max(),
                                   err_msg=f"{what} {i}")


_ZOO_PAIRS = {}


def zoo_pair(name, cfg=None):
    """For the config ``name`` at the reduced size of ``small_cfg`` (or the
    config dict ``cfg`` as it is, under that name): the JAX package's
    DetectionModel, seeded random variables for it (``random_jax_variables``)
    and a seeded input batch (2, s, s, 3) in [0, 1), s = ``zoo_imgsz``; kept
    for the life of the process."""
    if name not in _ZOO_PAIRS:
        from yolov5_tpu.models import DetectionModel as JaxModel

        cfg = cfg or small_cfg(name)
        rng = np.random.default_rng(sum(map(ord, name)))
        jm = JaxModel(cfg, packed_stem=False)
        s = zoo_imgsz(cfg)
        _ZOO_PAIRS[name] = (cfg, jm, random_jax_variables(jm.variables, rng),
                            rng.uniform(0, 1, (2, s, s, 3)))
    return _ZOO_PAIRS[name]


def _flat_maps(out):
    """A model's output as a list of arrays: the raw maps, then a Segment
    head's proto."""
    return [*out[0], out[1]] if isinstance(out, tuple) else list(out)


def check_zoo_maps(name, mode, cfg=None):
    """The port's raw maps (and proto) against the JAX model's on the same
    variables (through ``from_jax_variables``) and input, for ``mode``:

      - "eval": unfused, running statistics; f32, within 1e-4 of each
        tensor's largest value;
      - "fused": the port's model with BN folded by its ``fuse_conv_bn``
        against the JAX model *unfused*; f32, the same tolerance;
      - "train": train-mode BN, the maps and the moved running statistics.
        In float64 in both packages, within 1e-6: in f32 each package is
        1e-4 .. 3e-4 of the largest value away from its float64 result at
        these sizes (a 2x2 map of batch 2 normalised by its own statistics
        through 20+ BNs), so an f32 comparison would measure rounding. The
        attention softmax stays f32 in both, as written."""
    import jax
    import jax.numpy as jnp

    from yolov5_tpu.models import DetectionModel as JaxModel
    from yolov5_tpu_torch.models.weights import from_jax_variables, fuse_conv_bn
    from yolov5_tpu_torch.models.yolo import DetectionModel

    cfg, jm, variables, x = zoo_pair(name, cfg)
    sd = from_jax_variables(variables)
    if mode == "train":
        with jax.enable_x64(True):
            j64 = JaxModel(cfg, packed_stem=False, dtype=jnp.float64)
            v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
            ref, upd = j64.apply(v64, jnp.asarray(x), train=True, mutable=["batch_stats"])
            ref = [np.asarray(r) for r in _flat_maps(ref)]
            moved = from_jax_variables({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                              upd["batch_stats"])})
        port = DetectionModel(cfg).double()
        port.load_state_dict(sd)
        got = _flat_maps(port.train()(nchw(x)))
        assert_maps_close(got, ref, 1e-6, f"{name} train")
        own = port.state_dict()
        assert_maps_close([own[k] for k in moved], [moved[k].numpy() for k in moved], 1e-6,
                          f"{name} running statistics")
        return
    if (name, "ref") not in _ZOO_PAIRS:
        _ZOO_PAIRS[name, "ref"] = _flat_maps(jm.apply(variables, jnp.asarray(x, jnp.float32)))
    ref = _ZOO_PAIRS[name, "ref"]
    port = DetectionModel(cfg, fused=mode == "fused")
    port.load_state_dict(fuse_conv_bn(sd) if mode == "fused" else sd)
    with torch.no_grad():
        got = _flat_maps(port.eval()(nchw(x.astype(np.float32))))
    assert_maps_close(got, ref, 1e-4, f"{name} {mode}")


def _jax_shapes(cfg, fused):
    """{(collection, flax path): shape} of the JAX model of cfg, taken
    abstractly (jax.eval_shape of the graph's init at 256 px)."""
    import jax
    import jax.numpy as jnp

    from yolov5_tpu.models.yolo import YOLOGraph, parse_graph

    specs, save, _ = parse_graph(cfg)
    module = YOLOGraph(tuple(specs), save, fused=fused, packed_stem=False)
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)),
                                              train=False))
    out = {}

    def walk(coll, t, path):
        for k, v in t.items():
            if hasattr(v, "items"):
                walk(coll, v, path + [k])
            else:
                out[coll, tuple(path + [k])] = tuple(v.shape)

    for coll, t in tree.items():
        walk(coll, t, [])
    return out


def check_full_width_layout(name):
    """At full width: the port's state_dict has, key by key, the shape of
    the JAX model's variable at the flax path ``torch_key_to_flax`` gives
    (OIHW against HWIO, (out, in) against (in, out)), leaf for leaf; and the
    port's ``fuse_conv_bn`` of it has the keys and shapes of its fused
    model."""
    from yolov5_tpu_torch.models.weights import fuse_conv_bn, torch_key_to_flax
    from yolov5_tpu_torch.models.yolo import DetectionModel, load_config

    cfg = load_config(name)
    sd = DetectionModel(cfg).state_dict()
    fused = {k: tuple(t.shape) for k, t in fuse_conv_bn(sd).items()}
    assert fused == {k: tuple(t.shape) for k, t in DetectionModel(cfg, fused=True).state_dict()
                     .items() if not k.endswith("num_batches_tracked")}
    got = {}
    for k, t in sd.items():
        m = torch_key_to_flax(k)
        if m is None:
            continue
        shape = tuple(t.shape)
        if m[1][-1] == "kernel":
            shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape[::-1]
        got[m[0], tuple(m[1])] = shape
    assert got == _jax_shapes(cfg, fused=False)
