"""The port's segmentation path against the benchmark's plain reference
(``perfbench/reference/segment.py``), on the CPU in float32 with seeded
weights (``perfbench/core/segment_weights.py``): the SegmentationModel's
maps and prototypes (fused and unfused; yolov5n-seg and yolov5s-seg at
160 px), ``crop_mask``, ``process_mask``, the loader's GT masks and
``_mask_ious``, ``evaluate_segment``'s box and mask mAP on 8 seeded BMPs
with polygons, the reference's parameter count of the frozen yolov5x-seg
YAML, and ``evaluate_segment``'s spans.

Tolerances: maps and prototypes within 1e-3 relative and 5e-4 absolute
(float32 through two conv layouts, as the detection reference's test);
masks within 1e-5 (one float32 product and its sigmoid in another order);
the crop, the GT masks and the IoUs of the same 0/1 masks exact; mAPs
within 1e-3 (the same detections, whose float32 scores may trade places
where they tie to the last bit)."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.core import segment_weights, spec
from perfbench.reference import segment as ref
from perfbench.reference import yolo
from tests.torch_port_helpers import write_polygon_dataset
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.models.weights import fuse_conv_bn, load_weights
from yolov5_tpu_torch.models.yolo import CONFIG_DIR, SegmentationModel
from yolov5_tpu_torch.ops import masks
from yolov5_tpu_torch.ops.nms import Detections
from yolov5_tpu_torch.train import run_segment
from yolov5_tpu_torch.utils import profile as prof

CPU = torch.device("cpu")
IMGSZ = 160
SEGVAL_SPANS = ("segval.load", "segval.forward", "segval.nms", "segval.masks", "segval.match",
                "segval.ap", "load.square")


def _cfg(name):
    return yolo.load_yaml(CONFIG_DIR / f"{name}.yaml")


_WEIGHTS = {}


def seeded(name):
    """(cfg, calibrated weights, the calibration's uint8 images) of a config,
    made once."""
    if name not in _WEIGHTS:
        cfg = _cfg(name)
        x = torch.randint(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(5))
        sd = segment_weights.calibrated(cfg, 2**33 + 7, [x], 0.001, 300, CPU,
                                        {"iou_thres": 0.6, "max_nms": 30720})[0]
        _WEIGHTS[name] = (cfg, sd, x)
    return _WEIGHTS[name]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", ["yolov5n-seg", "yolov5s-seg"])
def test_segmentation_model_matches_reference(name, fused):
    cfg, sd, x = seeded(name)
    port = SegmentationModel(cfg, fused=fused)
    assert load_weights(port, fuse_conv_bn(sd) if fused else sd) == []
    xi = x.permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        maps, proto = port.eval()(xi.contiguous(memory_format=torch.channels_last))
        ref_maps, ref_proto = ref.Model(cfg, sd)(xi.contiguous())
    for a, b in zip(maps, ref_maps):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-4)
    torch.testing.assert_close(proto.permute(0, 3, 1, 2), ref_proto, rtol=1e-3, atol=5e-4)
    assert ref_proto.shape == (2, 32, IMGSZ // 4, IMGSZ // 4)


def test_crop_and_process_mask_match_reference():
    g = torch.Generator().manual_seed(1)
    protos = torch.randn(40, 40, 32, generator=g)
    coeffs = torch.randn(9, 32, generator=g)
    xy = torch.rand(9, 2, generator=g) * 120
    boxes = torch.cat([xy, xy + 8 + torch.rand(9, 2, generator=g) * 60], 1)
    got = masks.process_mask(protos, coeffs, boxes, (IMGSZ, IMGSZ), upsample=True)
    want = ref.process_mask(protos.permute(2, 0, 1), coeffs, boxes, (IMGSZ, IMGSZ))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    m = torch.rand(9, IMGSZ, IMGSZ, generator=g)
    assert torch.equal(masks.crop_mask(m, boxes), ref.crop_mask(m, boxes))


@pytest.fixture(scope="module")
def polygon_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("segref")
    write_polygon_dataset(root, [(120, 160), (160, 160), (160, 96), (100, 160)] * 2, nc=3,
                          seed=4)
    return root / "images" / "val"


def test_loader_gt_masks_match_reference(polygon_set):
    """The loader's overlap-form GT masks (``rasterize_masks``) against the
    reference's ``cv2.fillPoly`` of the same polygons."""
    _, loader = create_loader(str(polygon_set), img_size=IMGSZ, batch_size=4, workers=2,
                              masks=True)
    n = 0
    for batch in loader:
        for b, i in enumerate(batch["indices"][:batch["real"]]):
            ds = loader.ds
            h0, w0 = (int(v) for v in ds.shapes[i])
            dw, dh = (IMGSZ - w0) / 2, (IMGSZ - h0) / 2
            polys = [np.stack([p[:, 0] * float(w0) + dw, p[:, 1] * float(h0) + dh], 1)
                     .astype(np.float32) for p in ds.segments[i]]
            want = ref.polygons_to_overlap_mask(polys, IMGSZ, IMGSZ // 4, IMGSZ // 4)
            np.testing.assert_array_equal(batch["masks"][b], want)
            n += len(polys)
    assert n > 8


def test_mask_ious_match_reference():
    """``_mask_ious`` of a batch against the reference's per-image IoUs of
    the same detections, prototypes and GT maps."""
    g = torch.Generator().manual_seed(2)
    bs, k, s, hm = 3, 7, IMGSZ, IMGSZ // 4
    proto = torch.randn(bs, hm, hm, 32, generator=g) * 0.3
    xy = torch.rand(bs, k, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + 10 + torch.rand(bs, k, 2, generator=g) * 50], -1)
    coeffs = torch.randn(bs, k, 32, generator=g)
    valid = torch.ones(bs, k, dtype=torch.bool)
    dets = Detections(boxes, torch.rand(bs, k, generator=g), torch.zeros(bs, k, dtype=torch.int32),
                      coeffs, valid)
    gt = torch.zeros(bs, hm, hm, dtype=torch.int32)
    gt[:, 5:20, 4:25] = 1
    gt[:, 15:35, 18:38] = 2
    gt[1, 0:3, 0:3] = 3
    n_pred, n_gt = [7, 4, 0], [2, 3, 2]
    got = run_segment._mask_ious(proto, dets, gt, n_pred, n_gt, s, True)
    assert got.shape == (bs, 3, 7)
    for b in range(bs):
        n, ng = n_pred[b], n_gt[b]
        if not n:
            assert not got[b].any()
            continue
        rows = torch.cat([boxes[b, :n], torch.zeros(n, 2), coeffs[b, :n]], 1).numpy()
        want = ref.image_mask_ious(proto[b].permute(2, 0, 1), rows, gt[b], ng, (s, s), 32)
        np.testing.assert_array_equal(got[b, :ng, :n], want.numpy())


@pytest.fixture(scope="module")
def segval_run():
    """A small run of the benchmark's segmentation validation cell: 8 seeded
    BMPs with polygon labels from the reference's own masks, yolov5n-seg at
    160 px in float32; the port's pass and the reference's own mAPs."""
    import copy

    from perfbench.tests.helpers import Ctx

    cell = copy.deepcopy(spec.cell("yolov5x-seg.segval-b32"))
    cell.config = dict(cell.config, yaml=str(CONFIG_DIR / "yolov5n-seg.yaml"))
    cell.traffic.update({"batch": 4, "images": 8, "imgsz": IMGSZ, "half": False,
                         "shapes": [[90, 160], [160, 120]], "workers": 2, "cand_per_img": 1000})
    d = spec.runner(cell.traffic["kind"]).Runner(Ctx(cell, seed=3000000019))
    try:
        d.prepare()
        prog = d.program()
        with prof.recording() as spans:
            res = d.one_pass(prog)
        own = d.control_outputs("f32")
        yield d, res, spans, own
    finally:
        d.close()


def test_evaluate_segment_matches_reference(segval_run):
    _, res, _, own = segval_run
    assert res["images"] == 8
    assert res["box"]["map"] == pytest.approx(own["box_map"], abs=1e-3)
    assert res["mask"]["map"] == pytest.approx(own["mask_map"], abs=1e-3)
    assert own["box_map"] > 0 and own["mask_map"] > 0


def test_evaluate_segment_spans(segval_run):
    """Each batch's phases in order with their counts: ``load.square`` inside
    ``segval.load``, every slot and polygon counted; ``segval.masks``
    counting the masks assembled and the GT instances they meet."""
    d, res, spans, _ = segval_run
    by = {n: [s for s in spans if s.name == n] for n in SEGVAL_SPANS}
    nb = 2
    assert [len(by[n]) for n in SEGVAL_SPANS] == [nb + 1, nb, nb, nb, nb, 1, nb]
    for b in range(nb):
        assert (by["segval.load"][b].end_ns <= by["segval.forward"][b].start_ns
                and by["segval.forward"][b].end_ns <= by["segval.nms"][b].start_ns
                and by["segval.nms"][b].end_ns <= by["segval.masks"][b].start_ns
                and by["segval.masks"][b].end_ns <= by["segval.match"][b].start_ns
                and by["segval.match"][b].end_ns <= by["segval.load"][b + 1].start_ns)
        outer, inner = by["segval.load"][b], by["load.square"][b]
        assert inner.parent == "segval.load"
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert by["segval.ap"][0].start_ns >= by["segval.load"][nb].end_ns
    assert sum(s.counts["images"] for s in by["segval.forward"]) == res["images"] == 8
    assert sum(s.counts["images"] for s in by["load.square"]) == 8
    assert sum(s.counts["polygons"] for s in by["load.square"]) == sum(
        len(c) for c in d.label_cls)
    assert {s.parent for s in spans if s.name == "nms"} == {"segval.nms"}
    assert all(s.counts["masks"] > 0 and s.counts["gt"] > 0 for s in by["segval.masks"])
    assert sum(s.counts["gt"] for s in by["segval.masks"]) <= sum(len(c) for c in d.label_cls)


def test_reference_parameters_of_yolov5x_seg():
    """The frozen yolov5x-seg YAML, parsed and not built, against the
    published 88.8 M parameters (ultralytics/yolov5 v7.0)."""
    cfg = yolo.load_yaml(Path(spec.ROOT) / "perfbench" / "configs" / "yolov5x-seg.yaml")
    assert ref.params(cfg) == pytest.approx(88.8e6, rel=1e-3)
    assert ref.proto_specs(cfg)[0].c2 == 320  # make_divisible(256 x 1.25, 8)


def test_reference_decode_keeps_coefficients_raw():
    cfg, sd, x = seeded("yolov5n-seg")
    with torch.no_grad():
        maps, _ = ref.Model(cfg, sd)(x.permute(0, 3, 1, 2).float() / 255.0)
    pred, coeffs = ref.decode(maps, cfg)
    assert pred.shape[-1] == 5 + cfg["nc"] and coeffs.shape[-1] == 32
    raw = torch.cat([m[..., 5 + cfg["nc"]:].reshape(2, -1, 32) for m in maps], 1)
    assert torch.equal(coeffs, raw)
    t0 = time.perf_counter()
    rows = ref.nms(pred, coeffs, 0.001, 0.6, 300, 30720)
    assert time.perf_counter() - t0 < 60
    for b, r in enumerate(rows):
        assert torch.equal(torch.from_numpy(r[:, 7:]), coeffs[b, r[:, 6].astype(np.int64)])
