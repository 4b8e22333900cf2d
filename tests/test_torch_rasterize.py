"""The loader's host rasterizer (``data.dataset.rasterize_masks``), which
fills an image's polygons inside the frame together (``cv.polygon_pixels``)
and one with a vertex outside it alone (``cv.fill_poly``'s clipping),
against a loop of ``cv.fill_poly`` over the polygons in descending order of
``cv2.contourArea``; and the span ``load.square``'s count of the polygons
that took the clipped path. Masks exact, in both forms."""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from tests.torch_port_helpers import write_polygon_dataset
from yolov5_tpu_torch.data import dataset
from yolov5_tpu_torch.data.cv import contour_areas, fill_poly
from yolov5_tpu_torch.data.dataset import create_loader
from yolov5_tpu_torch.utils import profile as prof


def _fill_loop(segments, labels, hm, wm, img_px, overlap):
    """The rasterizer as a loop: one ``fill_poly`` a polygon, largest float
    area first (ties as ``np.argsort`` breaks them), polygon i written as
    i + 1."""
    out = (np.zeros((hm, wm), np.int32) if overlap
           else np.zeros((max(len(labels), 1), hm, wm), np.uint8))
    polys, areas = [], []
    for seg in segments:
        p = seg.copy()
        p[:, 0] *= wm / img_px
        p[:, 1] *= hm / img_px
        polys.append(p.astype(np.int32))
        areas.append(cv2.contourArea(p.astype(np.float32)))
    for i in np.argsort(-np.asarray(areas)) if areas else []:
        if overlap:
            fill_poly(out, polys[i], int(i) + 1)
        else:
            fill_poly(out[i], polys[i], 1)
    return out


def _star(rng, n_vertices, span, radius):
    """A star-shaped polygon of float vertices inside [0, span)²."""
    c = rng.uniform(radius, span - radius, 2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n_vertices))
    rad = radius * rng.uniform(0.3, 1.0, n_vertices)
    return np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1)


def _image(kind, rng):
    """(segments in pixels of a 128² image, at 32² mask pixels) of one case."""
    img_px, cell = 128, 4.0  # a mask pixel is 4 image pixels
    n = int(rng.integers(1, 8))
    if kind == "self_intersecting":  # random vertex orders cross themselves
        segs = [rng.uniform(0, img_px, (int(rng.integers(4, 13)), 2)) for _ in range(n)]
    elif kind in ("one_vertex", "two_vertices", "three_vertices"):
        v = ("one_vertex", "two_vertices", "three_vertices").index(kind) + 1
        segs = [rng.uniform(0, img_px, (v, 2)) for _ in range(n)]
    elif kind == "axis_edges":  # staircases: horizontal and vertical sides, collinear runs
        segs = []
        for _ in range(n):
            x0, y0 = rng.integers(0, 20, 2)
            steps = rng.integers(1, 5, 3)
            xs = x0 + np.concatenate([[0], np.cumsum(steps)])
            ys = y0 + np.concatenate([[0], np.cumsum(steps[::-1])])
            upper = [(x, y) for a, b, y in zip(xs[:-1], xs[1:], ys[:-1]) for x in (a, (a + b) / 2, b)]
            p = np.asarray(upper + [(xs[-1], ys[-1]), (x0, ys[-1])], float)
            segs.append(p * cell)
    elif kind == "tied_areas":  # copies of two polygons, moved by whole mask pixels, overlapping
        bases = [np.floor(rng.uniform(0, 12, (int(rng.integers(3, 9)), 2))) for _ in range(2)]
        segs = [(bases[int(rng.integers(0, 2))] + rng.integers(0, 18, 2)) * cell
                for _ in range(int(rng.integers(2, 40)))]
    elif kind == "borders":  # vertices on rows and columns 0 and 31
        segs = []
        for _ in range(n):
            p = np.floor(rng.uniform(0, 32, (int(rng.integers(3, 9)), 2)))
            p[rng.random(len(p)) < 0.5, 0] = rng.choice([0, 31])
            p[rng.random(len(p)) < 0.5, 1] = rng.choice([0, 31])
            segs.append(p * cell + rng.uniform(0, cell, p.shape) * (rng.random() < 0.5))
    elif kind == "outside":  # some polygons reach past the frame, the rest stay inside
        segs = [_star(rng, int(rng.integers(3, 20)), img_px, 30) for _ in range(n)]
        segs += [rng.uniform(-40, img_px + 40, (int(rng.integers(3, 20)), 2)) for _ in range(n)]
        for _ in range(n):  # one vertex a mask pixel past a border: -1 or 32 once truncated
            p = _star(rng, int(rng.integers(3, 20)), img_px, 30)
            p[0, int(rng.integers(0, 2))] = rng.choice([-5.0, img_px + 1.0])
            segs.append(p)
    elif kind == "empty":
        segs = []
    else:
        raise ValueError(kind)
    return [np.asarray(s, np.float32) for s in segs]


KINDS = ["self_intersecting", "one_vertex", "two_vertices", "three_vertices", "axis_edges",
         "tied_areas", "borders", "outside", "empty"]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_rasterize_masks_equals_fill_poly_loop(kind, overlap):
    rng = np.random.default_rng(KINDS.index(kind))
    clipped = inside = 0
    for _ in range(40):
        segs = _image(kind, rng)
        labels = np.zeros((len(segs), 5), np.float32)
        got = dataset.rasterize_masks(segs, labels, 32, 32, 128, overlap=overlap)
        want = _fill_loop(segs, labels, 32, 32, 128, overlap)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str([s.tolist() for s in segs]))
        if segs:
            outside = dataset._mask_polygons(segs, 32, 32, 128)[3]
            clipped += outside.sum()
            inside += (~outside).sum()
    if kind == "outside":  # both paths, interleaved in the painting order
        assert clipped > 40 and inside > 40
    elif kind != "empty":
        assert clipped == 0 and inside > 0
    if kind == "tied_areas":
        s = [np.asarray(p, np.float32) / 4 for p in _image(kind, rng)]
        areas = contour_areas(np.concatenate(s), [len(p) for p in s])
        assert len(set(areas.tolist())) <= 2 < len(areas)


@pytest.mark.parametrize("overlap", [True, False])
def test_rasterize_masks_at_the_segval_cell_scale(overlap):
    """1-15 star polygons of 32 vertices an image, 640 px to 160² mask
    pixels, as the segmentation validation cell draws them."""
    rng = np.random.default_rng(19)
    for _ in range(16):
        segs = [_star(rng, 32, 640, float(rng.uniform(8, 200))).astype(np.float32)
                for _ in range(int(rng.integers(1, 16)))]
        labels = np.zeros((len(segs), 5), np.float32)
        np.testing.assert_array_equal(
            dataset.rasterize_masks(segs, labels, 160, 160, 640, overlap=overlap),
            _fill_loop(segs, labels, 160, 160, 640, overlap))


def test_load_square_counts_clipped_polygons(tmp_path):
    """Square validation batches with masks, some polygons reaching past the
    frame: ``load.square`` counts as ``clipped`` each polygon with a vertex
    outside the mask frame, and the batches' masks equal the loop's."""
    size = 64
    write_polygon_dataset(tmp_path, [(size, size)] * 5, seed=3)
    rng = np.random.default_rng(7)
    want_clipped = 0
    for i in range(5):
        rows = []
        for j in range(int(rng.integers(1, 5))):
            p = _star(rng, int(rng.integers(3, 12)), 1.0, 0.2)
            if j % 2:  # a vertex past a border: whole mask pixels outside
                p[0] = rng.choice([[-0.3, p[0, 1]], [1.3, p[0, 1]], [p[0, 0], 1.3]])
                want_clipped += 1
            rows.append("0 " + " ".join(f"{v:.6f}" for v in p.ravel()))
        (tmp_path / "labels" / "val" / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    ds, loader = create_loader(str(tmp_path / "images" / "val"), img_size=size, batch_size=5,
                               workers=2, masks=True)
    with prof.recording() as spans:
        batches = list(loader)
    square = [s for s in spans if s.name == "load.square"]
    assert len(square) == len(batches) == 1 and want_clipped > 0
    assert square[0].counts["clipped"] == want_clipped
    assert square[0].counts["polygons"] == sum(len(s) for s in ds.segments)
    for b, i in enumerate(batches[0]["indices"]):
        _, labels, segs = ds.get_item(int(i), np.random.default_rng(0))
        np.testing.assert_array_equal(batches[0]["masks"][b],
                                      _fill_loop(segs, labels, size // 4, size // 4, size, True))
