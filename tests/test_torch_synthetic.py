"""yolov5_tpu_torch.data.synthetic against yolov5_tpu.data.synthetic: on the
same seed both write the same files, byte for byte, and return the same
config (its paths under each one's own root)."""

from pathlib import Path

import pytest

from yolov5_tpu.data import synthetic as jax_synthetic
from yolov5_tpu_torch.data import synthetic


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _same_tree(a: Path, b: Path):
    fa, fb = _files(a), _files(b)
    assert fa and sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name


@pytest.mark.parametrize("segments", [False, True])
def test_shapes_dataset_matches_jax(tmp_path, segments):
    kw = dict(n_images=6, img_size=64, seed=3, segments=segments,
              splits=(("train", 1.0), ("val", 0.5)))
    got = synthetic.generate_shapes_dataset(tmp_path / "port", **kw)
    ref = jax_synthetic.generate_shapes_dataset(tmp_path / "jax", **kw)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert got == {k: (v.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                       if isinstance(v, str) else v) for k, v in ref.items()}
    assert got["nc"] == 3 and got["names"] == dict(enumerate(synthetic.CLASSES))
    labels = (tmp_path / "port" / "labels" / "val").glob("*.txt")
    widths = {len(row.split()) for p in labels for row in p.read_text().split("\n") if row}
    # polygons of 3, 4 or 16 points; or boxes
    assert widths and widths <= ({7, 9, 33} if segments else {5})


def test_classify_dataset_matches_jax(tmp_path):
    got = synthetic.generate_classify_dataset(tmp_path / "port", n_per_class=3, img_size=48,
                                              seed=5)
    ref = jax_synthetic.generate_classify_dataset(tmp_path / "jax", n_per_class=3, img_size=48,
                                                  seed=5)
    assert got == str(tmp_path / "port") and ref == str(tmp_path / "jax")
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(_files(tmp_path / "port")) == 2 * 3 * len(synthetic.CLASSES)
    assert synthetic.CLASSES == jax_synthetic.CLASSES
