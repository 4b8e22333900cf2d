"""Every entry of ``hub.list_models()`` at full width: ``hub.load`` builds
it on the CPU for its task (a Detector, BN folded, or a SegmentationModel)
with every fused weight found; and a classifier cut from a zoo backbone.
No forward runs but the stride probe at 256 px (and one 64 px classifier
call)."""

import pytest
import torch

import yolov5_tpu_torch.hub as hub
from yolov5_tpu_torch.models.yolo import CONFIG_DIR, ClassificationModel, load_config


def test_list_models_is_the_config_zoo():
    """Every model YAML of the configs directory; anchors.yaml, a table of
    anchor presets, is not one."""
    names = {p.stem for p in CONFIG_DIR.glob("*.yaml")}
    assert hub.list_models() == sorted(names - {"anchors"}) and len(hub.list_models()) == 28


@pytest.mark.parametrize("name", hub.list_models())
def test_hub_load_full_width(name, capsys):
    task = "segment" if name.endswith("-seg") else "detect"
    m = hub.load(name, task=task, device="cpu")
    assert "unmatched" not in capsys.readouterr().out  # every fused key found its weight
    model = m if task == "segment" else m.model
    assert model.fused == (task == "detect")
    nl = len(load_config(name)["anchors"])
    assert len(model.stride) == nl and model.stride == tuple(sorted(model.stride))
    assert set(model.stride) <= {4, 8, 16, 32, 64, 128}


@pytest.mark.parametrize("name", ["yolov5s-ghost", "yolov5s-transformer", "yolov3"])
def test_hub_load_classifier_of_a_zoo_backbone(name):
    """A ClassificationModel cut from any config's backbone, as the JAX
    package's accepts one."""
    m = hub.load(name, task="classify", device="cpu")
    assert isinstance(m, ClassificationModel) and m.model[-1].linear.out_features == 1000
    with torch.no_grad():
        assert tuple(m(torch.zeros(1, 3, 64, 64)).shape) == (1, 1000)
