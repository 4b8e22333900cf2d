"""The benchmark's definition: every file it names loads, names and units
keep to their characters, and a cell, traffic mix, configuration and
per-layer metric are added as files and entries alone."""

from __future__ import annotations

import json
import shutil

import pytest

from perfbench.core import spec

BENCH = spec.benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_benchmark_keys_and_names():
    assert set(BENCH) == KEYS
    assert spec.check_names(BENCH) == []
    assert BENCH["paths"] == ["perfbench"]
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    assert spec.runner(cell.traffic["kind"]).Runner
    assert cell.limits, "a cell's comparison needs its limits"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert spec.metric_reader(m["name"]) is not None


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    from perfbench.reference import yolo

    c = spec.load_json(spec.ROOT / conf["file"])
    y = yolo.load_yaml(spec.ROOT / conf["file"].rsplit("/", 1)[0] / c["yaml"])
    for k in ("nc", "depth_multiple", "width_multiple", "anchors"):
        assert y[k] == c[k], k
    assert c["source"] == conf["source"]
    assert conf["reduced"] == []


def test_metric_reports_where_it_reads():
    """A per-layer metric's workloads report the end-to-end metric it moves."""
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in spec.cell(w).end_to_end}


def test_additions_need_no_edit(tmp_path):
    """A new configuration, traffic mix (with its runner), cell and
    per-layer metric, added as files and entries to a copy, are found and
    run through the same code."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.PKG, root / "perfbench", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    pkg = root / "perfbench"
    conf = json.loads((pkg / "configs" / "yolov5s.json").read_text())
    conf["yaml"] = "yolov5m.yaml"
    conf["depth_multiple"], conf["width_multiple"] = 0.67, 0.75
    (pkg / "configs" / "yolov5m.json").write_text(json.dumps(conf))
    y = (pkg / "configs" / "yolov5s.yaml").read_text()
    (pkg / "configs" / "yolov5m.yaml").write_text(
        y.replace("depth_multiple: 0.33", "depth_multiple: 0.67")
         .replace("width_multiple: 0.5", "width_multiple: 0.75"))
    (pkg / "traffic" / "echo-b4.json").write_text(json.dumps({"kind": "echo", "n": 4}))
    (pkg / "runners" / "echo.py").write_text(
        "class Runner:\n    pass\n\n\ndef run(ctx):\n"
        "    return {'layer': {'n': ctx.cell.traffic['n']}}\n")
    (pkg / "metrics" / "echo_n.py").write_text(
        "def read(result):\n    return result['layer']['n']\n")
    (pkg / "limits" / "yolov5m.echo-b4.json").write_text(json.dumps({"n": 4}))
    bench["configs"].append({"name": "yolov5m", "source": "https://example.org/yolov5m.yaml",
                             "file": "perfbench/configs/yolov5m.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "yolov5m.echo-b4", "config": "yolov5m",
                               "traffic": "echo-b4", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "echo_n", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "echo", "moves": "setup_s",
                               "workloads": ["yolov5m.echo-b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("yolov5m.echo-b4", root=root)
    assert cell.config["depth_multiple"] == 0.67
    assert [m["name"] for m in cell.per_layer] == ["echo_n"]
    assert cell.limits == {"n": 4}

    class Ctx:
        pass

    ctx = Ctx()
    ctx.cell = cell
    result = spec.runner("echo", pkg=pkg).run(ctx)
    assert spec.metric_reader("echo_n", pkg=pkg).read(result) == 4
    from perfbench.core import flops
    from perfbench.reference import yolo

    g = 2 * flops.conv_macs(yolo.load_yaml(cell.config["yaml"]), 640, 640, bn=True) / 1e9
    assert g == pytest.approx(49.0, rel=0.01)  # yolov5m's published 49.0 GFLOPs
