"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the root
of the checkout, and beside it under ``perfbench/``

  configs/<file named by the config entry>   the configuration (JSON) and
                                             its frozen YAML
  traffic/<traffic>.json                     a traffic mix: its runner's
                                             ``kind`` and parameters
  runners/<kind>.py                          one runner per kind, ``run(ctx)``
  limits/<cell>.json                         the limits of a cell's comparison
  metrics/<metric>.py                        one reader per per-layer metric,
                                             ``read(result) -> float | None``

so that a later cell, traffic mix, configuration or metric is new files and
entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file, with "yaml" as a path
    traffic_name: str
    traffic: dict  # the traffic file
    limits: dict  # {number: limit}
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list,
    else every cell (an end-to-end metric) or every cell that reports the
    end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(name: str, root=ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of the benchmark at ``root`` with everything it names."""
    root = Path(root)
    bench = bench or benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf_entry["file"])
    config["yaml"] = str((root / conf_entry["file"]).parent / config["yaml"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits_path = root / "perfbench" / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic, limits,
                e2e, per_layer)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(kind: str, pkg=PKG):
    """The runner module of a traffic kind."""
    path = Path(pkg) / "runners" / f"{kind}.py"
    if not path.exists():
        raise FileNotFoundError(f"no runner for traffic kind {kind!r} at {path}")
    return _module(path, f"perfbench_runner_{kind}")


def metric_reader(name: str, pkg=PKG):
    """The reader module of a per-layer metric, or None where it has none."""
    path = Path(pkg) / "metrics" / f"{name}.py"
    return _module(path, "perfbench_metric_" + name.replace(".", "_")) if path.exists() else None


def check_names(bench: dict) -> list[str]:
    """What in ``bench`` breaks the rules on names and units (empty if none)."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            if not NAME.match(e["name"]):
                bad.append(f"{group}: name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(f"{group}: unit {e['unit']!r}")
    for w in bench["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                bad.append(f"workload {w['name']}: {k} {w[k]!r}")
    for c in bench["configs"]:
        bad += [f"config {c['name']}: reduced {k!r}" for k in c["reduced"] if not NAME.match(k)]
    return bad
