"""The port's hyperparameter sweep (``yolov5_tpu_torch.train.hpo`` and the
CLI ``python -m yolov5_tpu_torch.hpo``) against the JAX package's
(``yolov5_tpu.train.hpo``): equal draws for the same config and seed, equal
``hpo.csv`` and ``hyp_hpo.yaml`` for the same trials, the Comet and ClearML
backends through fake SDKs, and a real 2-trial sweep of the port's
``train.run`` on the CPU."""

import json
import sys
import types
from pathlib import Path

import pytest
import yaml

from yolov5_tpu.train import hpo as JH
from yolov5_tpu_torch.train import hpo as PH

REPO = Path(__file__).resolve().parents[1]
SWEEP = REPO / "yolov5_tpu" / "train" / "sweep_example.json"

CONFIG = {
    "algorithm": "random",
    "spec": {"metric": "fitness", "objective": "maximize", "maxCombo": 6},
    "parameters": {
        "lr0": {"type": "float", "min": 0.001, "max": 0.1},
        "warmup_epochs": {"type": "integer", "min": 0, "max": 3},
        "box": {"type": "discrete", "values": [0.02, 0.2]},
        "epochs": {"type": "discrete", "values": [3]},
        "batch_size": {"type": "discrete", "values": [8]},
    },
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("config", [CONFIG, str(SWEEP), {
    "algorithm": "grid",
    "parameters": {"a": {"values": [1, 2]}, "b": {"type": "float", "min": 0, "max": 1}}}],
    ids=["random", "example_json", "grid"])
def test_sample_parameters_equal_jax(config, seed):
    cfg_p = config if isinstance(config, dict) else PH.load_sweep(config)
    cfg_j = config if isinstance(config, dict) else JH.load_sweep(config)
    assert cfg_p == cfg_j
    got = list(PH.sample_parameters(cfg_p, seed=seed))
    assert got == list(JH.sample_parameters(cfg_j, seed=seed))
    assert got and got == list(PH.sample_parameters(cfg_p, seed=seed))


def test_load_sweep_reads_yaml_and_refuses_a_config_without_parameters(tmp_path):
    (tmp_path / "s.yaml").write_text(yaml.safe_dump({"parameters": {"a": {"values": [1]}}}))
    assert PH.load_sweep(tmp_path / "s.yaml") == JH.load_sweep(tmp_path / "s.yaml") == {
        "parameters": {"a": {"values": [1]}}, "algorithm": "random", "spec": {}}
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError, match="parameters"):
        PH.load_sweep(tmp_path / "bad.json")


def _fake_train(calls):
    def train(data, cfg, hyp, epochs, batch_size, imgsz, save_dir, nosave, **kw):
        calls.append({"hyp": dict(hyp), "epochs": epochs, "batch_size": batch_size,
                      "save_dir": Path(save_dir).name, "nosave": nosave, **kw})
        fit = round(0.1 * len(calls) * (1 + hyp["lr0"]), 6)
        return fit, {"fitness": fit, "map50": fit / 2}, None
    return train


@pytest.mark.parametrize("objective", ["maximize", "minimize"])
def test_run_sweep_writes_the_jax_files(tmp_path, objective):
    """The same trials through both drivers: equal hpo.csv and
    hyp_hpo.yaml, the sweep's epochs/batch_size overriding the defaults and
    its other values going into the hyps."""
    config = {**CONFIG, "spec": {**CONFIG["spec"], "objective": objective, "metric": "map50"}}
    out = {}
    for mod in (PH, JH):
        calls = []
        best = mod.run_sweep(data="d.yaml", sweep=config, cfg="yolov5n", epochs=99,
                             batch_size=99, save_dir=tmp_path / mod.__name__,
                             train_fn=_fake_train(calls))
        out[mod] = (best, calls, (tmp_path / mod.__name__ / "hpo.csv").read_text(),
                    (tmp_path / mod.__name__ / "hyp_hpo.yaml").read_text())
    assert out[PH] == out[JH]
    (best_params, best_obj), calls, csv_text, hyp_text = out[PH]
    assert len(calls) == 6 and all(c["epochs"] == 3 and c["batch_size"] == 8 for c in calls)
    assert all("lr0" in c["hyp"] and "epochs" not in c["hyp"] and c["nosave"] for c in calls)
    assert [c["save_dir"] for c in calls] == [f"trial{t}" for t in range(6)]
    lines = csv_text.splitlines()
    assert len(lines) == 7 and lines[0].startswith("trial,map50")
    objs = [float(line.split(",")[1]) for line in lines[1:]]
    assert best_obj == (max(objs) if objective == "maximize" else min(objs))
    assert yaml.safe_load(hyp_text)["lr0"] == best_params["lr0"]


def test_comet_backend_with_fake_sdk(monkeypatch, tmp_path):
    """--backend comet takes the parameter sets from comet_ml.Optimizer."""
    served = [{"parameters": {"lr0": 0.01, "epochs": 2}},
              {"parameters": {"lr0": 0.05, "epochs": 2}}]

    class _Optimizer:
        def __init__(self, cfg):
            self.cfg = cfg

        def get_parameters(self):
            yield from served

    comet = types.ModuleType("comet_ml")
    comet.Optimizer = _Optimizer
    monkeypatch.setitem(sys.modules, "comet_ml", comet)
    calls = []
    PH.run_sweep(data="d.yaml", sweep={"parameters": {"lr0": {"values": [0]}}},
                 save_dir=tmp_path / "hpo", backend="comet", train_fn=_fake_train(calls))
    assert [(c["hyp"]["lr0"], c["epochs"]) for c in calls] == [(0.01, 2), (0.05, 2)]


def test_clearml_backend_with_fake_sdk(monkeypatch, tmp_path):
    """--backend clearml wraps each trial in a ClearML Task reporting the
    objective."""
    events = []

    class _Logger:
        def report_scalar(self, title, series, value, iteration=None):
            events.append(("scalar", title, series, value, iteration))

    class _Task:
        @staticmethod
        def init(**kw):
            events.append(("init", kw["task_name"]))
            return _Task()

        def connect(self, params, name=None):
            events.append(("connect", sorted(params), name))

        def get_logger(self):
            return _Logger()

        def close(self):
            events.append(("close",))

    clearml = types.ModuleType("clearml")
    clearml.Task = _Task
    monkeypatch.setitem(sys.modules, "clearml", clearml)
    calls = []
    config = {"parameters": {"lr0": {"values": [0.01, 0.02]}}, "spec": {"maxCombo": 2}}
    PH.run_sweep(data="d.yaml", sweep=config, save_dir=tmp_path / "hpo", backend="clearml",
                 train_fn=_fake_train(calls))
    assert [e for e in events if e[0] == "init"] == [("init", "trial0"), ("init", "trial1")]
    assert sum(e[0] == "scalar" and e[1:3] == ("metrics", "fitness") for e in events) == 2
    assert events.count(("close",)) == 2


def test_cli_runs_a_two_trial_sweep_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``python -m yolov5_tpu_torch.hpo``: 2 trials of the port's train.run
    (1 epoch each), hpo.csv with 2 rows, hyp_hpo.yaml, and the JSON line."""
    from tests.torch_port_helpers import write_shapes_dataset
    from yolov5_tpu_torch.hpo import main

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    write_shapes_dataset(tmp_path / "data", [(64, 64)] * 4, ext=".bmp", split="train")
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"train": str(tmp_path / "data" / "images" / "train"),
                                    "val": str(tmp_path / "data" / "images" / "train"),
                                    "nc": 3}))
    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps({"spec": {"maxCombo": 2}, "parameters": {
        "lr0": {"type": "float", "min": 0.001, "max": 0.01}, "epochs": {"values": [1]}}}))
    main(["--data", str(data), "--sweep", str(sweep), "--imgsz", "64", "--batch-size", "2",
          "--project", str(tmp_path / "hpo"), "--name", "s", "--device", "cpu", "--dtype",
          "float32", "--workers", "1", "--device-aug"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run_dir = tmp_path / "hpo" / "s"
    assert len((run_dir / "hpo.csv").read_text().splitlines()) == 3
    assert yaml.safe_load((run_dir / "hyp_hpo.yaml").read_text())["lr0"] == \
        out["best_params"]["lr0"]
    assert (run_dir / "trial1" / "results.csv").exists()
