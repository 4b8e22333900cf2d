"""Hyperparameter sweep driver: the cloud-HPO analog.

The port of ``yolov5_tpu/train/hpo.py``, driving the port's ``train.run``
(``tests/test_torch_hpo.py`` holds its draws and files equal to the JAX
module's). It replaces the reference's Comet Optimizer driver
(utils/loggers/comet/hpo.py:83-119: pull parameter sets from an optimizer,
train once per set) and the ClearML HyperParameterOptimizer recipe
(utils/loggers/clearml/hpo.py) with one engine in three modes:

- **local** (default, no network): a built-in random/grid sampler over a
  Comet-schema sweep config (`optimizer_config.json` style: `algorithm`,
  `spec.metric/objective/maxCombo`, `parameters` with discrete values or
  min/max ranges).
- **comet**: when `comet_ml` is importable and the config carries an API
  key / optimizer id, parameter sets come from a real `comet_ml.Optimizer`
  (the service does the bayes/random search; we run the trials).
- **clearml**: each trial is additionally wrapped in a ClearML Task,
  giving the HyperParameterOptimizer UI the same per-trial series the
  reference recipe expects.

Every trial trains with ``yolov5_tpu_torch.train.run.run`` and reports the
objective (`fitness` or a metric key from the sweep spec); results append
to ``hpo.csv`` and the best hyp set is written to ``hyp_hpo.yaml``.
"""

from __future__ import annotations

import csv
import itertools
import json
from pathlib import Path

import numpy as np

from yolov5_tpu_torch.utils.hyp import load_hyp

# keys that override training options rather than hyps (reference
# comet hpo.py:85-90 pops exactly these two from the parameter set)
OPT_KEYS = ("epochs", "batch_size")


def load_sweep(path) -> dict:
    """Read a Comet-Optimizer-schema sweep config (json or yaml)."""
    p = Path(path)
    text = p.read_text()
    if p.suffix in (".yml", ".yaml"):
        import yaml

        cfg = yaml.safe_load(text)
    else:
        cfg = json.loads(text)
    if "parameters" not in cfg:
        raise ValueError(f"sweep config {path} has no 'parameters' table")
    cfg.setdefault("algorithm", "random")
    cfg.setdefault("spec", {})
    return cfg


def _domain(name, spec):
    """Normalize one parameter spec to ('discrete', values) or
    ('range', lo, hi, is_int)."""
    t = spec.get("type", "discrete")
    if "values" in spec:
        return ("discrete", list(spec["values"]))
    lo = spec.get("min", spec.get("mn"))
    hi = spec.get("max", spec.get("mx"))
    if lo is None or hi is None:
        raise ValueError(f"parameter {name}: need 'values' or 'min'/'max'")
    return ("range", float(lo), float(hi), t in ("integer", "int"))


def sample_parameters(config, seed=0, max_combo=None):
    """Yield parameter dicts per the config's algorithm.

    grid: cartesian product of discrete values (range params get 3 points);
    random: independent draws, `max_combo` trials (spec.maxCombo, default 10).
    """
    params = {k: _domain(k, v) for k, v in config["parameters"].items()}
    algo = config.get("algorithm", "random")
    spec = config.get("spec", {})
    n = max_combo or int(spec.get("maxCombo", 0)) or 10

    if algo == "grid":
        axes = []
        for k, d in params.items():
            if d[0] == "discrete":
                axes.append([(k, v) for v in d[1]])
            else:
                _, lo, hi, is_int = d
                pts = np.linspace(lo, hi, 3)
                axes.append([(k, int(v) if is_int else float(v)) for v in pts])
        combos = itertools.product(*axes)
        if max_combo:
            combos = itertools.islice(combos, max_combo)
        for combo in combos:
            yield dict(combo)
        return

    rng = np.random.default_rng(seed)
    for _ in range(n):
        out = {}
        for k, d in params.items():
            if d[0] == "discrete":
                out[k] = d[1][int(rng.integers(len(d[1])))]
            else:
                _, lo, hi, is_int = d
                v = float(rng.uniform(lo, hi))
                out[k] = int(round(v)) if is_int else v
        yield out


def _comet_parameters(config):
    """Pull parameter sets from a live comet_ml.Optimizer (reference
    hpo.py:104-119). Yields the same dicts the local sampler would."""
    import comet_ml

    opt_id = config.get("optimizer_id")
    optimizer = comet_ml.Optimizer(opt_id if opt_id else config)
    for trial in optimizer.get_parameters():
        yield trial["parameters"]


def run_sweep(data, sweep, cfg="yolov5n", hyp=None, epochs=10, batch_size=16,
              imgsz=320, save_dir="runs/hpo/exp", seed=0, backend="local",
              train_kwargs=None, train_fn=None):
    """Run the sweep; returns (best_params, best_objective).

    backend: 'local' | 'comet' | 'clearml'. 'comet' sources parameters from
    the Comet Optimizer service; 'clearml' uses the local sampler but wraps
    each trial in a ClearML Task (HyperParameterOptimizer-compatible).
    train_fn: injection point for tests (defaults to the port's
    ``train.run.run``).
    """
    if train_fn is None:
        from yolov5_tpu_torch.train.run import run as train_fn

    config = sweep if isinstance(sweep, dict) else load_sweep(sweep)
    spec = config.get("spec", {})
    metric = spec.get("metric", "fitness")
    sign = -1.0 if spec.get("objective", "maximize") == "minimize" else 1.0

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    csv_path = save_dir / "hpo.csv"
    base = load_hyp(hyp)

    if backend == "comet":
        trials = _comet_parameters(config)
    else:
        trials = sample_parameters(config, seed=seed)

    history = []  # (objective, params)
    for t, params in enumerate(trials):
        hyp_t = {**base, **{k: v for k, v in params.items() if k not in OPT_KEYS}}
        task = None
        if backend == "clearml":
            import clearml

            task = clearml.Task.init(project_name="yolov5_tpu-hpo",
                                     task_name=f"trial{t}",
                                     reuse_last_task_id=False)
            task.connect(dict(params), name="Hyperparameters")
        fitness, results, _ = train_fn(
            data=data, cfg=cfg, hyp=hyp_t,
            epochs=int(params.get("epochs", epochs)),
            batch_size=int(params.get("batch_size", batch_size)),
            imgsz=imgsz, save_dir=save_dir / f"trial{t}", nosave=True,
            **(train_kwargs or {}),
        )
        obj = float(results.get(metric, fitness) if isinstance(results, dict)
                    else fitness)
        if task is not None:
            task.get_logger().report_scalar("metrics", metric, obj, iteration=t)
            task.close()
        history.append((sign * obj, params, obj))

        keys = sorted({k for _, p, _ in history for k in p})
        write_header = not csv_path.exists()
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["trial", metric] + keys)
            if write_header:
                w.writeheader()
            w.writerow({"trial": t, metric: obj,
                        **{k: params.get(k, "") for k in keys}})
        best = max(history, key=lambda r: r[0])[2]
        print(f"hpo trial {t}: {metric} {obj:.4f} (best {best:.4f})")

    if not history:
        raise RuntimeError("sweep produced no trials")
    _, best_params, best_obj = max(history, key=lambda r: r[0])
    import yaml

    best_hyp = {**base, **{k: v for k, v in best_params.items()
                           if k not in OPT_KEYS}}
    (save_dir / "hyp_hpo.yaml").write_text(yaml.safe_dump(best_hyp))
    return best_params, best_obj
