"""Run one cell of the benchmark once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``yolov5_tpu_torch``).
The cell's traffic file names its runner; the runner makes the inputs and
weights from the seed, warms the cell's shapes, measures for ``--seconds``
and compares what the timed path produced with the plain reference. With
``--trace 1`` a traced stretch follows the window and the cell's per-layer
metrics are read from it; otherwise the end-to-end metrics are printed.
Each number compared is printed beside its limit, last on standard error
and last in the result. A run without the cards the cell needs, or that
finds JAX, TensorFlow or the JAX package imported, exits 1 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
if str(PKG.parent) not in sys.path:
    sys.path.insert(0, str(PKG.parent))

from perfbench.core import env  # noqa: E402

env.prepare(PKG)


@dataclass
class Context:
    """What a runner is given."""

    cell: object  # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float = T_START
    notes: list = field(default_factory=list)

    def note(self, **kv):
        """An informational line, printed before the result."""
        self.notes.append(kv)


def per_layer(cell, result: dict) -> dict:
    """The cell's per-layer metrics that their readers find something for."""
    from perfbench.core import spec

    out = {}
    for m in cell.per_layer:
        reader = spec.metric_reader(m["name"])
        value = reader.read(result) if reader else None
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def assemble(cell, result: dict, trace: bool, device_info: dict) -> dict:
    """The result line: correct, attempted, failed, metrics, device, and the
    numbers compared with their limits under ``checks``, last."""
    checks = {}
    for name, limit in cell.limits.items():
        value = result["readings"].get(name)
        checks[name] = {"value": value, "limit": limit}
    correct = (result["failed"] == 0 and bool(checks)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    if trace:
        metrics = per_layer(cell, result)
        device = dict(device_info, busy_s=result["trace"]["busy_s"],
                      window_s=result["trace"]["window_s"])
    else:
        metrics = {m["name"]: {"value": float(result["metrics"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
        device = device_info
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = result["trace"]["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from perfbench.core import spec

    cell = spec.cell(a.workload)
    import torch

    missing = env.require_cards(cell.chips)
    if missing:
        print(f"perfbench: no result: {missing}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(cell, a.seed, a.seconds, bool(a.trace), device)
    result = spec.runner(cell.traffic["kind"]).run(ctx)
    found = env.forbidden_modules()
    if found:
        print(f"perfbench: no result: imported {', '.join(found)}", file=sys.stderr)
        return 1
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
            "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line = assemble(cell, result, ctx.trace, info)
    for n in ctx.notes:
        print(json.dumps({"note": n}))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
