"""The readings that a cell's limits are set from: for each seed, the
program's numbers compared (its timed path over a short window) and the
control's (the plain reference in the program's place, one precision
lower: float8 where the cell runs bfloat16), in one process.

    python3 perfbench/control.py --workload <cell> --seconds 2 --seeds 11 12 13

Prints one JSON line per seed, then the largest program reading and the
smallest control reading of each number. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
if str(PKG.parent) not in sys.path:
    sys.path.insert(0, str(PKG.parent))

from perfbench.core import env  # noqa: E402

env.prepare(PKG)


def readings(ctx, runner_mod, control: bool = True, witness: bool = False) -> dict:
    """{"program": readings, "control": readings} of one seed; with
    ``witness`` also the reference's own bfloat16 run in the program's place."""
    import torch

    d = runner_mod.Runner(ctx)
    try:
        d.prepare()
        prog = d.program()
        d.warm(prog)
        _, out = d.window(prog, ctx.seconds)
        del prog
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = d.reference()
        res = {"program": d.readings(out, ref)}
        if control:
            res["control"] = d.readings(d.control_outputs(), ref)
            if witness:
                res["witness_bf16"] = d.readings(d.control_outputs("bf16"), ref)
        return res
    finally:
        d.close()


def main(argv=None) -> int:
    from perfbench.core import spec
    from perfbench.run import Context

    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds also read the control")
    p.add_argument("--device", default="cuda", help="cuda, or cpu to rehearse")
    p.add_argument("--witness", action="store_true",
                   help="also read the reference's bfloat16 run where the control is read")
    a = p.parse_args(argv)
    import torch

    cell = spec.cell(a.workload)
    device = torch.device(a.device)
    drv = spec.runner(cell.traffic["kind"])
    worst, least = {}, {}
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        ctx = Context(cell, seed, a.seconds, False, device)
        r = readings(ctx, drv, control=i < a.control_seeds, witness=a.witness)
        for k, v in r["program"].items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in r.get("control", {}).items():
            least[k] = min(least.get(k, v), v)
        print(json.dumps({"seed": seed, **r, "notes": ctx.notes,
                          "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"program_max": worst, "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
