"""The readings that set a cell's limits: the program's compared numbers
and its control's over several seeds, in one process.

    python3 h100_bench/control.py --workload <cell> --seeds 1 2 3 ... --seconds 5

Each seed runs the cell for a short window (its own chain count and
solver) and then compares, at the window's final states, against the
float64 reference: the program's values (what a benchmark run compares),
the control's (the reference in float32 with its contact product in TF32,
put in the program's place), and the reference in plain float32 (a second
witness of what float32 alone does). It also evaluates the program's own
objective in float64 at the same states. One JSON line a seed on standard
output, with the quantiles of the per-chain gaps. The benchmark's runs do
not run this.
"""

import time

T0 = time.perf_counter()

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np
import torch

from h100_bench import check, run


def _gaps(v, vr):
    ok = torch.isfinite(v) & torch.isfinite(vr) & (v > check.FLOOR)
    return check.scaled_gaps(v[ok], vr[ok]).numpy()


def _q(g):
    if not len(g):
        return None
    return {"median": float(np.median(g)), "p99": float(np.quantile(g, 0.99)),
            "max": float(g.max())}


def readings(final, config, cell, dev, num_days):
    """The control's numbers and the witnesses' gaps at ``final``."""
    root = os.path.join(HERE, config["data"])
    block = int(cell["ref_block"])
    ref = lambda **kw: check.reference_for(config, root, device=dev,
                                           num_days=num_days, **kw)
    x = final["x"]
    vr = check.values(ref(), x, block)
    out = {"program_gaps": _q(_gaps(final["logp"].double().cpu(), vr))}
    for name, tf32 in (("control", True), ("float32", False)):
        vc = check.values(ref(dtype=torch.float32, tf32=tf32), x, block)
        swapped = dict(final, logp=torch.nan_to_num(vc, nan=-1e18).to(x.device))
        nums, _ = check.numbers(swapped, vr, cell["limits"])
        nums["value_gaps"] = _q(_gaps(vc, vr))
        out[name] = nums
    from h100_bench import program
    s64 = program.Setup(dict(config, dtype="float64"), dev, num_days=num_days)
    with torch.no_grad():
        v64 = s64.objective()(x.to(torch.float64)).double().cpu()
    out["program_float64_gaps"] = _q(_gaps(v64, vr))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        out = run.execute(args.workload, seed, args.seconds, False, extra=readings)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": {k: v["value"] for k, v in out["checks"].items()},
                          **out["extra"], "window": out["window"],
                          "draws_per_s": out["metrics"]["draws_per_s"]["value"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
