#!/usr/bin/env python3
"""Hold a post-calibration report against the committed Spain-2020 tree.

    python3 report_anchor.py --device cuda     # the port on the card
    python3 report_anchor.py --device cpu      # the port on the host
    python3 report_anchor.py --compare DIR     # compare a tree only
    python3 report_anchor_jax.py               # the JAX package, CPU

``results/spain2020/analysis/`` was written by the JAX package's
``generate_full_report`` on a TPU, in float32, from
``results/spain2020/posterior_samples.npz`` (50 000 x 62 draws) with
``num_samples_for_ppc=200, batch_size=1024, substeps=4, tableau="dopri5",
seed=0`` (``scripts/refresh_artifact.py:80-86, 144-149``). This script runs
the same call through the PyTorch port into ``--out`` and compares every
number of the compared files with the committed tree: for each value the
error is ``max(|got - ref| - u, 0) / max(|ref|, u)``, where ``u`` is one unit
of the last digit the committed file prints (both files are rounded to that
digit). It prints one JSON line: the largest error in each group of files,
where it is, and the seconds the report took. ``--check`` makes it exit 1
when a group is above its bar in ``GROUP_RTOL``.

It imports nothing of JAX or of the JAX package, so ``chip_smoke.py`` may
import it; ``report_anchor_jax.py`` runs the same call through the JAX
package and compares it with the same functions.
"""

import argparse
import glob
import json
import os
import shutil
import sys
import time
from decimal import Decimal

HERE = os.path.dirname(os.path.abspath(__file__))
COMMITTED = os.path.join(HERE, "results", "spain2020", "analysis")
SAMPLES = os.path.join(HERE, "results", "spain2020", "posterior_samples.npz")
# the arguments of scripts/refresh_artifact.py:144-149
REPORT_ARGS = dict(num_samples_for_ppc=200, batch_size=1024, substeps=4,
                   tableau="dopri5", seed=0)
GROUPS = {
    "metrics_summary": ["mcmc_aggregated/metrics_summary.csv"],
    "posterior_predictive": ["posterior_predictive/*.csv"],
    "rt_trajectories": ["rt_trajectories/*.csv"],
    "seroprevalence": ["seroprevalence/*.csv"],
    "scenarios": ["scenarios/*.csv"],
    "parameter_posteriors": ["parameter_posteriors/posterior_summary.csv"],
}
# Each group's bar, fixed from two float32 readings on the host CPU against
# the committed tree, which agreed to every digit: the JAX package
# (report_anchor_jax.py) and the port (this script, --device cpu). Both read
# posterior_predictive 2.11e-4 (one value: ICU admissions lower95, day 130,
# age 3), scenarios 8.04e-6, metrics_summary 1.28e-6, rt_trajectories
# 3.71e-7, seroprevalence 1.2e-16 and parameter_posteriors 0. A bar is about
# five times its group's reading, and no lower than 1e-5.
GROUP_RTOL = {
    "metrics_summary": 1e-5,
    "posterior_predictive": 1e-3,
    "rt_trajectories": 1e-5,
    "seroprevalence": 1e-5,
    "scenarios": 5e-5,
    "parameter_posteriors": 1e-5,
}
# written by the report but not compared, and too large to keep
BULKY = ("mcmc_batches", os.path.join("parameter_posteriors",
                                      "posterior_samples.csv"))


def _unit(text):
    """One unit of the last printed digit of a number's text."""
    return float(Decimal(1).scaleb(Decimal(text).as_tuple().exponent))


def _rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split(",") for ln in f if ln.strip()]


def compare_file(got_path, ref_path):
    """``(max error, where, values compared)`` of one CSV against the
    committed one; text cells must be equal, and so must the shape."""
    got, ref = _rows(got_path), _rows(ref_path)
    if len(got) != len(ref) or got[0] != ref[0]:
        raise ValueError(f"{ref_path}: header or row count differs "
                         f"({len(got)} vs {len(ref)} rows)")
    worst, where, n = 0.0, None, 0
    for i, (g_row, r_row) in enumerate(zip(got[1:], ref[1:]), start=1):
        if len(g_row) != len(r_row):
            raise ValueError(f"{ref_path}: row {i} has {len(g_row)} cells, "
                             f"the committed {len(r_row)}")
        for j, (g, r) in enumerate(zip(g_row, r_row)):
            try:
                rv = float(r)
            except ValueError:
                if g != r:
                    raise ValueError(f"{ref_path}: row {i} cell {j}: {g!r} "
                                     f"vs {r!r}")
                continue
            gv, u = float(g), _unit(r)
            err = max(abs(gv - rv) - u, 0.0) / max(abs(rv), u)
            n += 1
            if err > worst or where is None:
                worst, where = max(err, worst), dict(row=i, col=ref[0][j],
                                                     got=g, ref=r)
    return worst, where, n


def compare_trees(got_dir, ref_dir=COMMITTED):
    """``{group: {max_err, file, where, files, values}}`` over ``GROUPS``;
    every committed file of a group must exist in ``got_dir``."""
    out = {}
    for group, patterns in GROUPS.items():
        refs = sorted(p for pat in patterns
                      for p in glob.glob(os.path.join(ref_dir, pat)))
        if not refs:
            raise FileNotFoundError(f"no committed file for {group}")
        res = dict(max_err=0.0, file=None, where=None, files=len(refs),
                   values=0)
        for ref in refs:
            rel = os.path.relpath(ref, ref_dir)
            got = os.path.join(got_dir, rel)
            if not os.path.exists(got):
                raise FileNotFoundError(f"the report did not write {rel}")
            err, where, n = compare_file(got, ref)
            res["values"] += n
            if err >= res["max_err"]:
                res.update(max_err=err, file=rel, where=where)
        out[group] = res
    return out


def load_posterior():
    import numpy as np
    return np.load(SAMPLES)["samples"]


def run_torch(out, device, dtype_name):
    """The port's report; returns its seconds (ended by the last write)."""
    import torch
    from mmidv1_tpu_torch.analysis import generate_full_report
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    pipe = load_spain_pipeline(HERE, dtype=getattr(torch, dtype_name),
                               device=device)
    samples = load_posterior()
    t0 = time.perf_counter()
    rep = generate_full_report(samples, pipe.space, pipe.params, pipe.data,
                               pipe.ts, out, **REPORT_ARGS)
    return time.perf_counter() - t0, rep["n_draws"]


def drop_bulky(out):
    for rel in BULKY:
        p = os.path.join(out, rel)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


def over_bar(groups):
    """The groups whose largest error is above their bar, with both."""
    return {g: (r["max_err"], GROUP_RTOL[g]) for g, r in groups.items()
            if not r["max_err"] <= GROUP_RTOL[g]}


def run_and_compare(engine, run, out, check):
    """Run ``run(out) -> (seconds, draws)`` (unless ``out`` is to be
    compared only), compare the tree, print the JSON line; the exit code."""
    result = dict(engine=engine)
    if run is not None:
        seconds, n = run(out)
        drop_bulky(out)
        result.update(seconds=seconds, draws=n, draws_per_s=n / seconds,
                      out=out)
    result["groups"] = compare_trees(out)
    result["max_err"] = max(g["max_err"] for g in result["groups"].values())
    result["over_bar"] = over_bar(result["groups"])
    print(json.dumps(result), flush=True)
    if check and result["over_bar"]:
        print(f"report_anchor: above the bar: {result['over_bar']}",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--out", default=None,
                   help="default chiprun_out/report_anchor_torch_<device>")
    p.add_argument("--compare", default=None,
                   help="compare this existing tree; run nothing")
    p.add_argument("--check", action="store_true",
                   help="exit 1 when a group is above its bar")
    a = p.parse_args(argv)
    if a.compare:
        return run_and_compare("tree", None, a.compare, a.check)
    out = a.out or os.path.join(HERE, "chiprun_out",
                                f"report_anchor_torch_{a.device}")
    return run_and_compare(f"torch {a.device} {a.dtype}",
                           lambda o: run_torch(o, a.device, a.dtype), out,
                           a.check)


if __name__ == "__main__":
    sys.exit(main())
