"""The Spain-2020 posterior's exact curvature in logit space, and mass
candidates scored against it.

Port of ``scripts/curvature_probe.py``. The leapfrog is stable for
``eps < ~2 / sqrt(lambda_max(S^T (-H) S))`` with mass factor ``S`` and
target Hessian ``H``, so a step crushed far below that says the mass
overestimates the posterior's width along some stiff direction. This
computes the exact float64 Hessian of the logit-space log posterior
(``_logit_posterior.exact_hessian``: reverse over reverse through the eager
solve, no finite differences) at ``--points`` ensemble positions of a trace
and, for the pooled and the within-chain covariance of its second half,
the predicted stable step (``eps_stable``) and the largest whitened
posterior width (``whitened_width``): a mass with step O(0.1) and width
O(10) mixes. Writes the report as JSON to ``--out``.

Usage:
    python -m mmidv1_tpu_torch.cli.curvature_probe --trace samples.npz
        [--points 3] [--out results/curvature_probe.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import numpy as np

from ..calibration.nuts import logit_transform
from ._logit_posterior import LogitObjective, floor_std, shrink
from .common import REPO_ROOT


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="curvature_probe",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", default=os.path.join(
        REPO_ROOT, "results", "spain2020_nuts_r9", "samples.npz"))
    p.add_argument("--points", type=int, default=3,
                   help="ensemble positions to evaluate the Hessian at")
    p.add_argument("--floor", type=float, default=0.25,
                   help="y-marginal-std floor for trace-derived masses")
    p.add_argument("--out", default=os.path.join(REPO_ROOT, "results",
                                                 "curvature_probe.json"))
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    tr = np.load(args.trace)
    X = tr["samples"].astype(np.float64)           # (T, C, d)
    T, C, d = X.shape
    obj = LogitObjective(args)
    lo, hi, names = obj.lo, obj.hi, obj.names
    Xl = X[T // 2:]
    y_pool = logit_transform(Xl.reshape(-1, d), lo, hi)
    y_chains = logit_transform(Xl, lo, hi)          # (T2, C, d)

    def floored_chol(cov, tag):
        cov = shrink(cov)
        add = np.maximum(args.floor ** 2 - np.diag(cov), 0.0)
        cov = floor_std(cov, args.floor)
        print(f"{tag}: y-marginal-std {np.sqrt(np.diag(cov)).min():.2e}.."
              f"{np.sqrt(np.diag(cov)).max():.2e}, {int((add > 0).sum())} "
              f"floored")
        return np.linalg.cholesky(cov)

    cov_pool = np.cov(y_pool, rowvar=False)
    # within-chain: the mean per-chain covariance (no frozen offsets)
    cen = y_chains - y_chains.mean(axis=0, keepdims=True)
    cov_within = np.einsum("tcd,tce->de", cen, cen) / (C * (len(cen) - 1))
    masses = {"pooled": floored_chol(cov_pool, "pooled"),
              "within": floored_chol(cov_within, "within")}

    lp_last = tr["logps"][-1]
    order = np.argsort(-lp_last)
    picks = [order[0]] + list(order[np.linspace(
        0, C - 1, args.points - 1, dtype=int)])[1:] if args.points > 1 \
        else [order[0]]
    picks = picks[:args.points]
    H_list, secs = obj.hessians(
        np.ones(d), [logit_transform(X[-1, ci], lo, hi) for ci in picks])
    report = {"floor": args.floor, "points": [], "masses": {},
              "hessian_seconds": secs, "device": str(obj.dev)}
    for ci, H in zip(picks, H_list):
        lam = np.linalg.eigvalsh(-H)
        print(f"chain {ci}: logp {lp_last[ci]:.1f}; -H eig range "
              f"[{lam.min():.3e}, {lam.max():.3e}]")
        report["points"].append({"chain": int(ci),
                                 "eig_min": float(lam.min()),
                                 "eig_max": float(lam.max())})

    for tag, S in masses.items():
        eps_pred = []
        for H in H_list:
            A = S.T @ (-H) @ S
            lam, V = np.linalg.eigh(0.5 * (A + A.T))
            lam_max = float(lam[-1])
            eps_pred.append(2.0 / np.sqrt(max(lam_max, 1e-30)))
            v = S @ V[:, -1]                       # the stiffest direction
            top = np.argsort(-np.abs(v))[:5]
            print(f"  [{tag}] lambda_max {lam_max:.3e} -> eps_stable "
                  f"{eps_pred[-1]:.2e}; stiff dir: "
                  + ", ".join(f"{names[i]}:{v[i]:+.3f}" for i in top))
        Si = np.linalg.inv(S)
        W = Si @ cov_pool @ Si.T
        wl = np.linalg.eigvalsh(0.5 * (W + W.T))
        width_pred = float(np.sqrt(max(wl[-1], 0.0)))
        print(f"  [{tag}] predicted eps {min(eps_pred):.2e}, max whitened "
              f"posterior width {width_pred:.1f} -> leapfrogs/traverse "
              f"~{width_pred / min(eps_pred):.0f}")
        report["masses"][tag] = {"eps_stable": float(min(eps_pred)),
                                 "whitened_width": width_pred}

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
