"""The Poisson-LL profile along the attack-rate <-> severity ridge.

Port of ``scripts/sero_ridge_scan.py``. The H / ICU / D streams observe
severity x infections, so in the linear-epidemic regime there is an
analytic candidate ridge: the seeds (``E0/P0/A0/I0`` multipliers,
``seed_exposed``) times k and the hospitalisation fractions and community
death rates divided by k keep the expected streams fixed while scaling the
infections, and the day-64 seroprevalence, by about k. In float64 on the
reference bounds:

1. LL and sero along the projected ridge (clipped at the bounds; which
   coordinates clipped is reported) for each k of ``--k``;
2. a Laplace-whitened L-BFGS-B joint polish (Poisson LL + ENE-COVID
   Gaussian; K2 + K3 plus autograd of the sero term) started from the ridge
   point nearest the survey's value.

Writes ``results/sero_ridge.json`` (or ``--out``).

Usage:
    python -m mmidv1_tpu_torch.cli.sero_ridge_scan [--k 1 1.5 2 3 4 4.75 6]
        [--maxiter 300] [--out results/sero_ridge.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import _sero_probe as sp

RIDGE_UP = ["E0_multiplier", "P0_multiplier", "A0_multiplier",
            "I0_multiplier", "seed_exposed"]
RIDGE_DOWN = ["h_0", "h_1", "h_2", "h_3",
              "d_community_0", "d_community_1", "d_community_2",
              "d_community_3"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sero_ridge_scan",
                                description=__doc__.split("\n\n")[0])
    sp.add_common_args(p, "sero_ridge.json")
    p.add_argument("--k", type=float, nargs="+",
                   default=[1.0, 1.5, 2.0, 3.0, 4.0, 4.75, 6.0])
    p.add_argument("--sero-se", type=float, default=0.0028)
    p.add_argument("--maxiter", type=int, default=300)
    return p


def ridge_point(theta_map: np.ndarray, k: float, names, lo, hi):
    """The MAP moved k along the ridge and clipped to the box:
    ``(theta, the names that clipped)``."""
    idx_up = [names.index(n) for n in RIDGE_UP if n in names]
    idx_dn = [names.index(n) for n in RIDGE_DOWN if n in names]
    th = theta_map.copy()
    th[idx_up] *= k
    th[idx_dn] /= k
    clipped = [names[i] for i in idx_up + idx_dn
               if not (lo[i] <= th[i] <= hi[i])]
    return np.clip(th, lo, hi), clipped


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pl = sp.Pipeline(device=args.device, substeps=args.substeps,
                     tableau=args.tableau)
    box = pl.box("reference")
    names, lo, hi = pl.names, box.lo, box.hi

    theta_map = pl.theta_from_txt(args.map_path)
    ll_map, sero_map = box.ll(theta_map), box.sero(theta_map)
    print(f"MAP: LL {ll_map:.3f}  sero {100*sero_map:.3f}%", flush=True)

    results = {"map": {"ll": ll_map, "sero_day64": sero_map},
               "ridge": [], "names_up": RIDGE_UP, "names_down": RIDGE_DOWN}

    best_ridge = (ll_map, theta_map, sero_map, 1.0)
    for k in args.k:
        th, clipped = ridge_point(theta_map, k, names, lo, hi)
        v, s = box.ll(th), box.sero(th)
        results["ridge"].append({"k": k, "ll": v, "delta_ll": v - ll_map,
                                 "sero_day64": s, "clipped": clipped})
        print(f"k={k:5.2f}: LL {v:15.3f} (dLL {v-ll_map:+12.3f})  "
              f"sero {100*s:6.3f}%  clipped: {','.join(clipped) or '-'}",
              flush=True)
        # prefer the ridge point nearest the sero target as the polish seed
        if abs(s - args.sero_target) < abs(best_ridge[2] - args.sero_target):
            best_ridge = (v, th, s, k)

    # ---- joint polish from the best ridge point ---------------------------
    target, se = args.sero_target, args.sero_se
    std = sp.laplace_std(args.laplace)
    t0 = time.perf_counter()
    [(res, th_fin)] = sp.polish(box.joint_vg(se, target), best_ridge[1], std,
                                lo, hi, rounds=1, maxiter=args.maxiter,
                                ftol=1e-12, gtol=1e-10)
    ll_fin, sero_fin = box.ll(th_fin), box.sero(th_fin)
    print(f"polish from k={best_ridge[3]:.2f}: LL {ll_fin:.3f} "
          f"(dLL vs MAP {ll_fin-ll_map:+.3f})  sero {100*sero_fin:.3f}%  "
          f"({res.nit} its, {time.perf_counter()-t0:.0f}s)", flush=True)
    results["polished"] = {
        "seed_k": best_ridge[3], "ll": ll_fin,
        "delta_ll_vs_map": ll_fin - ll_map, "sero_day64": sero_fin,
        "iterations": int(res.nit),
        "theta": {n: float(v) for n, v in zip(names, th_fin)}}
    results["config"] = {"sero_target": target, "sero_se": se,
                         "substeps": args.substeps, "tableau": args.tableau}

    sp.write_json(args.out, results)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
