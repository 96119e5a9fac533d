"""Is the ENE-COVID seroprevalence miss forced by the seed bounds?

Port of ``scripts/sero_sensitivity.py``. With ``runup_days > 0`` and
``seed_exposed > 0`` the objective seeds by run-up: the epidemic's amplitude
is ``seed_exposed`` x exp(growth), and ``seed_exposed``'s cap of 50 is the
only amplitude lever; the MAP sits on it. Here only the seed-amplitude
bounds are relaxed (box "B": ``seed_exposed`` cap 50 -> ``--seed-cap``,
``runup_days`` floor 15 -> ``--runup-lo``; every rate keeps the reference's
bounds), in float64:

1. the stream gradient at the MAP, nudged 1e-9 of the box's width off the
   walls: d LL / d ``seed_exposed`` and d LL / d ``runup_days`` (K2 + K3);
2. an LL-only Laplace-whitened L-BFGS-B polish in the relaxed box: where the
   likelihood itself puts the amplitude;
3. the joint polish with the ENE-COVID Gaussian term from there.

Writes ``results/sero_sensitivity.json`` (or ``--out``).

Usage:
    python -m mmidv1_tpu_torch.cli.sero_sensitivity [--seed-cap 50000]
        [--runup-lo 5] [--maxiter 400] [--rounds 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import _sero_probe as sp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sero_sensitivity",
                                description=__doc__.split("\n\n")[0])
    sp.add_common_args(p, "sero_sensitivity.json")
    p.add_argument("--seed-cap", type=float, default=50000.0)
    p.add_argument("--runup-lo", type=float, default=5.0)
    p.add_argument("--sero-se", type=float, default=0.0028)
    p.add_argument("--maxiter", type=int, default=400)
    p.add_argument("--rounds", type=int, default=3)
    return p


def whitening(std: np.ndarray, i_seed: int, i_run: int,
              seed_cap: float) -> np.ndarray:
    """The Laplace scale with floors on the relaxed coordinates (their
    Laplace widths were computed wedged against the old walls)."""
    std = std.copy()
    std[i_seed] = max(std[i_seed], 0.05 * seed_cap)
    std[i_run] = max(std[i_run], 1.0)
    return std


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pl = sp.Pipeline(device=args.device, substeps=args.substeps,
                     tableau=args.tableau)
    names = pl.names
    i_seed, i_run = names.index("seed_exposed"), names.index("runup_days")
    box = pl.box("B", seed_cap=args.seed_cap, runup_lo=args.runup_lo)
    lo, hi = box.lo, box.hi

    theta_map = sp.nudge(pl.theta_from_txt(args.map_path), lo, hi)
    ll_map, sero_map = box.ll(theta_map), box.sero(theta_map)
    g = box.stream_vg(theta_map)[1]
    print(f"MAP (orig bounds): LL {ll_map:.3f}  sero {100*sero_map:.3f}%")
    print(f"dLL/d(seed_exposed) = {g[i_seed]:+.4f}  (at the old cap 50; "
          f"positive = the data wants MORE seeding)")
    print(f"dLL/d(runup_days)   = {g[i_run]:+.4f}  (at the old floor 15)",
          flush=True)

    results = {"map": {"ll": ll_map, "sero_day64": sero_map,
                       "grad_seed_exposed": float(g[i_seed]),
                       "grad_runup_days": float(g[i_run])},
               "relaxation": {"seed_cap": args.seed_cap,
                              "runup_lo": args.runup_lo}}

    std = whitening(sp.laplace_std(args.laplace), i_seed, i_run,
                    args.seed_cap)

    def polish(vg, th0, tag):
        t0 = time.perf_counter()
        best = None

        def on_round(r, res, th):
            nonlocal best
            v, s = box.ll(th), box.sero(th)
            print(f"{tag} round {r}: LL {v:.3f}  sero {100*s:.3f}%  "
                  f"seed_exposed {th[i_seed]:.1f}  runup {th[i_run]:.2f}  "
                  f"({res.nit} its, {time.perf_counter()-t0:.0f}s)",
                  flush=True)
            if best is None or -res.fun > best[0]:
                best = (-float(res.fun), th, v, s)

        sp.polish(vg, th0, std, lo, hi, rounds=args.rounds,
                  maxiter=args.maxiter, ftol=1e-13, gtol=1e-11,
                  on_round=on_round)
        return best

    # ---- 2) LL-only polish in the relaxed space ---------------------------
    _, th_rel, ll_rel, sero_rel = polish(box.stream_vg, theta_map, "LL-only")
    results["relaxed_ll_optimum"] = {
        "ll": ll_rel, "delta_ll_vs_map": ll_rel - ll_map,
        "sero_day64": sero_rel,
        "seed_exposed": float(th_rel[i_seed]),
        "runup_days": float(th_rel[i_run]),
        "theta": {n: float(v) for n, v in zip(names, th_rel)}}

    # ---- 3) joint (ENE-COVID-constrained) polish in the relaxed space -----
    target, se = args.sero_target, args.sero_se
    _, th_j, ll_j, sero_j = polish(box.joint_vg(se, target), th_rel.copy(),
                                   "joint")
    results["relaxed_joint_optimum"] = {
        "ll": ll_j, "delta_ll_vs_relaxed": ll_j - ll_rel,
        "delta_ll_vs_map": ll_j - ll_map, "sero_day64": sero_j,
        "seed_exposed": float(th_j[i_seed]),
        "runup_days": float(th_j[i_run]),
        "theta": {n: float(v) for n, v in zip(names, th_j)}}
    results["config"] = {"sero_target": target, "sero_se": se,
                         "substeps": args.substeps, "tableau": args.tableau}

    print("\n| mode | Poisson LL | dLL vs MAP | sero(day64) | seed_exposed |")
    print("|---|---|---|---|---|")
    print(f"| MAP (reference bounds) | {ll_map:.1f} | — | "
          f"{100*sero_map:.3f}% | 50 (at cap) |")
    print(f"| relaxed LL optimum | {ll_rel:.1f} | {ll_rel-ll_map:+.1f} | "
          f"{100*sero_rel:.3f}% | {th_rel[i_seed]:.1f} |")
    print(f"| relaxed + ENE-COVID joint | {ll_j:.1f} | {ll_j-ll_map:+.1f} | "
          f"{100*sero_j:.3f}% | {th_j[i_seed]:.1f} |")

    sp.write_json(args.out, results)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
