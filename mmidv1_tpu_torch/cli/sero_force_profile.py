"""Forcing profile: what ENE-COVID-consistent seroprevalence costs, and which
of the reference's bounds forbid it.

Port of ``scripts/sero_force_profile.py``. A homotopy-strengthened sero
penalty (se down ``--se-ladder``, 0.01 -> 0.0003 by default: a pull of ~90
-> ~8000 nats at 1 % sero) under two bound variants, the whole 62-parameter
vector polished (L-BFGS-B, Laplace-whitened, float64; K2 + K3 plus autograd
of the sero term) at each rung:

  B. seeds relaxed only (``seed_exposed`` cap 50 -> 50000, ``runup_days``
     floor 15 -> 5);
  C. seeds relaxed and the severity floors (``p_``, ``h_``, ``icu_``,
     ``d_H_``, ``d_ICU_``) divided by ``--severity-floor-div``.

For each variant: the (sero, Poisson-LL) path up the ladder, the final
point and the names it leaves at their lower bound. Writes
``results/sero_force_profile.json`` (or ``--out``), the warm start of
``cli/serovalid_pipeline``.

Usage:
    python -m mmidv1_tpu_torch.cli.sero_force_profile [--variants B C]
        [--se-ladder 0.01 0.003 0.001 0.0003] [--maxiter 400]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import _sero_probe as sp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sero_force_profile",
                                description=__doc__.split("\n\n")[0])
    sp.add_common_args(p, "sero_force_profile.json")
    p.add_argument("--seed-cap", type=float, default=50000.0)
    p.add_argument("--runup-lo", type=float, default=5.0)
    p.add_argument("--severity-floor-div", type=float, default=10.0)
    p.add_argument("--se-ladder", type=float, nargs="+",
                   default=[0.01, 0.003, 0.001, 0.0003])
    p.add_argument("--maxiter", type=int, default=400)
    p.add_argument("--variants", nargs="+", default=["B", "C"])
    return p


def whitening(std_base: np.ndarray, lo, hi, lo0, hi0) -> np.ndarray:
    """The Laplace scale, floored at 5 % of the box's width on every
    coordinate whose bounds were relaxed."""
    width = hi - lo
    std = std_base.copy()
    changed = (lo != lo0) | (hi != hi0)
    std[changed] = np.maximum(std[changed], 0.05 * width[changed])
    return std


def at_lower_bound(names, th, lo, hi) -> list:
    """The names within 1e-6 of the box's width of their lower bound."""
    return [n for n, b, l, h in zip(names, th, lo, hi) if b - l < 1e-6 * (h - l)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pl = sp.Pipeline(device=args.device, substeps=args.substeps,
                     tableau=args.tableau)
    names = pl.names
    i_seed, i_run = names.index("seed_exposed"), names.index("runup_days")
    theta_map0 = pl.theta_from_txt(args.map_path)
    std_base = sp.laplace_std(args.laplace)
    lo0, hi0 = (b.cpu().numpy().astype(np.float64)
                for b in (pl.space0.lower, pl.space0.upper))
    target = args.sero_target

    results = {"config": {"sero_target": target,
                          "se_ladder": args.se_ladder,
                          "seed_cap": args.seed_cap,
                          "runup_lo": args.runup_lo,
                          "severity_floor_div": args.severity_floor_div,
                          "substeps": args.substeps,
                          "tableau": args.tableau}}

    for tag in args.variants:
        box = pl.box(tag, seed_cap=args.seed_cap, runup_lo=args.runup_lo,
                     severity_floor_div=args.severity_floor_div)
        lo, hi = box.lo, box.hi
        std = whitening(std_base, lo, hi, lo0, hi0)
        n_changed = int(((lo != lo0) | (hi != hi0)).sum())

        th = sp.nudge(theta_map0, lo, hi)
        ll_start, sero_start = box.ll(th), box.sero(th)
        print(f"\n=== variant {tag}: start LL {ll_start:.3f} "
              f"sero {100*sero_start:.3f}%  "
              f"({n_changed} bounds relaxed)", flush=True)
        path = [{"se": None, "ll": ll_start, "sero_day64": sero_start}]

        for se in args.se_ladder:
            t0 = time.perf_counter()
            [(res, th)] = sp.polish(box.joint_vg(se, target), th.copy(), std,
                                    lo, hi, rounds=1, maxiter=args.maxiter,
                                    ftol=1e-13, gtol=1e-11)
            v, s = box.ll(th), box.sero(th)
            print(f"  se={se:g}: LL {v:.3f} (dLL {v-ll_start:+.3f})  "
                  f"sero {100*s:.3f}%  seed {th[i_seed]:.1f}  "
                  f"({res.nit} its, {time.perf_counter()-t0:.0f}s)",
                  flush=True)
            path.append({"se": se, "ll": v, "delta_ll": v - ll_start,
                         "sero_day64": s,
                         "seed_exposed": float(th[i_seed]),
                         "runup_days": float(th[i_run])})

        results[f"variant_{tag}"] = {
            "path": path,
            "final_theta": {n: float(v) for n, v in zip(names, th)},
            "final_at_lower_bound": at_lower_bound(names, th, lo, hi)}

    sp.write_json(args.out, results)
    print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
