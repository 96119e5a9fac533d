"""The externally-validated (ENE-COVID-consistent) Spain-2020 artifact.

Port of ``scripts/serovalid_pipeline.py``. The reference's severity and seed
lower bounds hold its day-64 seroprevalence near 1 %, a 20x miss of the
ENE-COVID target it validates against (4.8 % [4.3, 5.4]); relaxing those
floors (variant C: ``calibration/serovalid.relax_bounds``) reaches the
survey at a better Poisson fit. This writes ``results/spain2020_serovalid/``:

- ``param_bounds_serovalid.txt``: the relaxed bounds, ``name low high``;
- ``calibrated_parameters.txt``: the MAP under those bounds with the
  ENE-COVID point as a Gaussian data term of strength ``--constraint-se``;
- ``serovalid_metadata.json``: the reference-bounds MAP, the unconstrained
  relaxed MAP and the constrained MAP (plain-Poisson LL and day-64 sero
  each), metrics, provenance;
- ``laplace_serovalid.npz``: the Laplace covariance at the MAP over the
  free (off-bound) parameters, from the exact float64 Hessian of the joint
  (``_logit_posterior.exact_hessian``, reverse over reverse).

Both MAPs come from L-BFGS-B (scipy) on the float64 joint gradient: K2 + K3
for the Poisson streams plus autograd through the eager solve for the sero
term. By default the polish warm-starts from the variant-C theta of
``results/sero_force_profile.json``; ``--cold`` starts from the
reference-bounds MAP.

Usage:
    python -m mmidv1_tpu_torch.cli.serovalid_pipeline [--cold]
        [--maxiter 600] [--out results/spain2020_serovalid] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .common import REPO_ROOT


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="serovalid_pipeline",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--map", dest="map_path",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "calibrated_parameters.txt"),
                   help="reference-bounds MAP (cold-start init and the LL "
                        "comparison row)")
    p.add_argument("--probe-json",
                   default=os.path.join(REPO_ROOT, "results",
                                        "sero_force_profile.json"),
                   help="warm start: variant_C final_theta of the forcing "
                        "probe")
    p.add_argument("--cold", action="store_true",
                   help="ignore --probe-json; start from the reference-bounds "
                        "MAP")
    p.add_argument("--laplace",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "laplace_mass.npz"))
    p.add_argument("--seed-cap", type=float, default=50000.0)
    p.add_argument("--runup-lo", type=float, default=5.0)
    p.add_argument("--severity-floor-div", type=float, default=10.0)
    p.add_argument("--sero-se", type=float, default=0.0028,
                   help="the survey's Gaussian se on the ENE-COVID point "
                        "(recorded; the committed MAP uses --constraint-se)")
    p.add_argument("--constraint-se", type=float, default=2e-4,
                   help="enforcement weight of the committed constrained MAP")
    p.add_argument("--maxiter", type=int, default=600)
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5")
    p.add_argument("--skip-laplace", action="store_true")
    p.add_argument("--out", default=os.path.join(REPO_ROOT, "results",
                                                 "spain2020_serovalid"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


def free_block_hessian(f_batch, theta: torch.Tensor, free) -> np.ndarray:
    """The symmetrised exact Hessian of ``f_batch`` (rows independent) at
    ``theta`` over the coordinates ``free``, the others held."""
    from ._logit_posterior import exact_hessian

    idx = torch.as_tensor(free, device=theta.device)

    def f_free(zs):
        return f_batch(theta.expand(zs.shape[0], -1).index_copy(1, idx, zs))

    H = exact_hessian(f_free, theta[idx])[2].cpu().numpy()
    return 0.5 * (H + H.T)


def _full_std(d, free, cov_free):
    std = np.zeros(d)
    std[np.asarray(free)] = np.sqrt(np.maximum(np.diag(cov_free), 0.0))
    return std


def run(argv=None) -> dict:
    """The pipeline, as :func:`main` runs it; returns the metadata."""
    args = build_parser().parse_args(argv)
    from scipy.optimize import minimize

    from ..analysis.aggregate import (ENE_COVID_LOWER, ENE_COVID_MEAN,
                                      ENE_COVID_UPPER)
    from ..analysis.metrics import essential_metrics
    from ..calibration.objective import build_objective
    from ..calibration.param_space import REFLECT
    from ..calibration.serovalid import (add_sero_term, make_sero_penalty,
                                         relax_bounds)
    from ..data import read_sepaihrd_parameters, save_calibration_results
    from ..models import sepaihrd
    from ..ops import build_objective_fused, build_objective_fused_grad
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    f64 = torch.float64
    dev = resolve_device(args.device)
    pipe = load_spain_pipeline(REPO_ROOT, dtype=f64, device=dev,
                               num_days=args.num_days)
    data, base, space0, ts = pipe.data, pipe.params, pipe.space, pipe.ts
    names = list(space0.names)
    i_seed, i_run = names.index("seed_exposed"), names.index("runup_days")
    lo0 = space0.lower.cpu().numpy().astype(np.float64)
    hi0 = space0.upper.cpu().numpy().astype(np.float64)
    space, relaxed = relax_bounds(
        space0, seed_cap=args.seed_cap, runup_lo=args.runup_lo,
        severity_floor_div=args.severity_floor_div)
    lo = space.lower.cpu().numpy().astype(np.float64)
    hi = space.upper.cpu().numpy().astype(np.float64)
    kw = dict(substeps=args.substeps, tableau=args.tableau,
              constraint_mode=REFLECT, dtype=f64, device=dev)
    ll_k1 = build_objective_fused(space, base, data, ts, **kw)
    stream_vag = build_objective_fused_grad(space, base, data, ts, **kw)
    pen_of = lambda se: make_sero_penalty(space, base, data, ts, se=se, **kw)
    sero_of = pen_of(args.sero_se).sero_of
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    ll_np = lambda th: float(ll_k1(as_t(th)[None])[0])
    sero_np = lambda th: float(sero_of(as_t(th)[None])[0])

    def joint_vag(se):
        """float64 value and gradient of one point: K2 + K3 for the
        streams, plus autograd through the sero term when ``se``."""
        vag = add_sero_term(stream_vag, pen_of(se)) if se else stream_vag

        def vg(th):
            v, g = vag(as_t(th)[None])
            return float(v[0]), g[0].cpu().numpy()
        return vg

    prm_map = read_sepaihrd_parameters(
        args.map_path, 4, N=data.population_by_age,
        M_baseline=base.M_baseline.cpu().numpy(), dtype=f64, device=dev)
    theta_ref = space0.extract(prm_map).cpu().numpy().astype(np.float64)
    ll_ref, sero_ref = ll_np(theta_ref), sero_np(theta_ref)

    th = theta_ref.copy()
    init_src = "reference-bounds MAP (cold)"
    if not args.cold and os.path.exists(args.probe_json):
        with open(args.probe_json) as f:
            probe = json.load(f)
        ft = probe.get("variant_C", {}).get("final_theta")
        if ft is not None and list(ft.keys()) == names:
            th = np.array([ft[n] for n in names], np.float64)
            init_src = f"variant_C final theta of {args.probe_json}"
    width = hi - lo
    th = np.clip(th, lo + 1e-9 * width, hi - 1e-9 * width)

    # step scaling: Laplace stds, widened on the relaxed axes
    lap = np.load(args.laplace)
    std = np.maximum(lap["std"].astype(np.float64), 1e-12)
    std[relaxed] = np.maximum(std[relaxed], 0.05 * width[relaxed])
    print(f"init: {init_src}")
    print(f"reference-bounds MAP row: LL {ll_ref:.3f}  sero "
          f"{100 * sero_ref:.3f}%", flush=True)

    def polish(th_start, se, tag):
        vg = joint_vag(se)
        th0 = th_start.copy()

        def neg(z):
            v, g = vg(th0 + z * std)
            return -v, -g * std

        t0 = time.perf_counter()
        res = minimize(neg, np.zeros_like(th0), jac=True, method="L-BFGS-B",
                       bounds=list(zip((lo - th0) / std, (hi - th0) / std)),
                       options={"maxiter": args.maxiter, "maxcor": 40,
                                "ftol": 1e-13, "gtol": 1e-11})
        # z -> theta can land 1e-19 outside a zero floor; the saved file
        # must re-load through the parameters' validation
        th_fin = np.clip(th0 + res.x * std, lo, hi)
        wall = time.perf_counter() - t0
        ll, sero = ll_np(th_fin), sero_np(th_fin)
        inside = ENE_COVID_LOWER <= sero <= ENE_COVID_UPPER
        print(f"{tag}: {res.nit} its in {wall:.0f}s -> LL {ll:.3f} (dLL vs "
              f"reference-bounds {ll - ll_ref:+.1f})  sero {100 * sero:.3f}% "
              f"({'INSIDE' if inside else 'OUTSIDE'} ENE-COVID CI "
              f"[{100 * ENE_COVID_LOWER:.1f}, {100 * ENE_COVID_UPPER:.1f}]%)",
              flush=True)
        return th_fin, {"ll_poisson_float64": ll, "sero_day64": sero,
                        "inside_ene_covid_ci": bool(inside), "se": se,
                        "nit": int(res.nit), "wall_s": wall}

    # row 1: the unconstrained relaxed-bounds MAP (the data streams alone)
    _th_unc, row_unc = polish(th, None, "unconstrained relaxed-bounds MAP")
    # row 2, the committed artifact: the best Poisson fit held inside the
    # survey CI by a strong pull toward its mean
    th, row_con = polish(th, args.constraint_se,
                         f"ENE-COVID-constrained MAP "
                         f"(se={args.constraint_se:g})")
    ll_map, sero_map = row_con["ll_poisson_float64"], row_con["sero_day64"]
    inside = row_con["inside_ene_covid_ci"]

    os.makedirs(args.out, exist_ok=True)
    bounds_path = os.path.join(args.out, "param_bounds_serovalid.txt")
    with open(bounds_path, "w") as f:
        f.write("# Variant-C relaxed bounds: externally-validated "
                "(ENE-COVID-consistent) calibration mode\n")
        f.write("# Derivation: reference data/configuration/param_bounds.txt"
                " with\n")
        f.write(f"#   seed_exposed upper {hi0[i_seed]:g} -> {args.seed_cap:g}"
                f"; runup_days lower {lo0[i_run]:g} -> {args.runup_lo:g};\n")
        f.write(f"#   severity lower bounds (p_j, h_j, icu_j, d_H_j, "
                f"d_ICU_j) / {args.severity_floor_div:g}\n")
        f.write("# Measured justification: results/sero_force_profile.json"
                " + PARITY.md 'ENE-COVID seroprevalence'\n")
        for n, l, h in zip(names, lo, hi):
            f.write(f"{n}  {l:.10g}  {h:.10g}\n")
    save_calibration_results(os.path.join(args.out,
                                          "calibrated_parameters.txt"),
                             space.apply(base, as_t(th)), names, ll_map)

    # metrics of the MAP's full trajectory
    base_y0 = torch.as_tensor(data.initial_sepaihrd_state(
        sigma=base.sigma, gamma_p=base.gamma_p, gamma_A=base.gamma_A,
        gamma_I=base.gamma_I, p=base.p, h=base.h), dtype=f64, device=dev)
    ts_t = torch.as_tensor(np.asarray(ts, np.float64), device=dev)
    prm = space.apply(base.to(dev, f64), space.constrain(as_t(th), REFLECT))
    y0, _ = sepaihrd.initial_state_for_params(prm, base_y0)
    traj = sepaihrd.solve(prm, y0, ts_t, method="fixed",
                          substeps=args.substeps, tableau=args.tableau)
    mets = essential_metrics(prm, traj, ts_t, y0)
    meta = {
        "mode": "serovalid (variant C relaxed bounds + ENE-COVID data term)",
        "init": init_src,
        "bounds": {
            "file": os.path.relpath(bounds_path, REPO_ROOT),
            "seed_cap": args.seed_cap, "runup_lo": args.runup_lo,
            "severity_floor_div": args.severity_floor_div,
            "relaxed_parameters": [names[i] for i in relaxed]},
        "sero_target": {"mean": ENE_COVID_MEAN, "survey_se": args.sero_se,
                        "constraint_se": args.constraint_se,
                        "ci": [ENE_COVID_LOWER, ENE_COVID_UPPER]},
        "reference_bounds_map": {"ll_poisson_float64": ll_ref,
                                 "sero_day64": sero_ref},
        "unconstrained_relaxed_map": row_unc,
        "constrained_map": row_con,
        "ll_poisson_float64": ll_map,
        "delta_ll_vs_reference_bounds": ll_map - ll_ref,
        "sero_day64": sero_map,
        "inside_ene_covid_ci": bool(inside),
        "overall_attack_rate": float(mets["overall_attack_rate"]),
        "attack_rate_by_age": mets["AttackRate_age"].cpu().numpy().tolist(),
        "overall_ifr": float(mets["overall_IFR"]),
        "total_deaths": float(mets["total_deaths"]),
        "R0": float(mets["R0"]),
        "optimizer": {"maxiter": args.maxiter},
        "substeps": args.substeps, "tableau": args.tableau,
    }

    if not args.skip_laplace:
        print("laplace: Hessian of the joint at the MAP (free parameters "
              "only) ...", flush=True)
        eps_b = 1e-7 * width
        free = [i for i in range(len(names))
                if lo[i] + eps_b[i] < th[i] < hi[i] - eps_b[i]]
        t0 = time.perf_counter()
        ll_eager = build_objective(space, base, data, ts, **kw)
        pen = pen_of(args.constraint_se)
        H = free_block_hessian(lambda x: ll_eager(x) + pen(x), as_t(th),
                               free)
        # negated (the MAP maximises) and floored into the PD cone
        w, V = np.linalg.eigh(-H)
        w_floor = max(1e-10, 1e-8 * np.abs(w).max())
        w = np.maximum(w, w_floor)
        cov_free = (V / w) @ V.T
        np.savez(os.path.join(args.out, "laplace_serovalid.npz"),
                 names=np.asarray(names), theta_map=th, free=np.asarray(free),
                 cov_free=cov_free,
                 std=_full_std(len(names), free, cov_free), ll_map=ll_map)
        meta["laplace"] = {"n_free": len(free),
                           "wall_s": time.perf_counter() - t0,
                           "eig_floor": float(w_floor)}
        print(f"laplace: {len(free)} free params in "
              f"{time.perf_counter() - t0:.0f}s", flush=True)

    with open(os.path.join(args.out, "serovalid_metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"wrote {args.out}/: param_bounds_serovalid.txt, "
          f"calibrated_parameters.txt, serovalid_metadata.json"
          + ("" if args.skip_laplace else ", laplace_serovalid.npz"))
    return meta


def main(argv=None) -> int:
    return 0 if run(argv)["inside_ene_covid_ci"] else 4


if __name__ == "__main__":
    sys.exit(main())
