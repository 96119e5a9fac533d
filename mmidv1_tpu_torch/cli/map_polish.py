"""Second-order MAP polish and the Laplace mass of the Spain-2020 posterior.

Port of ``scripts/map_polish.py``. The hill climb leaves the MAP short of a
stationary point; this finishes it with curvature:

1. the exact float64 value and gradient, through K2 + K3
   (``ops/sepaihrd_adjoint.build_objective_fused_grad``, REFLECT);
2. a Hessian by central differences of that exact gradient (one-sided at a
   bound), its 2 x n_free rows evaluated as one batch of chains, negated
   and eigen-floored into a Laplace covariance;
3. L-BFGS-B (scipy) in Laplace-whitened coordinates, Hessian -> whiten ->
   polish, until a round's gain stalls.

Bound-pinned parameters (the gradient pushes out of the box) stay out of the
Hessian; their scale is the profile's decay length 1/|g|, capped at 5 % of
the box. Files in ``--out``: ``calibrated_parameters.txt``,
``laplace_mass.npz`` (names, theta_map, std, free, cov_free, ll_map,
grad_map: the input of ``nuts_campaign --mass laplace[-dense]`` and
``production_campaign --laplace``) and ``polish_metadata.json``.

Usage:
    python -m mmidv1_tpu_torch.cli.map_polish [--init calibrated_parameters.txt
        | theta.npy] [--rounds 6] [--maxiter 300] [--out results/spain2020_polish]

``--device cpu --num-days 30`` runs the plain versions on the host (checks).
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
    p = argparse.ArgumentParser(prog="map_polish",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--init",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "calibrated_parameters.txt"),
                   help="calibrated_parameters.txt (or a .npy theta) to "
                        "polish")
    p.add_argument("--out",
                   default=os.path.join(REPO_ROOT, "results",
                                        "spain2020_polish"))
    p.add_argument("--rounds", type=int, default=6,
                   help="max Hessian -> whiten -> L-BFGS-B rounds")
    p.add_argument("--maxiter", type=int, default=300,
                   help="L-BFGS-B iterations per round")
    p.add_argument("--gain-tol", type=float, default=0.01,
                   help="stop when a round's LL gain falls below this")
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


def hessian_products(vg_rows, theta, g0, lo, hi, sig):
    """``(std, free, cov_free, n_evals, seconds)`` at ``theta`` with
    gradient ``g0``; ``vg_rows(thetas (n, d)) -> (values (n,), grads (n,
    d))`` evaluates independent rows (``scripts/map_polish.py:104-150``,
    its gradient calls as one batch)."""
    d = len(lo)
    rng = hi - lo
    at_lo = theta - lo <= 1e-8 * rng
    at_hi = hi - theta <= 1e-8 * rng
    pinned = (at_lo & (g0 < 0)) | (at_hi & (g0 > 0))
    free = ~pinned
    room_lo = theta - lo
    room_hi = hi - theta
    h = np.maximum(1e-4 * sig, 1e-9)
    # capped by the larger one-sided room: a free coordinate can sit on a
    # bound, and a step toward 0 there would difference REFLECT-folded
    # points; a one-sided stencil is used instead
    h = np.minimum(h, np.maximum(np.maximum(room_lo, room_hi) * 0.5, 1e-12))
    rows, plan = [], []
    for i in range(d):
        if not free[i]:
            continue
        e = np.zeros(d)
        e[i] = h[i]
        up_ok = room_hi[i] >= h[i]
        dn_ok = room_lo[i] >= h[i]
        if up_ok:
            rows.append(theta + e)
        if dn_ok:
            rows.append(theta - e)
        plan.append((i, up_ok, dn_ok))
    t0 = time.perf_counter()
    grads = np.asarray(vg_rows(np.stack(rows))[1]) if rows else None
    H = np.zeros((d, d))
    r = 0
    for i, up_ok, dn_ok in plan:
        if up_ok and dn_ok:
            H[i] = (grads[r] - grads[r + 1]) / (2 * h[i])
        elif up_ok:
            H[i] = (grads[r] - g0) / h[i]
        elif dn_ok:
            H[i] = (g0 - grads[r]) / h[i]
        # else: a zero-width coordinate; its row stays 0 and the eigenvalue
        # floor below gives it a conservative variance
        r += int(up_ok) + int(dn_ok)
    seconds = time.perf_counter() - t0
    Hf = 0.5 * (H[np.ix_(free, free)] + H[np.ix_(free, free)].T)
    w, V = np.linalg.eigh(-Hf)
    print(f"  Hessian: {len(rows)} grad evals in {seconds:.1f}s; eig(-H) "
          f"{w.min():.3e}..{w.max():.3e} (n_nonpos={(w <= 0).sum()})",
          flush=True)
    w_floor = np.maximum(w, 1e-8 * np.abs(w).max())
    cov_f = (V / w_floor) @ V.T
    std = np.zeros(d)
    std[free] = np.sqrt(np.diag(cov_f))
    std[~free] = np.minimum(1.0 / np.maximum(np.abs(g0[~free]), 1e-12),
                            0.05 * rng[~free])
    return np.maximum(std, 1e-15), free, cov_f, len(rows), seconds


def polish_round(vg1, theta, std, lo, hi, maxiter):
    """One L-BFGS-B round in whitened coordinates ``theta / std``; returns
    ``(theta, ll, whitened gradient, evaluations)``."""
    from scipy.optimize import minimize

    nev = [0]

    def fun(xw):
        v_, g_ = vg1(xw * std)
        nev[0] += 1
        return -v_, -g_ * std

    res = minimize(fun, theta / std, jac=True, method="L-BFGS-B",
                   bounds=list(zip(lo / std, hi / std)),
                   options=dict(maxiter=maxiter, maxcor=40, ftol=1e-16,
                                gtol=1e-10))
    return res.x * std, -float(res.fun), np.asarray(res.jac), nev[0]


def engine_rows(vg_batch, device):
    """NumPy float64 row and point callables over a batched torch
    ``value_and_grad``."""
    def vg_rows(thetas):
        v, g = vg_batch(torch.as_tensor(np.asarray(thetas, np.float64),
                                        device=device))
        return v.cpu().numpy(), g.cpu().numpy()

    def vg1(theta):
        v, g = vg_rows(np.asarray(theta)[None])
        return float(v[0]), g[0]

    return vg_rows, vg1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..calibration.param_space import REFLECT
    from ..data import read_sepaihrd_parameters, save_calibration_results
    from ..ops import build_objective_fused_grad
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    dev = resolve_device(args.device)
    # grid fixed from the initial guess's runup_days (reference main.cpp:241)
    pipe = load_spain_pipeline(REPO_ROOT, dtype=torch.float64, device=dev,
                               num_days=args.num_days)
    data, base, space, ts = pipe.data, pipe.params, pipe.space, pipe.ts
    vg_batch = build_objective_fused_grad(space, base, data, ts,
                                          substeps=args.substeps,
                                          tableau=args.tableau,
                                          constraint_mode=REFLECT,
                                          dtype=torch.float64, device=dev)
    vg_rows, vg1 = engine_rows(vg_batch, dev)
    names = list(space.names)
    lo = space.lower.cpu().numpy().astype(np.float64)
    hi = space.upper.cpu().numpy().astype(np.float64)
    sig = space.sigmas.cpu().numpy().astype(np.float64)
    d = len(lo)

    if args.init.endswith(".npy"):
        theta = np.load(args.init).astype(np.float64)
    else:
        calib = read_sepaihrd_parameters(
            args.init, 4, N=data.population_by_age,
            M_baseline=base.M_baseline.cpu().numpy(), dtype=torch.float64,
            device=dev)
        theta = space.extract(calib).cpu().numpy().astype(np.float64)

    v, g = vg1(theta)
    print(f"start: LL {v:.8f}  |g| {np.linalg.norm(g):.3e}", flush=True)
    record = [{"round": -1, "ll": v, "grad_norm": float(np.linalg.norm(g))}]
    for rnd in range(args.rounds):
        std, free, _cov, _n, _s = hessian_products(vg_rows, theta, g, lo, hi,
                                                   sig)
        t0 = time.perf_counter()
        theta1, v1, gw, nev = polish_round(vg1, theta, std, lo, hi,
                                           args.maxiter)
        gain = v1 - v
        print(f"round {rnd}: {nev} evals {time.perf_counter() - t0:.0f}s -> "
              f"LL {v1:.8f} (gain {gain:+.4f})  |g_w| free "
              f"{np.linalg.norm(gw[free]):.3e}", flush=True)
        record.append({"round": rnd, "ll": v1, "gain": gain,
                       "whitened_grad_norm_free":
                       float(np.linalg.norm(gw[free])), "evals": nev})
        theta, v = theta1, v1
        g = vg1(theta)[1]
        if gain < args.gain_tol:
            break

    std, free, cov_f, _n, _s = hessian_products(vg_rows, theta, g, lo, hi,
                                                sig)
    print(f"final: LL {v:.8f}  free {int(free.sum())}/{d}")
    print("  at bounds:", [n for n, f in zip(names, free) if not f])

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "laplace_mass.npz"),
             names=np.array(names), theta_map=theta, std=std, free=free,
             cov_free=cov_f, ll_map=v, grad_map=g)
    save_calibration_results(
        os.path.join(args.out, "calibrated_parameters.txt"),
        space.apply(base, torch.as_tensor(theta, device=dev)), names, v)
    with open(os.path.join(args.out, "polish_metadata.json"), "w") as f:
        json.dump({"algorithm": "lbfgsb_laplace_whitened",
                   "substeps": args.substeps, "tableau": args.tableau,
                   "rounds": record, "final_ll_float64": v,
                   "n_free": int(free.sum()),
                   "pinned": [n for n, fr in zip(names, free) if not fr]},
                  f, indent=2)
    print(f"artifacts -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
