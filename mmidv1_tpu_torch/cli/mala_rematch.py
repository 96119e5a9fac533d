"""MALA vs ensemble AM-MH rematch on the Spain-2020 posterior.

Port of ``scripts/mala_rematch.py``: the protocol that chose AM-MH over
MALA. 2048 chains from the artifact MAP, the artifact posterior covariance
as MALA's preconditioner and as the MH proposal's seed, 2000 steps, float32,
REFLECT, cash_karp@3; min-ESS/s over the post-burn-in draws (the chains
thinned to at most 256 for the ESS). Rows: ensemble AM-MH, MALA with
Robbins-Monro step adaptation, MALA at each ``--fixed-eps``.

On the card AM-MH evaluates through K1 (``ops.build_objective_fused``) and
every MALA run through K2 + K3 (``ops.build_objective_fused_grad``); with
``--device cpu`` the same calls run the kernels' plain versions. The draws
come from seeded generators (``calibration/draws.SeededRunDraws``): ``--seed``
for AM-MH, ``--seed + 1`` for adaptive MALA, ``--seed + 2`` for fixed eps.

Usage:
    python -m mmidv1_tpu_torch.cli.mala_rematch [--chains 2048] [--steps 2000]
        [--burn 500] [--fixed-eps 0.05 0.15 0.3] [--out results/mala_rematch.json]
        [--device cuda|cpu]
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
    p = argparse.ArgumentParser(prog="mala_rematch",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--chains", type=int, default=2048)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--burn", type=int, default=500)
    p.add_argument("--posterior",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "posterior_samples.npz"))
    p.add_argument("--map", dest="map_path",
                   default=os.path.join(REPO_ROOT, "results", "spain2020",
                                        "calibrated_parameters.txt"))
    p.add_argument("--fixed-eps", type=float, nargs="+",
                   default=[0.05, 0.15, 0.3])
    p.add_argument("--substeps", type=int, default=3)
    p.add_argument("--tableau", default="cash_karp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(REPO_ROOT, "results",
                                                 "mala_rematch.json"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (checks)")
    return p


def ess_per_sec(samples: np.ndarray, wall: float, burn: int, names):
    """``(min ESS, min ESS / wall, max rhat)`` of the draws after ``burn``,
    the chains thinned to at most 256 (``scripts/mala_rematch.py:107-112``)."""
    from ..analysis.diagnostics import summarize

    sub = samples[burn:, ::max(1, samples.shape[1] // 256), :]
    d = summarize(np.asarray(sub), list(names))
    ess = min(v["ess"] for v in d.values())
    rh = max(v["rhat"] for v in d.values())
    return ess, ess / wall, rh


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..calibration.draws import SeededRunDraws
    from ..calibration.mala import MALAConfig, run_mala
    from ..calibration.mh import MHConfig, run_mh
    from ..calibration.param_space import REFLECT
    from ..data import read_sepaihrd_parameters
    from ..ops import build_objective_fused, build_objective_fused_grad
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    dtype = torch.float32
    dev = resolve_device(args.device)
    pipe = load_spain_pipeline(REPO_ROOT, dtype=dtype, device=dev,
                               num_days=args.num_days)
    data, params, space, ts = pipe.data, pipe.params, pipe.space, pipe.ts
    print(f"device: {dev.type} / "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'}")

    kw = dict(substeps=args.substeps, tableau=args.tableau,
              constraint_mode=REFLECT, dtype=dtype, device=dev)
    ll_batch = build_objective_fused(space, params, data, ts, **kw)
    vag = build_objective_fused_grad(space, params, data, ts, **kw)

    prm_map = read_sepaihrd_parameters(
        args.map_path, 4, N=data.population_by_age,
        M_baseline=params.M_baseline.cpu().numpy(), dtype=dtype, device=dev)
    theta0 = space.extract(prm_map).to(dtype)
    draws = np.load(args.posterior)["samples"].reshape(-1, space.dim) \
        .astype(np.float64)
    cov = np.cov(draws, rowvar=False)
    cov += 1e-10 * np.eye(space.dim)
    cov_t = torch.as_tensor(cov, dtype=dtype, device=dev)

    B, T = args.chains, args.steps
    results = {"config": {"chains": B, "steps": T, "burn": args.burn,
                          "substeps": args.substeps, "tableau": args.tableau}}

    def timed(run):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        ess, eps_s, rh = ess_per_sec(res.samples.cpu().numpy(), wall,
                                     args.burn, space.names)
        acc = float(res.acceptance_rate.mean())
        return res, wall, ess, eps_s, rh, acc

    def seeded(seed):
        return SeededRunDraws(seed, 0, B, space.dim, dtype, dev)

    rows = []

    # ---- ensemble AM-MH ----------------------------------------------------
    cfg = MHConfig(iterations=T, burn_in=args.burn, adaptation_period=100,
                   thinning=1)
    _res, wall, ess, eps_s, rh, acc = timed(lambda: run_mh(
        ll_batch, space, theta0, cfg, n_chains=B, initial_cov=cov_t,
        jitter=1.0, draws=seeded(args.seed)))
    rows.append(("ensemble AM-MH (K1 objective)", B * T / wall, acc, ess,
                 eps_s, rh, wall))
    print(f"AM-MH: {B*T/wall:.3e} steps/s  accept {acc:.3f}  min-ESS {ess:.0f}"
          f"  min-ESS/s {eps_s:.1f}  (wall {wall:.0f}s)", flush=True)

    # ---- MALA, RM-adapted --------------------------------------------------
    mcfg = MALAConfig(iterations=T, burn_in=args.burn, adaptation_period=100,
                      thinning=1, initial_step_size=0.1)
    mres, wall, ess, eps_s, rh, acc = timed(lambda: run_mala(
        None, space, theta0, mcfg, n_chains=B, initial_cov=cov_t, jitter=1.0,
        value_and_grad_batch=vag, draws=seeded(args.seed + 1)))
    step = float(torch.median(mres.final_eps))
    rows.append((f"MALA RM-adapted (eps->{step:.2e})",
                 B * T / wall, acc, ess, eps_s, rh, wall))
    print(f"MALA adapt: {B*T/wall:.3e} steps/s  accept {acc:.3f}  "
          f"eps {step:.2e}  min-ESS {ess:.0f}  min-ESS/s {eps_s:.1f}",
          flush=True)

    # ---- MALA, fixed eps ---------------------------------------------------
    for eps in args.fixed_eps:
        fcfg = MALAConfig(iterations=T, burn_in=args.burn,
                          adaptation_period=100, thinning=1,
                          initial_step_size=eps, adapt_scale=False)
        _res, wall, ess, eps_s, rh, acc = timed(lambda: run_mala(
            None, space, theta0, fcfg, n_chains=B, initial_cov=cov_t,
            jitter=1.0, value_and_grad_batch=vag, draws=seeded(args.seed + 2)))
        rows.append((f"MALA fixed eps={eps}", B * T / wall, acc, ess, eps_s,
                     rh, wall))
        print(f"MALA eps={eps}: accept {acc:.3f}  min-ESS {ess:.0f}  "
              f"min-ESS/s {eps_s:.1f}", flush=True)

    print("\n| sampler | steps/s | acceptance | min-ESS | min-ESS/s |")
    print("|---|---|---|---|---|")
    for name, sps, acc, ess, eps_s, rh, wall in rows:
        print(f"| {name} | {sps:.2e} | {acc:.2f} | {ess:.0f} | {eps_s:.0f} |")

    results["rows"] = [
        {"sampler": n, "steps_per_sec": s, "acceptance": a, "min_ess": e,
         "min_ess_per_sec": es, "max_rhat": r, "wall_s": w}
        for n, s, a, e, es, r, w in rows]
    d = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
