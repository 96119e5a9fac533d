"""End-to-end Spain-2020 SEPAIHRD calibration on the card.

Port of ``scripts/calibrate_spain.py`` (the ``--engine pallas`` path): load
data/configuration -> build the 62-parameter space -> Phase 1 PSO (CLAMP) ->
covariance conditioning -> Phase 2 ensemble adaptive-Metropolis (REFLECT) ->
float64 re-selection of the best candidate -> optionally write re-loadable
calibrated parameters, posterior samples and run metadata. Every objective
evaluation goes through the fused CUDA kernel (``ops/sepaihrd_fused.py``).
``--algorithm nuts`` runs NUTS instead, on the CLAMP objective, with every
value and gradient from the K2/K3 kernels (``ops/sepaihrd_adjoint.py``).

Usage:
    python -m mmidv1_tpu_torch.cli.calibrate_spain [--algorithm psomcmc]
        [--chains 64] [--pso-particles 512] [--pso-iters 60]
        [--mcmc-iters 600] [--tableau dopri5] [--x64] [--device cuda]
        [--out DIR] [--full]

``--full`` uses the production settings files (pso_settings.txt /
mcmc_settings.txt / nuts_settings.txt); otherwise NUTS runs
max(mcmc_iters // 10, 50) iterations. ``--device cpu`` runs the plain
PyTorch versions on the host (slow; for checks at small sizes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..calibration.calibrator import calibrate
from ..calibration.hill import HillClimbConfig
from ..calibration.mh import MHConfig
from ..calibration.nuts import NUTSConfig
from ..calibration.param_space import CLAMP, REFLECT
from ..calibration.pso import PSOConfig
from ..data import read_sepaihrd_parameters, save_calibration_results
from ..ops import build_objective_fused, build_objective_fused_grad
from ..utils import trace
from ..utils.device import resolve_device
from .common import load_spain_pipeline

REFERENCE_BEST_LL = 1.41969205e+06   # data/configuration/initial_guess.txt:3


def reselect_float64(space, params, data, ts, cands, *, substeps: int,
                     tableau: str, device):
    """The float64 log-likelihoods of the candidate thetas ``cands`` and the
    parameters they apply to, as ``scripts/calibrate_spain.py`` computes
    them: the run's float32 parameters cast up to float64 and the run's own
    space (its float32 bounds, exact in float64), REFLECT, on the run's grid
    (not the configuration reloaded in float64, which is another base
    point). Returns ``(lls64 (n,), params64)``."""
    params64 = params.to(device, torch.float64)
    ll64 = build_objective_fused(space, params64, data, ts, substeps=substeps,
                                 tableau=tableau, constraint_mode=REFLECT,
                                 dtype=torch.float64, device=device)
    return ll64(cands.to(device=device, dtype=torch.float64)), params64


def run_calibration(*, algorithm: str = "psomcmc", chains: int = 64,
                    pso_particles: int = 512, pso_iters: int = 60,
                    mcmc_iters: int = 600, thinning: int = 5,
                    burn_in: int = 100, substeps: int = 4,
                    tableau: str = "dopri5", x64: bool = False, seed: int = 0,
                    init: Optional[str] = None, out: Optional[str] = None,
                    full: bool = False, device="cuda",
                    root: Optional[str] = None, num_days: Optional[int] = None,
                    nuts_config: Optional[NUTSConfig] = None,
                    log=print) -> dict:
    """Run the calibration and return its summary (``best_logl``,
    ``best_logl_float64``, ``initial_logl``, phase timings,
    ``chain_steps_per_s`` for AM-MH, ``grad_evals_per_s`` and the K2/K3
    launches for NUTS...). ``nuts_config`` overrides the NUTS settings.
    Files are written only when ``out`` is given."""
    dev = resolve_device(device)
    dtype = torch.float64 if x64 else torch.float32
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {dev.type} / {kind}; dtype {dtype}")

    t_load = time.perf_counter()
    pipe = load_spain_pipeline(root, dtype=dtype, device=dev, num_days=num_days)
    data, params, space, ts = pipe.data, pipe.params, pipe.space, pipe.ts
    log(f"config loaded: {space.dim} calibratable params, "
        f"{data.n_data_points} observation days, grid {len(ts)} points "
        f"({time.perf_counter() - t_load:.1f}s)")

    objective = lambda mode, sp, prm, dt: build_objective_fused(
        sp, prm, data, ts, substeps=substeps, tableau=tableau,
        constraint_mode=mode, dtype=dt, device=dev)
    ll_clamp = objective(CLAMP, space, params, dtype)
    ll_reflect = objective(REFLECT, space, params, dtype)
    if init:
        init_params = read_sepaihrd_parameters(
            init, 4, N=data.population_by_age,
            M_baseline=params.M_baseline.cpu().numpy(), dtype=dtype, device=dev)
        theta0 = space.extract(init_params)
        log(f"warm start from {init}")
    else:
        theta0 = pipe.theta0
    ll0 = float(ll_clamp(theta0[None, :])[0])
    log(f"initial objective at committed params: {ll0:.6e} "
        f"(reference recorded best: {REFERENCE_BEST_LL:.8e})")

    if full:
        pso_cfg = PSOConfig.from_settings(pipe.settings["pso"])
        mh_cfg = MHConfig.from_settings(pipe.settings["mcmc"])
        hill_cfg = HillClimbConfig.from_settings(pipe.settings["hill"])
        nuts_cfg = NUTSConfig.from_settings(pipe.settings["nuts"])
    else:
        pso_cfg = PSOConfig(swarm_size=pso_particles, iterations=pso_iters)
        mh_cfg = MHConfig(iterations=mcmc_iters, burn_in=burn_in,
                          adaptation_period=50, thinning=thinning)
        hill_cfg = HillClimbConfig(iterations=max(pso_iters, 30))
        nuts_cfg = NUTSConfig(iterations=max(mcmc_iters // 10, 50))
    nuts_cfg = nuts_config or nuts_cfg
    nuts = algorithm.lower() == "nuts"
    vag_clamp = None
    if nuts:
        vag_clamp = build_objective_fused_grad(
            space, params, data, ts, substeps=substeps, tableau=tableau,
            constraint_mode=CLAMP, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    k2_k3 = (trace.total("launches", ("k2",)), trace.total("launches", ("k3",)))
    t0 = time.perf_counter()
    result = calibrate(ll_clamp, ll_reflect, space, theta0, generator=gen,
                       algorithm=algorithm,
                       phase1_config=(hill_cfg if algorithm.startswith("hill")
                                      else pso_cfg),
                       mh_config=mh_cfg, nuts_config=nuts_cfg,
                       n_chains=chains, value_and_grad_batch_clamp=vag_clamp)
    best_ll = float(result.best_logl)
    wall = time.perf_counter() - t0
    k2_k3 = (trace.total("launches", ("k2",)) - k2_k3[0],
             trace.total("launches", ("k3",)) - k2_k3[1])
    mh_steps = chain_steps_per_s = grad_evals_per_s = None
    if nuts:
        grad_evals_per_s = chains * vag_clamp.calls / result.phase2_seconds
        nres = result.nuts_result
        log(f"NUTS: {vag_clamp.calls} value_and_grad calls of {chains} chains "
            f"(K2 {k2_k3[0]}, K3 {k2_k3[1]} launches), "
            f"{grad_evals_per_s:.4e} grad-evals/s; mean accept "
            f"{float(nres.mean_accept.mean()):.3f}, mean depth "
            f"{float(nres.mean_depth.mean()):.2f}")
    else:
        mh_steps = -(-mh_cfg.iterations // mh_cfg.thinning) * mh_cfg.thinning
        chain_steps_per_s = (chains * mh_steps / result.phase2_seconds
                             if result.phase2_seconds > 0 else None)
    log(f"calibration done in {wall:.1f}s: best logL {best_ll:.6e} "
        f"({'BEATS' if best_ll > REFERENCE_BEST_LL else 'below'} reference "
        f"{REFERENCE_BEST_LL:.8e}); phase 1 {result.phase1_seconds:.2f}s, "
        f"phase 2 {result.phase2_seconds:.2f}s")

    # float64 re-selection: the f32 objective's noise floor at LL ~1.4e6 is
    # O(1e2), so candidates within that band are indistinguishable in-run.
    # Re-evaluate every chain's MAP and phase 1's best in double precision on
    # the SAME grid, through the same kernel, and pick the true argmax.
    if x64:
        params64, best_ll64, best_theta = params, best_ll, result.best_theta
    else:
        cands = [result.best_theta[None, :]]
        if result.mh_result is not None:
            cands.append(result.mh_result.final_state.best_x)
        if result.phase1_best is not None:
            cands.append(result.phase1_best[None, :])
        cands = torch.unique(torch.cat(cands).to(torch.float64), dim=0)
        lls64, params64 = reselect_float64(space, params, data, ts, cands,
                                           substeps=substeps, tableau=tableau,
                                           device=dev)
        k = int(torch.argmax(lls64))
        best_ll64, best_theta = float(lls64[k]), cands[k]
        log(f"float64 re-selection over {len(cands)} candidate MAPs: "
            f"{best_ll64:.8e}")
    log(f"float64 best log-likelihood: {best_ll64:.8e}")

    summary = {
        "best_logl": best_ll,
        "best_logl_float64": best_ll64,
        "grid_runup_days": int(float(params.runup_days)),
        "initial_logl": ll0,
        "reference_best_logl": REFERENCE_BEST_LL,
        "beats_reference": best_ll64 > REFERENCE_BEST_LL,
        "phase1_logl": (None if result.phase1_logl is None
                        else float(result.phase1_logl)),
        "algorithm": algorithm,
        "tableau": tableau,
        "substeps": substeps,
        "chains": chains,
        "pso": {k: int(v) if isinstance(v, int) else v   # bools and enums
                for k, v in dataclasses.asdict(pso_cfg).items()},
        "mcmc_iterations": nuts_cfg.iterations if nuts else mh_cfg.iterations,
        "mcmc_steps_run": mh_steps,
        "dtype": str(dtype).replace("torch.", ""),
        "seed": seed,
        "wall_seconds": wall,
        "phase1_seconds": result.phase1_seconds,
        "phase2_seconds": result.phase2_seconds,
        "chain_steps_per_s": chain_steps_per_s,
        "grad_evals_per_s": grad_evals_per_s,
        "device": f"{dev.type}/{kind}",
        "n_params": space.dim,
        "observation_days": data.n_data_points,
    }
    if nuts:
        nres = result.nuts_result
        summary.update(
            nuts=dataclasses.asdict(nuts_cfg), value_and_grad_calls=vag_clamp.calls,
            k2_launches=k2_k3[0], k3_launches=k2_k3[1],
            mean_accept=float(nres.mean_accept.mean()),
            mean_depth=float(nres.mean_depth.mean()),
            step_size_median=float(nres.step_sizes.median()),
            samples_shape=list(nres.samples.shape),
            samples_finite=bool(torch.isfinite(nres.samples).all()))
    if out:
        os.makedirs(out, exist_ok=True)
        best_params = space.apply(params64, best_theta.to(torch.float64))
        save_calibration_results(os.path.join(out, "calibrated_parameters.txt"),
                                 best_params, list(space.names), best_ll64)
        if result.samples is not None:
            np.savez_compressed(
                os.path.join(out, "posterior_samples.npz"),
                samples=result.samples.cpu().numpy(),
                logls=result.sample_logls.cpu().numpy(),
                names=np.asarray(space.names))
        with open(os.path.join(out, "run_metadata.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
        log(f"artifacts written to {out}")
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--algorithm", default="psomcmc",
                   choices=["pso", "psomcmc", "hill", "hillmcmc", "nuts"])
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--pso-particles", type=int, default=512)
    p.add_argument("--pso-iters", type=int, default=60)
    p.add_argument("--mcmc-iters", type=int, default=600)
    p.add_argument("--thinning", type=int, default=5)
    p.add_argument("--burn-in", type=int, default=100)
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--x64", action="store_true",
                   help="float64 throughout; default float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default=None,
                   help="warm-start theta from a calibrated_parameters.txt "
                        "(grid semantics stay pinned to initial_guess.txt)")
    p.add_argument("--out", default=None,
                   help="directory for calibrated_parameters.txt, "
                        "posterior_samples.npz and run_metadata.json")
    p.add_argument("--full", action="store_true",
                   help="use the production settings files")
    a = p.parse_args(argv)
    summary = run_calibration(
        algorithm=a.algorithm, chains=a.chains, pso_particles=a.pso_particles,
        pso_iters=a.pso_iters, mcmc_iters=a.mcmc_iters, thinning=a.thinning,
        burn_in=a.burn_in, substeps=a.substeps, tableau=a.tableau, x64=a.x64,
        seed=a.seed, init=a.init, out=a.out, full=a.full, device=a.device)
    return 0 if summary["beats_reference"] else 1


if __name__ == "__main__":
    sys.exit(main())
