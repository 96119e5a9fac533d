"""``sepaihrd_objective_benchmark`` — the performance harness CLI.

Port of ``mmidv1_tpu/cli/benchmark_main.py``, re-design of
``src/model/sepaihrd_objective_benchmark_main.cpp``: ``--mode
micro|pso|hill|mcmc|hillmcmc|all`` with repeats and jittered evaluations,
reporting µs/eval, evals/sec, optimizer wall time and objective call counts.
The batch-size axis (``--batch``) replaces the reference's cache on/off axis.

Every objective is the fused kernel K1 (``build_objective_fused``, REFLECT
for sampling and CLAMP for the optimizers); ``--device cpu`` runs its plain
version on the host. Host clocks vary between calls, so beside the median
of ``--repeats`` each micro metric also gets its min and max. The JAX
package's in-scan metric (objective calls inside one device loop) has no
eager twin: here it is 20 back-to-back calls on freshly jittered inputs,
ended by one synchronization.

Run:  python -m mmidv1_tpu_torch.cli.benchmark_main --mode micro --batch 4096
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import get_logger
from .common import load_spain_pipeline

INSCAN_CALLS = 20


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sepaihrd_objective_benchmark",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="micro",
                   choices=["micro", "pso", "hill", "mcmc", "hillmcmc",
                            "all"])
    p.add_argument("--batch", type=int, default=4096,
                   help="objective batch size")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--iterations", type=int, default=50,
                   help="optimizer/sampler iterations per timed run")
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--tableau", default="dopri5",
                   help="fixed-grid RK tableau (cash_karp with --substeps 3 "
                        "is the JAX package's equal-accuracy fast config)")
    p.add_argument("--num-days", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the host")
    p.add_argument("--x64", action="store_true")
    p.add_argument("--project-root", default=None)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one micro call "
                        "into DIR (Chrome trace format)")
    return p


def _spread(results: dict, name: str, values) -> None:
    """``name`` = the median of ``values``, beside its min and max."""
    results[name] = float(np.median(values))
    results[name + "_min"] = float(np.min(values))
    results[name + "_max"] = float(np.max(values))


def run(argv=None) -> dict:
    """Run the selected modes; returns the results dict :func:`main`
    prints."""
    args = build_parser().parse_args(argv)
    log = get_logger("benchmark")
    dev = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    from ..calibration.calibrator import condition_covariance
    from ..calibration.hill import HillClimbConfig, run_hill_climb
    from ..calibration.mh import MHConfig, run_mh
    from ..calibration.param_space import CLAMP, REFLECT
    from ..calibration.pso import PSOConfig, run_pso
    from ..ops import build_objective_fused

    pipe = load_spain_pipeline(args.project_root, num_days=args.num_days,
                               dtype=dtype, device=dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    results = {"device": f"{dev.type}/{kind}",
               "dtype": str(dtype).replace("torch.", ""),
               "batch": args.batch, "n_params": pipe.space.dim}

    loglik_c, loglik_r = (build_objective_fused(
        pipe.space, pipe.params, pipe.data, pipe.ts, substeps=args.substeps,
        tableau=args.tableau, constraint_mode=mode, dtype=dtype, device=dev)
        for mode in (CLAMP, REFLECT))
    theta0 = pipe.theta0.to(dtype)
    sigmas = pipe.space.sigmas.to(dtype)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    modes = ([args.mode] if args.mode != "all"
             else ["micro", "pso", "hill", "mcmc", "hillmcmc"])

    if "micro" in modes:
        # jittered evaluations like the reference's micro mode (:420-470)
        g = gen(0)
        thetas = theta0[None, :] + 0.01 * sigmas * torch.randn(
            (args.batch, pipe.space.dim), generator=g, dtype=dtype, device=dev)
        t0 = time.perf_counter()
        loglik_r(thetas)
        sync()
        results["micro_compile_s"] = time.perf_counter() - t0
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                loglik_r(thetas)
                sync()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile,
                                                  "micro_trace.json"))
            log.info(f"profiler trace written to {args.profile}")
        dts = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            loglik_r(thetas)
            sync()
            dts.append(time.perf_counter() - t0)
        dts = np.asarray(dts)
        _spread(results, "micro_evals_per_sec", args.batch / dts)
        _spread(results, "micro_us_per_eval", dts / args.batch * 1e6)
        log.info(f"micro: {results['micro_evals_per_sec']:.3e} evals/s "
                 f"({results['micro_us_per_eval']:.2f} us/eval)")

        # the calls of a production loop, back to back: fresh inputs each
        # time, one synchronization at the end
        dts = []
        for rep in range(args.repeats):
            g = gen(10 + rep)
            t0 = time.perf_counter()
            for _ in range(INSCAN_CALLS):
                loglik_r(thetas + 0.001 * torch.randn(
                    thetas.shape, generator=g, dtype=dtype, device=dev))
            sync()
            dts.append((time.perf_counter() - t0) / INSCAN_CALLS)
        dts = np.asarray(dts)
        _spread(results, "micro_evals_per_sec_inscan", args.batch / dts)
        _spread(results, "micro_us_per_eval_inscan", dts / args.batch * 1e6)
        log.info(f"micro (back to back): "
                 f"{results['micro_evals_per_sec_inscan']:.3e} evals/s "
                 f"({results['micro_us_per_eval_inscan']:.2f} us/eval)")

    if "pso" in modes:
        cfg = PSOConfig(swarm_size=min(args.batch, 1024),
                        iterations=args.iterations)
        t0 = time.perf_counter()
        res = run_pso(loglik_c, pipe.space, cfg, generator=gen(0),
                      theta0=theta0)
        best = float(res.best_f)
        wall = time.perf_counter() - t0
        results["pso_wall_s"] = wall
        results["pso_best_logl"] = best
        results["pso_evals"] = cfg.swarm_size * (cfg.iterations + 2)
        log.info(f"pso: {wall:.1f}s wall, best {best:.6e}, "
                 f"~{results['pso_evals']} evals")

    if "hill" in modes:
        cfg = HillClimbConfig(iterations=args.iterations)
        t0 = time.perf_counter()
        res = run_hill_climb(loglik_c, pipe.space, theta0, cfg,
                             generator=gen(0))
        best = float(res.best_logl)
        wall = time.perf_counter() - t0
        results["hill_wall_s"] = wall
        results["hill_best_logl"] = best
        log.info(f"hill: {wall:.1f}s wall, best {best:.6e}")

    if "mcmc" in modes:
        cfg = MHConfig(iterations=args.iterations, burn_in=args.iterations // 5,
                       adaptation_period=25, thinning=1)
        t0 = time.perf_counter()
        res = run_mh(loglik_r, pipe.space, theta0, cfg, generator=gen(0),
                     n_chains=args.chains)
        best = float(res.best_logp)
        wall = time.perf_counter() - t0
        results["mcmc_wall_s"] = wall
        results["mcmc_chain_steps_per_sec"] = args.chains * args.iterations / wall
        results["mcmc_best_logl"] = best
        results["mcmc_mean_acceptance"] = float(res.acceptance_rate.mean())
        log.info(f"mcmc: {wall:.1f}s wall ({args.chains} chains x "
                 f"{args.iterations} steps), best {best:.6e}")

    if "hillmcmc" in modes:
        # the reference harness's combined mode (:88-182): hill-climb to the
        # MAP neighborhood, then sample from there with the hill covariance
        h_cfg = HillClimbConfig(iterations=args.iterations)
        m_cfg = MHConfig(iterations=args.iterations,
                         burn_in=args.iterations // 5,
                         adaptation_period=25, thinning=1)
        t0 = time.perf_counter()
        hres = run_hill_climb(loglik_c, pipe.space, theta0, h_cfg,
                              generator=gen(0))
        cov0 = condition_covariance(hres.final_cov, sigmas)
        mres = run_mh(loglik_r, pipe.space, hres.best_x, m_cfg,
                      generator=gen(1), n_chains=args.chains,
                      initial_cov=cov0)
        mbest = float(mres.best_logp)
        wall = time.perf_counter() - t0
        best = max(float(hres.best_logl), mbest)
        results["hillmcmc_wall_s"] = wall
        results["hillmcmc_best_logl"] = best
        results["hillmcmc_hill_best_logl"] = float(hres.best_logl)
        log.info(f"hillmcmc: {wall:.1f}s wall, best {best:.6e}")
    return results


def main(argv=None) -> int:
    results = run(argv)
    if build_parser().parse_args(argv).json:
        print(json.dumps(results))
    else:
        for k, v in results.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
