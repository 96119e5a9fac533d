"""``sir_age_structured_calibration_demo`` — hill+MH calibration of the age-SIR.

Port of ``mmidv1_tpu/cli/sir_calibration_demo.py``, re-design of
``src/sir_age_structured/CalibrationDemo.cpp``: calibrate q, scale_C_total,
gamma_0..3 against observed new-confirmed cases via the Poisson incidence
objective (batched over chains, eager PyTorch), Phase 1 hill climbing ->
Phase 2 adaptive Metropolis, then save the MCMC samples and the best fit's
simulated I per age group. Float32 unless ``--x64``; on the card unless
``--device cpu``.

Run:  python -m mmidv1_tpu_torch.cli.sir_calibration_demo [options]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..utils.fileutils import (ensure_directory_exists, get_project_root,
                               join_paths)
from ..utils.logging import get_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sir_age_structured_calibration_demo",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--project-root", default=None)
    p.add_argument("--output-dir", default=None,
                   help="default <root>/data/calibration_output")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the host")
    p.add_argument("--x64", action="store_true",
                   help="float64 throughout; default float32")
    p.add_argument("--hill-iters", type=int, default=150)
    p.add_argument("--mcmc-iters", type=int, default=2000)
    p.add_argument("--burn-in", type=int, default=200)
    p.add_argument("--chains", type=int, default=32)
    p.add_argument("--num-days", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def setup(args, dev, dtype):
    """``(space, params0, y0, ts, observed, ll_clamp, ll_reflect)`` of the
    demo (``CalibrationDemo.cpp:53-66``)."""
    from ..calibration.param_space import CLAMP, REFLECT
    from ..calibration.sir_objective import build_sir_objective
    from ..calibration.sir_space import SIRParameterSpace
    from ..data import CalibrationData
    from ..data.contact_matrix import read_matrix_from_csv
    from ..models.sir import make_age_sir_params

    root = args.project_root or get_project_root()
    C = read_matrix_from_csv(join_paths(root, "data", "contacts.csv"), 4, 4)
    data = CalibrationData.from_csv(
        join_paths(root, "data", "processed", "processed_data.csv"),
        "2020-03-01", "2020-12-31")
    N = data.population_by_age
    params0 = make_age_sir_params(N=N, C=C, q=0.1, gamma=[0.1] * 4,
                                  scale_C=1.0, dtype=dtype, device=dev)
    I0 = data.initial_active_cases()
    y0 = np.stack([N - I0, I0, np.zeros_like(I0)])

    observed = data.new_confirmed
    if args.num_days is not None:
        observed = observed[:args.num_days]
    ts = np.arange(float(len(observed)))

    names = ["q", "scale_C_total"] + [f"gamma_{i}" for i in range(4)]
    bounds = {"q": (1e-4, 1.0), "scale_C_total": (0.1, 5.0),
              **{f"gamma_{i}": (0.01, 1.0) for i in range(4)}}
    sigmas = {"q": 0.01, "scale_C_total": 0.05,
              **{f"gamma_{i}": 0.01 for i in range(4)}}
    space = SIRParameterSpace.create(names, bounds, sigmas, params0,
                                     dtype=dtype, device=dev)
    ll_clamp, ll_reflect = (build_sir_objective(space, params0, observed, ts,
                                                y0, constraint_mode=mode)
                            for mode in (CLAMP, REFLECT))
    return root, space, params0, y0, ts, ll_clamp, ll_reflect


def run(argv=None) -> dict:
    """The whole demo; returns the initial and best objective values, the
    phase seconds and the two output paths."""
    args = build_parser().parse_args(argv)

    from ..calibration.calibrator import calibrate
    from ..calibration.hill import HillClimbConfig
    from ..calibration.mh import MHConfig
    from ..models.sir import solve_age_sir
    from ..utils.device import resolve_device

    log = get_logger("sir_calibration_demo")
    dev = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    root, space, params0, y0, ts, ll_clamp, ll_reflect = setup(args, dev, dtype)
    theta0 = space.extract(params0)
    ll0 = float(ll_clamp(theta0[None, :])[0])
    log.info(f"initial objective: {ll0:.6e}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    result = calibrate(
        ll_clamp, ll_reflect, space, theta0, generator=gen,
        algorithm="hillmcmc",
        phase1_config=HillClimbConfig(iterations=args.hill_iters),
        mh_config=MHConfig(iterations=args.mcmc_iters, burn_in=args.burn_in,
                           adaptation_period=100, thinning=1),
        n_chains=args.chains)
    log.info(f"calibration done in {time.perf_counter() - t0:.1f}s")

    best_theta = result.best_theta
    print("\n--- Final Calibration Results ---")
    print("Best Parameters:")
    for name, v in zip(space.names, best_theta.tolist()):
        print(f"  {name}: {v:.6f}")
    print(f"Best Objective Value:        {float(result.best_logl):.6f}")

    # Save MCMC samples (CalibrationDemo.cpp:183-220 format)
    out_dir = ensure_directory_exists(
        args.output_dir or join_paths(root, "data", "calibration_output"))
    out = join_paths(out_dir, "mcmc_samples.csv")
    samples = result.samples.reshape(-1, space.dim).cpu().numpy()
    logls = result.sample_logls.reshape(-1).cpu().numpy()
    with open(out, "w") as f:
        f.write("sample_index,objective_value," + ",".join(space.names) + "\n")
        f.write("".join(f"{i},{ll:.6f}" + "".join(f",{v:.8e}" for v in row)
                        + "\n" for i, (ll, row)
                        in enumerate(zip(logls.tolist(), samples.tolist()))))
    log.info(f"MCMC samples -> {out}")

    # the best fit's simulated I compartment per age group in the
    # reference's format (CalibrationDemo.cpp:236-281: Time,
    # simulated_I_<age-label> columns)
    best_params = space.apply(params0, best_theta.to(dtype))
    y0_t = torch.as_tensor(y0).to(dev, dtype)
    with torch.inference_mode():
        traj = solve_age_sir(best_params, y0_t, ts, method="fixed")
    traj = traj.cpu().numpy()
    age_labels = ["0_30", "30_60", "60_80", "80_plus"]
    if len(age_labels) != traj.shape[-1]:
        age_labels = [str(j) for j in range(traj.shape[-1])]
    sim_out = join_paths(out_dir, "simulated_incidence_best_fit.csv")
    with open(sim_out, "w") as f:
        f.write("Time" + "".join(f",simulated_I_{a}" for a in age_labels)
                + "\n")
        for t, row in zip(ts.tolist(), traj[:, 1, :].tolist()):
            f.write(f"{t:g}" + "".join(f",{v:.4f}" for v in row) + "\n")
    log.info(f"best-fit simulated incidence -> {sim_out}")
    return dict(initial_logl=ll0, best_logl=float(result.best_logl),
                phase1_seconds=result.phase1_seconds,
                phase2_seconds=result.phase2_seconds,
                samples_finite=bool(np.isfinite(samples).all()),
                samples_shape=list(result.samples.shape),
                mcmc_samples=out, best_fit=sim_out)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
