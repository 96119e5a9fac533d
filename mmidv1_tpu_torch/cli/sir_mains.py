"""The three scalar-SIR runners: ``sir_model``, ``sir_pop_var``, ``sir_stochastic``.

Port of ``mmidv1_tpu/cli/sir_mains.py``, re-design of
``src/base/main/{sir_main,sir_population_variable_main,
sir_stochastic_main}.cpp``. All three read the reference's
``input_parameters.txt`` format and write the same output CSVs (under
``data/output/`` unless ``--output-dir`` says otherwise):

    sir_result.csv                         (t,S,I,R)
    sir_variable_population_result.csv     (t,S,I,R) + equilibria on stdout
    stochastic_sir_stats.csv               (t,mean_*,median_*,p05_*,p95_*)
    stochastic_sir_sim_<k>.csv             (first <=100 simulations)

They compute in float32, as the JAX mains do from the shell; ``--x64``
switches to float64 (the JAX package's ``jax_enable_x64``). The solves run
on the card unless ``--device cpu``.

Run:  python -m mmidv1_tpu_torch.cli.sir_mains {deterministic|popvar|stochastic}
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..utils.fileutils import (ensure_directory_exists, get_output_path,
                               get_project_root, join_paths)
from ..utils.logging import get_logger

MAX_SAVED_SIMS = 100   # reference SIR_stochastic.cpp:117


def _load_params(args):
    from ..data import read_scalar_sir_parameters

    path = args.params
    if path is None:
        root = get_project_root(args.project_root or os.getcwd())
        path = join_paths(root, "data", "configuration",
                          "sir_input_parameters.txt")
    return read_scalar_sir_parameters(path)


def _out(args, name: str) -> str:
    if args.output_dir:
        return join_paths(ensure_directory_exists(args.output_dir), name)
    return get_output_path(name, root=args.project_root)


def _setup(args):
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    return dev, torch.float64 if args.x64 else torch.float32


def _write_trajectory(path: str, ts, traj: np.ndarray):
    with open(path, "w") as f:
        f.write("t,S,I,R\n")
        f.write("".join(f"{t:g},{S:.10g},{I:.10g},{R:.10g}\n"
                        for t, (S, I, R) in zip(ts.tolist(), traj.tolist())))


def _solve(rhs, p, prm, ts, dev, dtype):
    """RKF45 at ``atol = eps``, ``rtol = 0`` from ``dt0 = h`` (GSL's stepper
    in the reference); returns the trajectory on the host and the
    controller's attempts."""
    from ..ode import integrate_times

    y0 = torch.tensor([prm["S0"], prm["I0"], prm["R0"]], dtype=dtype,
                      device=dev)
    stats = {}
    traj = integrate_times(lambda t, y: rhs(t, y, p), y0, ts, atol=prm["eps"],
                           rtol=0.0, dt0=prm["h"], method="rkf45", stats=stats)
    return traj.cpu().numpy(), stats["attempts"]


def run_deterministic(args) -> int:
    """``sir_model``: RKF45 solve of the classic SIR, daily reporting grid
    (the main pins t to [0, 365], ``sir_main.cpp:21-22``)."""
    from ..models.sir import SIRParams, sir_rhs

    log = get_logger("sir_model")
    dev, dtype = _setup(args)
    prm = _load_params(args)
    p = SIRParams(N=prm["N"], beta=prm["beta"], gamma=prm["gamma"])
    ts = np.arange(0.0, 365.0 + 1.0)
    t0 = time.perf_counter()
    traj, attempts = _solve(sir_rhs, p, prm, ts, dev, dtype)
    seconds = time.perf_counter() - t0
    out = _out(args, "sir_result.csv")
    _write_trajectory(out, ts, traj)
    log.info(f"deterministic SIR finished in {seconds:.2f}s ({attempts} "
             f"attempts) -> {out}")
    return 0


def run_popvar(args) -> int:
    """``sir_pop_var``: SIR with births/deaths + equilibria report
    (``SIR_population_variable.cpp:21-143``)."""
    from ..models.sir import SIRParams, equilibria, sir_vital_rhs

    log = get_logger("sir_pop_var")
    dev, dtype = _setup(args)
    prm = _load_params(args)
    p = SIRParams(N=prm["N"], beta=prm["beta"], gamma=prm["gamma"],
                  B=prm["B"], mu=prm["mu"])
    ts = np.arange(prm["t_start"], prm["t_end"] + 1.0)
    t0 = time.perf_counter()
    traj, attempts = _solve(sir_vital_rhs, p, prm, ts, dev, dtype)
    seconds = time.perf_counter() - t0
    out = _out(args, "sir_variable_population_result.csv")
    _write_trajectory(out, ts, traj)

    eq = equilibria(p)
    print("Equilibria for SIR model with population variation "
          "(assuming B=mu*N for constant pop. equilibrium):")
    print(f"Disease-Free Equilibrium (DFE): S={eq['dfe'][0]:.6g}, I=0, R=0")
    print(f"Basic Reproduction Number R0 = {eq['R0']:.6g}")
    if eq["endemic"] is not None:
        S, I, R = eq["endemic"]
        print("Endemic Equilibrium (EE) exists:")
        print(f"  S*={S:.6g}, I*={I:.6g}, R*={R:.6g}")
    else:
        print("Endemic Equilibrium (EE) does not exist (R0 <= 1)")
    log.info(f"solve {seconds:.2f}s ({attempts} attempts); results -> {out}")
    return 0


def run_stochastic(args) -> int:
    """``sir_stochastic``: binomial-chain ensemble + summary statistics
    (``SIR_stochastic.cpp:75-255``); every simulation advances at once, with
    its draws from one ``torch.Generator`` seeded by ``--seed``."""
    from ..models.sir import SIRParams, run_stochastic_sir, stochastic_statistics

    log = get_logger("sir_stochastic")
    dev, dtype = _setup(args)
    prm = _load_params(args)
    p = SIRParams(N=prm["N"], beta=prm["beta"], gamma=prm["gamma"])
    n_sims = int(prm["numSimulations"])
    h = max(prm["h"], 0.01)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    trajs = run_stochastic_sir(
        p, [prm["S0"], prm["I0"], prm["R0"]], prm["t_start"], prm["t_end"], h,
        n_sims, generator=gen, dtype=dtype, device=dev).cpu().numpy()
    seconds = time.perf_counter() - t0
    stats = stochastic_statistics(trajs)
    log.info(f"{n_sims} stochastic simulations in {seconds:.2f}s")

    t1 = time.perf_counter()
    ts = prm["t_start"] + h * np.arange(trajs.shape[1])
    out = _out(args, "stochastic_sir_stats.csv")
    cols = ("S", "I", "R")
    names = ("mean", "median", "p05", "p95")
    with open(out, "w") as f:
        f.write("t," + ",".join(f"{s}_{c}" for s in names for c in cols) + "\n")
        table = np.concatenate([stats[s] for s in names], axis=1).tolist()
        f.write("".join(f"{t:g}," + ",".join(f"{v:.6g}" for v in row) + "\n"
                        for t, row in zip(ts.tolist(), table)))

    ts_list = ts.tolist()
    for k in range(min(n_sims, MAX_SAVED_SIMS)):
        with open(_out(args, f"stochastic_sir_sim_{k}.csv"), "w") as f:
            f.write("t,S,I,R\n")
            f.write("".join(f"{t:g},{S:g},{I:g},{R:g}\n" for t, (S, I, R)
                            in zip(ts_list, trajs[k].tolist())))
    log.info(f"stats -> {out}; {min(n_sims, MAX_SAVED_SIMS)} per-sim CSVs "
             f"({time.perf_counter() - t1:.2f}s)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sir_mains", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("variant",
                   choices=["deterministic", "popvar", "stochastic"])
    p.add_argument("--params", default=None,
                   help="input_parameters.txt path (default: "
                        "<root>/data/configuration/sir_input_parameters.txt)")
    p.add_argument("--project-root", default=None)
    p.add_argument("--output-dir", default=None,
                   help="default <root>/data/output")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the host")
    p.add_argument("--x64", action="store_true",
                   help="float64 throughout; default float32")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"deterministic": run_deterministic, "popvar": run_popvar,
            "stochastic": run_stochastic}[args.variant](args)


if __name__ == "__main__":
    sys.exit(main())
