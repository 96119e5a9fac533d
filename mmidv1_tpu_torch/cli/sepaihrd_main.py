"""``sepaihrd_age_structured_main`` — the full Spain-2020 pipeline CLI.

Port of ``mmidv1_tpu/cli/sepaihrd_main.py``, re-design of the reference's
primary executable (``src/model/main.cpp:136-563``):

    data + configuration -> baseline simulation (CSV) -> calibration with
    ``--algorithm pso|psomcmc|hill|hillmcmc|nuts`` (:48-79) ->
    saveCalibrationResults -> R0 / Rt report -> full post-calibration report.

Every objective value the calibration asks for goes through the fused CUDA
kernel (K1, ``ops/sepaihrd_fused.py``), every NUTS value and gradient through
K2 + K3 (``ops/sepaihrd_adjoint.py``); the baseline and calibrated
simulations and the report replay run eager PyTorch on the same device.
``--device cpu`` runs everything on the host, the kernels' plain versions
included (for checks at small sizes).

Run:  python -m mmidv1_tpu_torch.cli.sepaihrd_main --algorithm psomcmc [options]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ..utils.fileutils import ensure_directory_exists, join_paths
from ..utils.logging import get_logger

ALGORITHMS = ("pso", "psomcmc", "hill", "hillmcmc", "nuts")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sepaihrd_age_structured_main",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--algorithm", "-a", default="psomcmc", choices=ALGORITHMS,
                   help="calibration algorithm menu (reference main.cpp:48-79)")
    p.add_argument("--project-root", default=None)
    p.add_argument("--output-dir", default=None,
                   help="default <root>/data/output")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the host")
    p.add_argument("--x64", action="store_true",
                   help="float64 throughout; default float32")
    p.add_argument("--chains", type=int, default=64,
                   help="MCMC ensemble size (the reference runs 1 chain)")
    p.add_argument("--num-days", type=int, default=None,
                   help="truncate the observation window (smoke tests)")
    p.add_argument("--substeps", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-report", action="store_true",
                   help="skip the post-calibration analysis stage")
    p.add_argument("--ppc-samples", type=int, default=100)
    p.add_argument("--scale", type=float, default=1.0,
                   help="scale factor on configured iteration counts "
                        "(e.g. 0.01 for a smoke run)")
    return p


def run(argv=None) -> dict:
    """The whole pipeline, as :func:`main` runs it; returns its summary
    (log-likelihoods, R0 and Rt, phase and report seconds, the configs, the
    output directory)."""
    args = build_parser().parse_args(argv)
    log = get_logger("sepaihrd_main")

    from .. import constants as C
    from ..analysis import calculate_r0, calculate_rt, generate_full_report
    from ..calibration.calibrator import calibrate
    from ..calibration.hill import HillClimbConfig
    from ..calibration.mh import MHConfig
    from ..calibration.nuts import NUTSConfig
    from ..calibration.param_space import CLAMP, REFLECT
    from ..calibration.pso import PSOConfig
    from ..data import save_calibration_results
    from ..models import sepaihrd
    from ..models.results import save_results_csv
    from ..ops import build_objective_fused, build_objective_fused_grad
    from ..utils.device import resolve_device
    from .common import load_spain_pipeline

    dev = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log.info(f"device: {dev.type} / {kind}; dtype {dtype}")

    pipe = load_spain_pipeline(args.project_root, num_days=args.num_days,
                               dtype=dtype, device=dev)
    out_dir = args.output_dir or join_paths(pipe.root, "data", "output")
    ensure_directory_exists(out_dir)
    ts_t = torch.as_tensor(pipe.ts, dtype=dtype, device=dev)

    # ---- baseline simulation at the initial-guess parameters (:263-367) ----
    y0 = sepaihrd.runup_seeded_state(pipe.params, None)
    with torch.inference_mode():
        traj = sepaihrd.solve(pipe.params, y0, ts_t, method="fixed",
                              substeps=args.substeps)
    baseline_csv = join_paths(out_dir, "sepaihrd_age_baseline_results.csv")
    save_results_csv(baseline_csv, pipe.ts, traj.cpu().numpy(), C.COMPARTMENTS)
    log.info(f"baseline simulation saved: {baseline_csv}")

    # ---- calibration (:377-433) -------------------------------------------
    def scaled(n, lo=2):
        return max(lo, int(n * args.scale))

    mh_cfg = MHConfig.from_settings(pipe.settings.get("mcmc", {}))
    mh_cfg = dataclasses.replace(
        mh_cfg, iterations=scaled(mh_cfg.iterations),
        burn_in=scaled(mh_cfg.burn_in, 0),
        thinning=max(1, min(mh_cfg.thinning, scaled(mh_cfg.iterations) // 2)))
    pso_cfg = PSOConfig.from_settings(pipe.settings.get("pso", {}))
    pso_cfg = dataclasses.replace(pso_cfg, iterations=scaled(pso_cfg.iterations))
    hill_cfg = HillClimbConfig.from_settings(pipe.settings.get("hill", {}))
    hill_cfg = dataclasses.replace(hill_cfg,
                                   iterations=scaled(hill_cfg.iterations))
    nuts_cfg = NUTSConfig.from_settings(pipe.settings.get("nuts", {}))
    nuts_cfg = dataclasses.replace(nuts_cfg,
                                   iterations=scaled(nuts_cfg.iterations))

    objective = lambda mode: build_objective_fused(
        pipe.space, pipe.params, pipe.data, pipe.ts, substeps=args.substeps,
        constraint_mode=mode, dtype=dtype, device=dev)
    loglik_clamp, loglik_reflect = objective(CLAMP), objective(REFLECT)
    vag_clamp = None
    if args.algorithm == "nuts":
        vag_clamp = build_objective_fused_grad(
            pipe.space, pipe.params, pipe.data, pipe.ts,
            substeps=args.substeps, constraint_mode=CLAMP, dtype=dtype,
            device=dev)
    theta0 = pipe.theta0
    ll0 = float(loglik_clamp(theta0[None, :])[0])
    log.info(f"initial objective: {ll0:.6e}")

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # mh_config is passed for 'pso'/'hill' too — reference parity: the menu
    # maps pso == psomcmc and hill == hillmcmc to the same two-phase run
    # (main.cpp:69-72, enum PSO_MCMC/HILL_MCMC)
    result = calibrate(loglik_clamp, loglik_reflect, pipe.space, theta0,
                       generator=gen, algorithm=args.algorithm,
                       phase1_config=(hill_cfg if args.algorithm.startswith("hill")
                                      else pso_cfg),
                       mh_config=mh_cfg, nuts_config=nuts_cfg,
                       n_chains=args.chains,
                       value_and_grad_batch_clamp=vag_clamp)
    best_ll = float(result.best_logl)
    log.info(f"calibration ({args.algorithm}) done in "
             f"{time.perf_counter() - t0:.1f}s (phase 1 "
             f"{result.phase1_seconds:.2f}s, phase 2 "
             f"{result.phase2_seconds:.2f}s): best logL {best_ll:.6e} "
             f"(improvement {best_ll - ll0:+.3e})")

    # ---- save re-loadable calibrated parameters (:436-458) ----------------
    best_params = pipe.space.apply(pipe.params, result.best_theta.to(dtype))
    calib_file = join_paths(out_dir, "calibrated_parameters.txt")
    save_calibration_results(calib_file, best_params, list(pipe.space.names),
                             best_ll)
    log.info(f"calibrated parameters saved: {calib_file}")

    # final calibrated simulation
    y0b, _ = sepaihrd.initial_state_for_params(best_params, y0)
    with torch.inference_mode():
        traj_b = sepaihrd.solve(best_params, y0b, ts_t, method="fixed",
                                substeps=args.substeps)
    save_results_csv(join_paths(out_dir, "sepaihrd_age_calibrated_results.csv"),
                     pipe.ts, traj_b.cpu().numpy(), C.COMPARTMENTS)

    # ---- reproduction numbers (:461-496) ----------------------------------
    r0 = float(calculate_r0(best_params))
    mid = len(pipe.ts) // 2
    rt0 = float(calculate_rt(best_params, traj_b[0, 0], float(pipe.ts[0])))
    rt_mid = float(calculate_rt(best_params, traj_b[mid, 0],
                                float(pipe.ts[mid])))
    log.info(f"R0 = {r0:.4f}; Rt(t={pipe.ts[0]:.0f}) = {rt0:.4f}; "
             f"Rt(t={pipe.ts[mid]:.0f}) = {rt_mid:.4f}")

    summary = dict(
        algorithm=args.algorithm, device=f"{dev.type}/{kind}",
        dtype=str(dtype).replace("torch.", ""), chains=args.chains,
        initial_logl=ll0, best_logl=best_ll, r0=r0, rt0=rt0, rt_mid=rt_mid,
        phase1_seconds=result.phase1_seconds,
        phase2_seconds=result.phase2_seconds,
        hill=dataclasses.asdict(hill_cfg), mcmc=dataclasses.asdict(mh_cfg),
        nuts=dataclasses.asdict(nuts_cfg),
        mh_steps=(None if result.mh_result is None
                  else result.mh_result.final_state.step),
        samples_shape=(None if result.samples is None
                       else list(result.samples.shape)),
        report_seconds=None, report_draws=None, out_dir=out_dir)

    # ---- post-calibration report (:498-563) --------------------------------
    if not args.skip_report and result.samples is not None:
        # strip warm-up draws from the published posterior: stored samples
        # cover ALL iterations (burn-in/adaptation included), and the report
        # takes an ITERATION-axis burn_in (thinned units for MH)
        rep_burn = (nuts_cfg.adaptation_window if args.algorithm == "nuts"
                    else mh_cfg.burn_in // max(1, mh_cfg.thinning))
        # tiny --scale smoke configs: never burn away the whole trace
        rep_burn = min(rep_burn, max(0, result.samples.shape[0] - 1))
        t0 = time.perf_counter()
        rep = generate_full_report(
            result.samples, pipe.space, pipe.params, pipe.data,
            pipe.ts, out_dir, num_samples_for_ppc=args.ppc_samples,
            burn_in=rep_burn, substeps=args.substeps, seed=args.seed)
        summary.update(report_seconds=time.perf_counter() - t0,
                       report_draws=rep["n_draws"])
        log.info(f"full report written under {out_dir} "
                 f"({rep['n_draws']} posterior draws, "
                 f"{summary['report_seconds']:.1f}s)")

    print(f"best_loglikelihood {best_ll:.8e}")
    print(f"R0 {r0:.6f}")
    return summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
