"""``sir_age_structured_main`` — age-SIR baseline + intervention demo CLI.

Port of ``mmidv1_tpu/cli/sir_age_structured_main.py``, re-design of
``src/sir_age_structured/main.cpp``: load contacts + population, run the
baseline age-SIR simulation (adaptive dopri5 at 1e-6), then the
split-simulation intervention demo (contact_reduction 0.3 at t=20, resumed
from the saved state, :102-167), writing result CSVs in the reference's
format. Float32 unless ``--x64``; on the card unless ``--device cpu``.

Run:  python -m mmidv1_tpu_torch.cli.sir_age_structured_main [options]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..utils.fileutils import (ensure_directory_exists, get_output_path,
                               get_project_root, join_paths)
from ..utils.logging import get_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sir_age_structured_main",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--project-root", default=None)
    p.add_argument("--output-dir", default=None,
                   help="default <root>/data/output")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or the host")
    p.add_argument("--x64", action="store_true",
                   help="float64 throughout; default float32")
    p.add_argument("--days", type=float, default=100.0)
    p.add_argument("--q", type=float, default=0.05)
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--intervention-time", type=float, default=20.0)
    p.add_argument("--contact-reduction", type=float, default=0.3)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..data import CalibrationData
    from ..data.contact_matrix import read_matrix_from_csv
    from ..models.interventions import Intervention, solve_age_sir_scheduled
    from ..models.results import SIR_COMPARTMENTS, save_results_csv
    from ..models.sir import make_age_sir_params, solve_age_sir
    from ..utils.device import resolve_device

    log = get_logger("sir_age_structured_main")
    dev = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    root = args.project_root or get_project_root()
    out_path = ((lambda n: join_paths(ensure_directory_exists(args.output_dir), n))
                if args.output_dir else (lambda n: get_output_path(n, root=root)))
    C = read_matrix_from_csv(join_paths(root, "data", "contacts.csv"), 4, 4)
    data = CalibrationData.from_csv(
        join_paths(root, "data", "processed", "processed_data.csv"),
        "2020-03-01", "2020-12-31")
    N = data.population_by_age
    params = make_age_sir_params(N=N, C=C, q=args.q, gamma=[args.gamma] * 4,
                                 dtype=dtype, device=dev)

    I0 = data.initial_active_cases()
    y0 = torch.as_tensor(np.stack([N - I0, I0, np.zeros_like(I0)])).to(dev, dtype)
    ts = np.arange(0.0, args.days + 1.0)

    # --- baseline run (main.cpp:60-100) -------------------------------------
    stats = {}
    t0 = time.perf_counter()
    traj = solve_age_sir(params, y0, ts, method="adaptive", stats=stats)
    traj = traj.cpu().numpy()
    baseline_s = time.perf_counter() - t0
    out = out_path("sir_age_baseline_results.csv")
    save_results_csv(out, ts, traj, SIR_COMPARTMENTS)
    log.info(f"baseline ({stats['attempts']} attempts, {baseline_s:.2f}s) "
             f"-> {out}")

    # --- split-simulation intervention demo (main.cpp:102-167) --------------
    schedule = [Intervention(args.intervention_time, "contact_reduction",
                             args.contact_reduction)]
    traj_i, final_params = solve_age_sir_scheduled(params, y0, ts, schedule)
    traj_i = traj_i.cpu().numpy()
    out_i = out_path("sir_age_intervention_results.csv")
    save_results_csv(out_i, ts, traj_i, SIR_COMPARTMENTS)
    log.info(f"intervention demo -> {out_i} "
             f"(scale_C after: {float(final_params.scale_C):.3f})")

    total_I_base = float(traj[:, 1].sum(axis=1).max())
    total_I_int = float(traj_i[:, 1].sum(axis=1).max())
    print(f"peak_infected_baseline {total_I_base:.1f}")
    print(f"peak_infected_intervention {total_I_int:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
