"""SEPAIHRD dynamics panels: the ``plot-dynamics`` mode of
``scripts/data_visualization.py``.

Port of ``scripts/data_visualization.py:226-353`` (the reference's
``plot_sepaihrd_dynamics.py:1-160``): per-compartment panels, each age band
plus the total, from a reference-format ``Time,S0..CumICU3`` CSV or, with
``--simulate``, from the port's own forward model at the committed
Spain-2020 inputs (``initial_guess.txt`` or ``--calibrated``). The frame is
plain NumPy (the time column and the ``(T, 44)`` flat state); matplotlib is
imported only when figures are drawn. The script's ``eda`` mode is not here:
it imports neither package and runs beside either as it is.

Usage:
    python -m mmidv1_tpu_torch.cli.data_visualization plot-dynamics --simulate
        [--calibrated calibrated_parameters.txt] [--log] [--prefix P]
        [--formats png pdf] [--out data/visualizations/dynamics]
        [--device cuda|cpu]
    python -m mmidv1_tpu_torch.cli.data_visualization plot-dynamics --csv F
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from .common import REPO_ROOT

AGE_LABELS = ["0-30", "30-60", "60-80", "80+"]
PALETTE = ["#4053d3", "#ddb310", "#b51d14", "#00beff"]
COMPARTMENTS = ["S", "E", "P", "A", "I", "H", "ICU", "R", "D"]
LINE_STYLES = ["-", "--", "-.", ":"]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({"figure.figsize": (12, 7), "axes.titlesize": 16,
                         "axes.labelsize": 13, "axes.grid": True,
                         "grid.alpha": 0.3, "legend.fontsize": 11})
    return plt


def _save(plt, fig, out_dir: str, name: str, formats=("png",)) -> list:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for ext in formats:
        p = os.path.join(out_dir, f"{name}.{ext}")
        fig.savefig(p, dpi=150, bbox_inches="tight")
        paths.append(p)
    plt.close(fig)
    return paths


def frame_columns(time: np.ndarray, flat: np.ndarray,
                  names) -> Dict[str, np.ndarray]:
    """``{"Time": time, name: column}`` from a flat ``(T, n)`` state."""
    cols = {"Time": np.asarray(time)}
    cols.update({n: flat[:, j] for j, n in enumerate(names)})
    return cols


def read_frame_csv(path: str) -> Dict[str, np.ndarray]:
    """A reference-format result CSV (``models/results.save_results_csv``)
    as ``{column name: values}``."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    values = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return {n: values[:, j] for j, n in enumerate(header)}


def plot_dynamics_frame(frame: Dict[str, np.ndarray], out_dir: str,
                        formats=("png",), n_ages: int = 4, prefix: str = "",
                        log_scale: bool = False) -> list:
    """Per-compartment panels (each age band + black dashed total) from a
    ``Time,S0..CumICU3`` frame (``plot_sepaihrd_dynamics.py:19-117``)."""
    plt = _pyplot()
    paths = []
    t = frame["Time"]
    for comp in COMPARTMENTS:
        cols = [f"{comp}{i}" for i in range(n_ages) if f"{comp}{i}" in frame]
        if not cols:
            continue
        fig, ax = plt.subplots()
        for i, c in enumerate(cols):
            ax.plot(t, frame[c], label=f"{comp} age {AGE_LABELS[i]}",
                    color=PALETTE[i % 4], linestyle=LINE_STYLES[i % 4],
                    lw=1.5, alpha=0.85)
        ax.plot(t, np.sum([frame[c] for c in cols], axis=0),
                label=f"total {comp}", color="black", linestyle="--", lw=2.2)
        if log_scale:
            ax.set_yscale("log")
        ax.set_title(f"{prefix}{comp} dynamics")
        ax.set_xlabel("day")
        ax.set_ylabel("individuals")
        ax.legend()
        name = f"{prefix}sepaihrd_{comp}{'_log' if log_scale else ''}"
        paths += _save(plt, fig, out_dir, name, formats)
    return paths


def simulate_frame(calibrated: Optional[str] = None,
                   days: Optional[int] = None, substeps: int = 4,
                   device="cuda", root: Optional[str] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the forward model and return ``(time, flat)``: the observed days
    (t >= 0) and the ``(T, 44)`` state, columns ``S0..S3, E0..E3, ...,
    CumICU3`` (``sepaihrd.state_names(4)``).

    The committed Spain-2020 inputs, float32, the fixed-grid dopri5 solve
    with ``substeps`` a day over the full observation window (306 days for
    2020-03-01..2020-12-31) unless ``days``; ``calibrated`` is a
    ``calibrated_parameters.txt`` read in place of the initial guess.
    """
    import torch

    from ..calibration.objective import make_time_grid
    from ..data import CalibrationData, read_sepaihrd_parameters
    from ..data.contact_matrix import read_matrix_from_csv
    from ..models import sepaihrd
    from ..utils.device import resolve_device

    root = root or REPO_ROOT
    dev = resolve_device(device)
    cfg_dir = os.path.join(root, "data", "configuration")
    data = CalibrationData.from_csv(
        os.path.join(root, "data", "processed", "processed_data.csv"),
        "2020-03-01", "2020-12-31")
    M = read_matrix_from_csv(os.path.join(root, "data", "contacts.csv"), 4, 4)
    src = calibrated or os.path.join(cfg_dir, "initial_guess.txt")
    params = read_sepaihrd_parameters(
        src, 4, N=data.population_by_age, M_baseline=M, dtype=torch.float32,
        device=dev)
    n_days = data.n_data_points if days is None else min(days,
                                                         data.n_data_points)
    ts = make_time_grid(float(params.runup_days), n_days)
    y0 = sepaihrd.runup_seeded_state(params, None)
    traj = sepaihrd.solve(params, y0, ts, method="fixed", substeps=substeps)
    obs = ts >= 0
    flat = traj.detach().cpu().numpy()[obs].reshape(int(obs.sum()), -1)
    return ts[obs], flat


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="data_visualization",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    dyn = sub.add_parser("plot-dynamics",
                         help="per-compartment SEPAIHRD dynamics panels")
    dyn.add_argument("--csv", default=None,
                     help="reference-format simulation CSV; omit with "
                          "--simulate to run the port's model")
    dyn.add_argument("--simulate", action="store_true")
    dyn.add_argument("--calibrated", default=None,
                     help="calibrated_parameters.txt to load (with "
                          "--simulate)")
    dyn.add_argument("--out", default=os.path.join(
        REPO_ROOT, "data", "visualizations", "dynamics"))
    dyn.add_argument("--prefix", default="")
    dyn.add_argument("--log", action="store_true")
    dyn.add_argument("--formats", nargs="*", default=["png"])
    dyn.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.csv:
        frame = read_frame_csv(args.csv)
        if "Time" not in frame:
            print(f"Error: 'Time' column not found in {args.csv}")
            return 1
    elif args.simulate:
        from ..models import sepaihrd

        time, flat = simulate_frame(calibrated=args.calibrated,
                                    device=args.device)
        frame = frame_columns(time, flat, sepaihrd.state_names(4))
    else:
        print("Error: pass --csv or --simulate")
        return 1
    made = plot_dynamics_frame(frame, args.out, tuple(args.formats),
                               prefix=args.prefix, log_scale=args.log)
    print(f"wrote {len(made)} figures -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
