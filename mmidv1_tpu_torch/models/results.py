"""Trajectory post-processing: compartment extraction, CSV saving, incidence.

A copy of ``mmidv1_tpu/models/results.py`` (NumPy on the host); the CSV
format is the same byte for byte.

Re-design of ``SimulationResultProcessor``
(reference: ``src/sir_age_structured/SimulationResultProcessor.cpp:14-189``).
Trajectories here are dense ``(T, n_compartments, n_ages)`` arrays, so
"extraction" is an index; the CSV format (``Time,S0,...,CumICU3`` header, one
row per output time) matches ``saveResultsToCSV`` (:103-142) so downstream
tooling reads either implementation's files.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..utils.exceptions import InvalidResultException

SIR_COMPARTMENTS = ("S", "I", "R")


def state_names(compartments: Sequence[str], n_ages: int) -> list:
    """Flat names S0..S{A-1},E0,... matching the reference's SoA layout."""
    return [f"{c}{i}" for c in compartments for i in range(n_ages)]


def compartment_data(traj: np.ndarray, compartments: Sequence[str],
                     name: str) -> np.ndarray:
    """(T, n_ages) matrix of one compartment by name
    (``getCompartmentData``, :14-101)."""
    names = list(compartments)
    if name not in names:
        raise InvalidResultException(
            "compartment_data",
            f"Compartment '{name}' not found; available: {names}")
    return np.asarray(traj)[:, names.index(name), :]


def save_results_csv(path: str, time_points: Sequence[float],
                     traj: np.ndarray, compartments: Sequence[str]) -> None:
    """Write a trajectory in the reference's result-CSV format
    (``saveResultsToCSV``, :103-142): ``Time,<state names...>`` header then
    one row per output time with the state raveled compartment-major."""
    traj = np.asarray(traj)
    if traj.ndim != 3 or traj.shape[0] != len(time_points):
        raise InvalidResultException(
            "save_results_csv",
            f"Expected (T, C, A) trajectory with T={len(time_points)}, got "
            f"{traj.shape}")
    if traj.shape[1] != len(compartments):
        raise InvalidResultException(
            "save_results_csv",
            f"{traj.shape[1]} compartments in trajectory vs "
            f"{len(compartments)} names")
    n_ages = traj.shape[2]
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write("Time," + ",".join(state_names(compartments, n_ages)) + "\n")
        for t, state in zip(time_points, traj):
            f.write(f"{t:g}," + ",".join(f"{v:.10g}" for v in state.ravel())
                    + "\n")
