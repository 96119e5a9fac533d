"""Spain-2020 pipeline setup shared by the port's entry points.

Port of ``mmidv1_tpu/cli/common.py:51-106`` (``load_spain_pipeline``): the
data/configuration load sequence of the reference's ``main.cpp:182-260``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.logging import get_logger

# the repository root: data/ and the package sit side by side
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SpainPipeline(NamedTuple):
    """Everything main.cpp assembles before calibration (:182-316)."""

    root: str
    data: object           # CalibrationData
    params: object         # SEPAIHRDParams
    space: object          # ParameterSpace
    ts: np.ndarray         # full grid incl. run-up
    theta0: torch.Tensor
    settings: dict         # {algorithm_name: settings dict}


def load_spain_pipeline(root: Optional[str] = None, *,
                        num_days: Optional[int] = None,
                        dtype: torch.dtype = torch.float32, device="cuda",
                        start_date: str = "2020-03-01",
                        end_date: str = "2020-12-31") -> SpainPipeline:
    """Load the reference-compatible configuration tree
    (``data/configuration/*`` + ``data/contacts.csv`` +
    ``data/processed/processed_data.csv``) exactly as ``main.cpp:208-260``;
    parameters and space live on ``device`` in ``dtype``."""
    from ..calibration.objective import make_time_grid
    from ..calibration.param_space import ParameterSpace
    from ..data import (CalibrationData, read_param_bounds,
                        read_params_to_calibrate, read_proposal_sigmas,
                        read_sepaihrd_parameters, read_settings)
    from ..data.contact_matrix import read_matrix_from_csv

    log = get_logger("cli")
    root = root or REPO_ROOT
    cfg = os.path.join(root, "data", "configuration")

    data = CalibrationData.from_csv(
        os.path.join(root, "data", "processed", "processed_data.csv"),
        start_date, end_date)
    if num_days is not None and num_days < data.n_data_points:
        fields = ("new_confirmed", "new_deaths", "new_hospitalizations",
                  "new_icu", "cumulative_confirmed", "cumulative_deaths",
                  "cumulative_hospitalizations", "cumulative_icu")
        data = dataclasses.replace(
            data, **{f: getattr(data, f)[:num_days] for f in fields},
            dates=data.dates[:num_days])
    M = read_matrix_from_csv(os.path.join(root, "data", "contacts.csv"), 4, 4)
    params = read_sepaihrd_parameters(
        os.path.join(cfg, "initial_guess.txt"), 4,
        N=data.population_by_age, M_baseline=M, dtype=dtype, device=device)

    names = read_params_to_calibrate(os.path.join(cfg, "params_to_calibrate.txt"))
    bounds = read_param_bounds(os.path.join(cfg, "param_bounds.txt"))
    sigmas = read_proposal_sigmas(os.path.join(cfg, "proposal_sigmas.txt"))
    space = ParameterSpace.create(names, bounds, sigmas, params, dtype=dtype,
                                  device=device)
    ts = make_time_grid(float(params.runup_days), data.n_data_points)
    theta0 = space.extract(params)

    settings = {}
    for key, fname in (("mcmc", "mcmc_settings.txt"),
                       ("pso", "pso_settings.txt"),
                       ("hill", "hill_climbing_settings.txt"),
                       ("nuts", "nuts_settings.txt")):
        path = os.path.join(cfg, fname)
        if os.path.exists(path):
            settings[key] = read_settings(path)

    log.info(f"loaded Spain-2020 pipeline: {space.dim} calibratable params, "
             f"{data.n_data_points} observation days, grid {len(ts)} points")
    return SpainPipeline(root=root, data=data, params=params, space=space,
                         ts=ts, theta0=theta0, settings=settings)
