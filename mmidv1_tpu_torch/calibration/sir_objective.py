"""Poisson incidence objective for the age-structured SIR model, batched.

Port of ``mmidv1_tpu/calibration/sir_objective.py``, re-design of
``PoissonLikelihoodObjective`` (reference:
``src/sir_age_structured/objectives/PoissonLikelihoodObjective.cpp:46-144``)::

    theta (B, d) -> constrain -> AgeSIRParams with (B,) / (B, A) fields ->
    fixed-grid ODE solve over the daily grid -> incidence lambda(t) * S(t)
    at every output point -> Poisson LL
    sum(max(y, 0) * log(max(sim, 1e-9)) - sim) per chain -> -inf on failure.

A chain fails on its own: the non-finite test reads that chain's
trajectory and log-likelihood only. Eager PyTorch on the device of the
parameters (the JAX objective is plain XLA, with no Pallas kernel).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.sir import AgeSIRParams, sir_incidence, solve_age_sir
from .param_space import CLAMP
from .sir_space import SIRParameterSpace

SIM_FLOOR = 1e-9   # reference: y_sim.cwiseMax(1e-9) (:129)


def build_sir_objective(
    space: SIRParameterSpace,
    base_params: AgeSIRParams,
    observed_incidence: np.ndarray,
    ts: np.ndarray,
    initial_state: np.ndarray,
    *,
    substeps: int = 4,
    tableau: str = "dopri5",
    constraint_mode: str = CLAMP,
    dtype: torch.dtype = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``loglik_batch(theta (B, d)) -> (B,)`` for the age-SIR
    calibration, on the device of ``base_params``.

    ``observed_incidence``: ``(T, A)`` new confirmed cases (the reference
    uses ``CalibrationData::getNewConfirmedCases``, ``CalibrationDemo.cpp:50``).
    """
    dtype = dtype or base_params.dtype
    dev = base_params.device
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dev, dtype)
    ts_t, obs = t(ts), t(observed_incidence)
    if obs.shape[0] != ts_t.shape[0]:
        raise ValueError(
            f"observed incidence has {obs.shape[0]} rows but the time grid has "
            f"{ts_t.shape[0]} points")
    y0 = t(initial_state)
    obs_clamped = torch.clamp_min(obs, 0.0)[:, None, :]           # (T, 1, A)

    def loglik_batch(theta: torch.Tensor) -> torch.Tensor:
        theta = space.constrain(theta.to(dtype), constraint_mode)
        params = space.apply(base_params, theta)
        y = y0.expand(theta.shape[:1] + y0.shape)
        traj = solve_age_sir(params, y, ts_t, method="fixed",
                             substeps=substeps, tableau=tableau)  # (T, B, 3, A)
        sim = torch.clamp_min(sir_incidence(params, traj), SIM_FLOOR)
        ll = torch.sum(obs_clamped * torch.log(sim) - sim, dim=(0, 2))
        bad = ~torch.isfinite(ll) | ~torch.isfinite(traj).all(dim=(0, 2, 3))
        return torch.where(bad, torch.full_like(ll, -float("inf")), ll)

    return loglik_batch
