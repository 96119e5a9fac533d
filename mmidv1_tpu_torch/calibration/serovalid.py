"""Externally-validated (ENE-COVID-consistent) calibration mode.

Port of ``mmidv1_tpu/calibration/serovalid.py`` (:39-105). The reference's
own severity/seed lower bounds (``data/configuration/param_bounds.txt``)
force the Spain-2020 day-64 seroprevalence to ~1.0% — a 20x miss of the
ENE-COVID validation target the reference itself checks
(``src/model/PostCalibrationAnalyser.cpp:289-299``) — while relaxing those
floors 10x reaches sero inside the survey CI at a BETTER Poisson fit. The
shared pieces of that "serovalid" mode:

- :func:`relax_bounds` — variant-C bound relaxation (seed cap, runup floor,
  severity floors / 10) applied to a :class:`ParameterSpace`;
- :func:`make_sero_penalty` — the ENE-COVID data term: a Gaussian pull of
  the model's day-64 seroprevalence toward the survey mean, added to the
  Poisson stream log-likelihood. It runs the eager solve, so
  ``torch.autograd`` differentiates it and its gradient adds onto any
  value-and-grad engine (e.g. the K2/K3 one of
  :func:`mmidv1_tpu_torch.ops.build_objective_fused_grad`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SEVERITY_PREFIXES = ("p_", "h_0", "h_1", "h_2", "h_3", "icu_",
                     "d_H_", "d_ICU_")

# variant-C defaults (results/spain2020_serovalid/serovalid_metadata.json)
SEED_CAP = 50000.0
RUNUP_LO = 5.0
SEVERITY_FLOOR_DIV = 10.0
SERO_SURVEY_SE = 0.0028


def relax_bounds(space, *, seed_cap: float = SEED_CAP,
                 runup_lo: float = RUNUP_LO,
                 severity_floor_div: float = SEVERITY_FLOOR_DIV):
    """Variant-C relaxation of a reference-bounds ``ParameterSpace``.

    Returns ``(relaxed_space, relaxed_indices)``; the relaxed bounds are
    computed in float64 on the host and stored in the space's dtype and on
    its device. The box only grows (every reference-bounds point stays
    interior), so traces sampled under the reference bounds remain valid
    coordinates in the relaxed space.
    """
    names = list(space.names)
    lo0 = space.lower.detach().cpu().numpy().astype(np.float64)
    hi0 = space.upper.detach().cpu().numpy().astype(np.float64)
    lo, hi = lo0.copy(), hi0.copy()
    hi[names.index("seed_exposed")] = seed_cap
    lo[names.index("runup_days")] = runup_lo
    for i, n in enumerate(names):
        if n.startswith(SEVERITY_PREFIXES):
            lo[i] = lo[i] / severity_floor_div
    relaxed = [i for i in range(len(names))
               if lo[i] != lo0[i] or hi[i] != hi0[i]]
    t = lambda x: torch.as_tensor(x).to(device=space.device, dtype=space.dtype)
    return dataclasses.replace(space, lower=t(lo), upper=t(hi)), relaxed


def make_sero_penalty(space, base_params, data, ts, *, substeps: int = 4,
                      tableau: str = "dopri5", se: float = SERO_SURVEY_SE,
                      mean: Optional[float] = None, constraint_mode=None,
                      dtype=None, device=None):
    """ENE-COVID Gaussian data term: ``penalty(thetas (..., d)) -> (...)``,
    ``-(sero(theta)-mean)^2 / (2 se^2)``; ``mean`` defaults to the survey's
    ``analysis.aggregate.ENE_COVID_MEAN`` (0.048).

    ``sero(theta)`` (``penalty.sero_of``) is the population fraction ever
    infected at the ENE-COVID round-1 reference day
    (``analysis.metrics.SERO_TARGET_DAY``) from the fixed-grid trajectory —
    the quantity ``analysis.aggregate.ene_covid_validation`` scores. The
    solve stops at that grid point: later points cannot change it.
    ``penalty.value_and_grad(thetas)`` gives the value and its per-draw
    gradient through ``torch.autograd``. ``dtype``/``device`` default to
    the base parameters'.
    """
    from ..analysis.aggregate import ENE_COVID_MEAN
    from ..analysis.metrics import SERO_TARGET_DAY
    from ..models import sepaihrd
    from ..utils.device import resolve_device
    from .param_space import REFLECT

    if constraint_mode is None:
        constraint_mode = REFLECT
    if mean is None:
        mean = ENE_COVID_MEAN
    dtype = dtype or base_params.dtype
    dev = resolve_device(device or base_params.device)
    base = base_params.to(dev, dtype)
    base_y0 = torch.as_tensor(
        data.initial_sepaihrd_state(
            sigma=base_params.sigma, gamma_p=base_params.gamma_p,
            gamma_A=base_params.gamma_A, gamma_I=base_params.gamma_I,
            p=base_params.p, h=base_params.h), dtype=dtype, device=dev)
    total_pop = float(np.sum(np.asarray(data.population_by_age)))
    ts = np.asarray(ts, dtype=np.float64)
    t_idx = int(np.argmin(np.abs(ts - SERO_TARGET_DAY)))
    ts_t = torch.as_tensor(ts[:t_idx + 1], dtype=dtype, device=dev)

    def sero_of(thetas):
        theta = space.constrain(thetas.to(dtype), constraint_mode)
        params = space.apply(base, theta)
        y0, _ = sepaihrd.initial_state_for_params(params, base_y0)
        traj = sepaihrd.solve(params, y0, ts_t, method="fixed",
                              substeps=substeps, tableau=tableau)
        return (total_pop - torch.sum(traj[t_idx, ..., 0, :], dim=-1)) / total_pop

    def penalty(thetas):
        return -0.5 * ((sero_of(thetas) - mean) / se) ** 2

    def value_and_grad(thetas):
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            value = penalty(th)
            (grad,) = torch.autograd.grad(value.sum(), th)
        return value.detach(), grad

    penalty.sero_of = sero_of
    penalty.value_and_grad = value_and_grad
    return penalty


def add_sero_term(stream_value_and_grad, penalty):
    """``value_and_grad_batch`` of the joint density: a stream engine's
    (e.g. K2 + K3's) value and gradient plus the sero term's from
    ``penalty.value_and_grad``; the two add, as the JAX package composes
    the Pallas stream with XLA autodiff of the sero term."""

    def value_and_grad(thetas):
        v1, g1 = stream_value_and_grad(thetas)
        v2, g2 = penalty.value_and_grad(thetas)
        return v1 + v2, g1 + g2

    return value_and_grad
