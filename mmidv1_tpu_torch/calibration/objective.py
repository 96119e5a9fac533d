"""SEPAIHRD Poisson log-likelihood objective, batched over theta.

Port of ``mmidv1_tpu/calibration/objective.py`` (:52-160), the hot path of the
reference's ``SEPAIHRDObjectiveFunction::calculate``
(``src/model/objectives/SEPAIHRDObjectiveFunction.cpp:62-279``):

    theta -> constrain -> params -> initial state (run-up seeding / multipliers,
    feasibility) -> ODE solve -> daily incidence of D/CumH/CumICU
    (row 0 anchored to the initial state, clamped >= 0) -> 3-stream Poisson LL
    over post-run-up rows -> lowest() on any failure.

Daily incidence comes from RESETTING the pure-accumulator rows (D/CumH/CumICU,
which the RHS never reads) to zero at the start of every daily interval, so a
day's incidence is the row value at day end: in float32 each day's term then
carries roundoff relative to the day increment, not the running cumulative.

This eager version runs one torch op per stage and compartment group; the
calibration path uses the fused CUDA kernel behind
:func:`mmidv1_tpu_torch.ops.build_objective_fused` instead, whose plain
version lives beside it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import constants as C
from ..data.calibration_data import CalibrationData
from ..models import sepaihrd
from ..ode import fold_times_fixed
from ..params import SEPAIHRDParams
from ..utils.device import resolve_device
from .param_space import CLAMP, ParameterSpace

# Observed stream order (hosp, icu, deaths) -> model rows (CumH, CumICU, D).
_MODEL_ROWS_FOR_OBS = [C.CUMH, C.CUMICU, C.D]


def lowest(dtype: torch.dtype) -> float:
    """The analogue of std::numeric_limits<double>::lowest()."""
    return torch.finfo(dtype).min


def make_time_grid(runup_days: float, num_days: int) -> np.ndarray:
    """Fixed observation grid t = -int(runup_days) .. num_days-1
    (reference ``main.cpp:241-256``; note the int cast of runup_days, and that
    the grid stays fixed even when runup_days is calibrated)."""
    return np.arange(-int(runup_days), num_days, dtype=np.float64)


def check_grid(ts, data: CalibrationData):
    """``(ts as float64 numpy, runup_offset, num_obs)`` after checking that the
    grid's post-run-up points match the data."""
    ts = np.asarray(ts, dtype=np.float64)
    runup_offset = int(np.searchsorted(ts, 0.0, side="left"))
    num_obs = len(ts) - runup_offset
    if num_obs != data.n_data_points:
        raise ValueError(
            f"time grid has {num_obs} observation points but data has "
            f"{data.n_data_points} (reference returns lowest() here; we fail fast)")
    return ts, runup_offset, num_obs


def base_state(base_params: SEPAIHRDParams, data: CalibrationData,
               base_initial_state=None) -> np.ndarray:
    """The data-inferred day-0 state of the multiplier branch (reference
    caches it once per calibration, ``SEPAIHRDModelCalibration.cpp:73-132``)."""
    if base_initial_state is None:
        base_initial_state = data.initial_sepaihrd_state(
            sigma=base_params.sigma, gamma_p=base_params.gamma_p,
            gamma_A=base_params.gamma_A, gamma_I=base_params.gamma_I,
            p=base_params.p, h=base_params.h)
    return np.asarray(base_initial_state, dtype=np.float64)


def build_objective(
    space: ParameterSpace,
    base_params: SEPAIHRDParams,
    data: CalibrationData,
    ts: np.ndarray,
    *,
    base_initial_state=None,
    substeps: int = 4,
    tableau: str = "dopri5",
    constraint_mode: str = CLAMP,
    dtype: Optional[torch.dtype] = None,
    device=None,
    compensated: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``loglik_batch(thetas (B, d)) -> (B,)``.

    ``dtype``/``device`` default to the base parameters'."""
    dtype = dtype or base_params.dtype
    dev = resolve_device(device or base_params.device)
    ts, runup_offset, num_obs = check_grid(ts, data)
    base_y0 = torch.as_tensor(base_state(base_params, data, base_initial_state),
                              dtype=dtype, device=dev)
    base_params = base_params.to(dev, dtype)

    # Observed streams with validity masks (NaN/negative observations are
    # skipped: SEPAIHRDObjectiveFunction.cpp:268), as (T_obs, 3, A).
    obs = np.stack([np.asarray(data.new_hospitalizations),
                    np.asarray(data.new_icu),
                    np.asarray(data.new_deaths)], axis=1)
    valid_np = np.isfinite(obs) & (obs >= 0)
    obs_t = torch.as_tensor(np.where(valid_np, obs, 0.0), dtype=dtype, device=dev)
    valid_t = torch.as_tensor(valid_np, device=dev)
    ts_t = torch.as_tensor(ts, dtype=dtype, device=dev)
    eps = C.POISSON_EPSILON
    zero = torch.zeros((), dtype=dtype, device=dev)

    def loglik_batch(thetas: torch.Tensor) -> torch.Tensor:
        theta = space.constrain(thetas.to(dtype), constraint_mode)
        params = space.apply(base_params, theta)
        y0, infeasible = sepaihrd.initial_state_for_params(params, base_y0)
        B = theta.shape[0]
        y0 = y0.expand((B,) + y0.shape[-2:])
        ctx = sepaihrd.interval_beta_eff(params, ts_t)
        ctx = ctx.expand((B, len(ts) - 1)).movedim(-1, 0)       # (T-1, B)
        f = lambda t, y, beta_eff: sepaihrd.rhs_frozen(t, y, params, beta_eff)

        def reset_accumulators(y):
            y = y.clone()
            y[..., _MODEL_ROWS_FOR_OBS, :] = 0.0
            return y

        def fold(acc, i, y):
            ll, comp = acc
            cur = y[..., _MODEL_ROWS_FOR_OBS, :]           # (B, 3, A)
            # i == 0 is y0 itself: row 0 incidence is 0 by anchoring
            # (reference :192-208 anchors row 0 to the initial state).
            inc = (torch.zeros_like(cur) if i == 0
                   else torch.clamp_min(cur, 0.0)) + eps
            j = i - runup_offset
            if not 0 <= j < num_obs:
                # out of the observation window: the masked Kahan update
                # of a zero term
                term = zero
            else:
                term = torch.sum(torch.where(valid_t[j], obs_t[j] * torch.log(inc)
                                             - inc, zero), dim=(-2, -1))
            # Kahan-compensated accumulation: the plain running sum of ~300
            # O(1e4) terms carries O(1) float32 noise
            contrib = term - comp
            ll_new = ll + contrib
            comp = (ll_new - ll) - contrib
            return ll_new, comp

        init = (torch.zeros(B, dtype=dtype, device=dev),
                torch.zeros(B, dtype=dtype, device=dev))
        (ll, _comp), _yf = fold_times_fixed(f, y0, ts_t, fold, init,
                                            substeps=substeps, method=tableau,
                                            interval_ctx=ctx,
                                            compensated=compensated,
                                            pre_interval=reset_accumulators)
        bad = infeasible.expand(B) | torch.isnan(ll) | torch.isinf(ll)
        return torch.where(bad, torch.full_like(ll, lowest(dtype)), ll)

    return loglik_batch

