"""EssentialMetrics: per-run epidemiological summary over a batch of runs.

Port of ``mmidv1_tpu/analysis/metrics.py`` (:37-117), re-design of
``MetricsCalculator::calculateEssentialMetrics`` (reference:
``src/model/MetricsCalculator.cpp:8-172``). The JAX function reads one
``(T, 11, A)`` trajectory under ``jax.vmap``; this one reads a ``(T, ..., 11,
A)`` trajectory whose middle dimensions are the draws (the layout
:func:`mmidv1_tpu_torch.models.sepaihrd.solve` returns), with parameters
batched to match, and returns every field with those leading dimensions.

Fidelity notes:
- The reference accumulates new infections with ``params.beta`` — the SCALAR
  beta field, 0.0 for a configuration that defines beta only as a schedule,
  zeroing all attack rates (``MetricsCalculator.cpp:111``). The documented
  model equation uses beta(t), so this defaults to the time-varying beta;
  ``use_scalar_beta=True`` reproduces the reference's literal behavior.
- dt for the first step is 1.0 (``:74``); the infectious load omits h_infec
  (``:104-110``), both mirrored exactly.
- IFR/IHR/IICUR are clamped to [0, 1] and zeroed below 1 cumulative
  infection (``:143-164``).
- Peaks take the FIRST maximum over time per draw, as ``jnp.argmax`` does
  (``torch.argmax`` documents the same), so a trajectory whose H or ICU
  total is tied (e.g. exactly 0 over its first days) picks the same day.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import constants as C
from ..params import SEPAIHRDParams, beta_at, kappa_at
from .reproduction import calculate_r0, rt_trajectory

SERO_TARGET_DAY = 64.0   # ENE-COVID round 1 reference day (May 4th)


def _over_time(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``(..., T)`` per-draw series as ``(T, ...)``, padded on the right to
    ``ndim`` dimensions."""
    x = x.movedim(-1, 0) if x.dim() else x
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def essential_metrics(params: SEPAIHRDParams, traj: torch.Tensor, ts,
                      initial_state: torch.Tensor, *,
                      use_scalar_beta: bool = False,
                      target_day: float = SERO_TARGET_DAY) -> Dict[str, torch.Tensor]:
    """All EssentialMetrics fields as a dict of tensors with the batch shape
    ``traj.shape[1:-2]`` (plus the age / schedule axis where there is one)."""
    ts = torch.as_tensor(ts, dtype=traj.dtype, device=traj.device)
    batch = traj.shape[1:-2]
    N = params.N
    total_pop = torch.sum(N, dim=-1)

    S_t = traj[..., C.S, :]                             # (T, ..., A)
    P_t, A_t, I_t = traj[..., C.P, :], traj[..., C.A, :], traj[..., C.I, :]
    H_t, ICU_t = traj[..., C.H, :], traj[..., C.ICU, :]

    # --- Rt statistics ----------------------------------------------------
    rt = rt_trajectory(params, traj, ts)                # (T, ...)
    max_rt, min_rt, final_rt = rt.amax(dim=0), rt.amin(dim=0), rt[-1]

    # --- peaks (first maximum, like the strict > comparison of :92-101) ----
    total_H, total_ICU = torch.sum(H_t, dim=-1), torch.sum(ICU_t, dim=-1)
    iH, iICU = torch.argmax(total_H, dim=0), torch.argmax(total_ICU, dim=0)
    peak_h = torch.gather(total_H, 0, iH.unsqueeze(0)).squeeze(0)
    peak_icu = torch.gather(total_ICU, 0, iICU.unsqueeze(0)).squeeze(0)
    t_peak_h, t_peak_icu = ts[iH], ts[iICU]

    # --- cumulative infections: init non-S + integral of lambda*S*dt -------
    # reference counts E0+P0+A0+I0+H0+ICU0+R0 (:41) — D excluded
    init_infections = torch.sum(initial_state[..., C.E:C.R + 1, :], dim=-2)
    load = (P_t + A_t + params.theta.unsqueeze(-1) * I_t) / \
        torch.clamp_min(N, 1e-9)
    load = torch.where(N > 1e-9, load, torch.zeros_like(load))
    beta_t = (params.beta if use_scalar_beta
              else beta_at(params, ts))                 # (...) or (..., T)
    kap = kappa_at(params, ts)
    if not use_scalar_beta:
        beta_t = _over_time(beta_t, traj.dim() - 2)
    factor = beta_t * _over_time(kap, traj.dim() - 2)   # (T, ...)
    # load @ M_baseline.T, written out so that it cannot run as TF32
    lam = factor.unsqueeze(-1) * torch.sum(
        params.M_baseline * load.unsqueeze(-2), dim=-1)   # (T, ..., A)
    dt = torch.cat([torch.ones(1, dtype=ts.dtype, device=ts.device),
                    torch.diff(ts)])
    dt = dt.reshape(dt.shape + (1,) * (S_t.dim() - 1))
    cum_infections = init_infections + torch.sum(lam * S_t * dt, dim=0)

    # --- seroprevalence at the grid point nearest target_day ---------------
    t_idx = torch.argmin(torch.abs(ts - target_day))
    sero_day64 = (total_pop - torch.sum(S_t[t_idx], dim=-1)) / total_pop

    # --- final-vs-initial cumulative flows ---------------------------------
    cum_deaths = traj[-1, ..., C.D, :] - initial_state[..., C.D, :]
    cum_hosp = traj[-1, ..., C.CUMH, :] - initial_state[..., C.CUMH, :]
    cum_icu = traj[-1, ..., C.CUMICU, :] - initial_state[..., C.CUMICU, :]

    total_infections = torch.sum(cum_infections, dim=-1)
    zero = torch.zeros((), dtype=traj.dtype, device=traj.device)
    overall_ifr = torch.where(total_infections > 1e-9,
                              torch.sum(cum_deaths, dim=-1) / total_infections,
                              zero)

    # --- age-specific ratios with the reference's guards -------------------
    enough = cum_infections > 1.0          # MIN_INFECTIONS_FOR_RATIO
    denom = torch.where(enough, cum_infections, torch.ones_like(cum_infections))

    def ratio(num):
        clipped = torch.minimum(torch.maximum(num / denom, zero), zero + 1.0)
        return torch.where(enough, clipped, zero)

    kv = params.kappa_values
    out = {
        "R0": calculate_r0(params).expand(batch),
        "max_Rt": max_rt, "min_Rt": min_rt, "final_Rt": final_rt,
        "peak_hospital": peak_h, "time_to_peak_hospital": t_peak_h,
        "peak_ICU": peak_icu, "time_to_peak_ICU": t_peak_icu,
        "total_deaths": torch.sum(cum_deaths, dim=-1),
        "overall_attack_rate": total_infections / total_pop,
        "overall_IFR": overall_ifr,
        "seroprevalence_day64": sero_day64,
        "IFR_age": ratio(cum_deaths),
        "IHR_age": ratio(cum_hosp),
        "IICUR_age": ratio(cum_icu),
        "AttackRate_age": torch.where(
            N > 0, cum_infections / torch.where(N > 0, N, torch.ones_like(N)),
            zero),
        "kappa_values": kv.expand(batch + kv.shape[-1:]),
    }
    return out


def seroprevalence_trajectory(params: SEPAIHRDParams,
                              traj: torch.Tensor) -> torch.Tensor:
    """(N_total - sum_S(t)) / N_total per output point, ``(T, ...)``
    (``MetricsCalculator::calculateSeroprevalenceTrajectory``, :200-226)."""
    total_pop = torch.sum(params.N, dim=-1)
    return (total_pop - torch.sum(traj[..., C.S, :], dim=-1)) / total_pop
