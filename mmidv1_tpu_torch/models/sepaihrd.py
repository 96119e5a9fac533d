"""Age-structured SEPAIHRD model: RHS + initial-state construction.

Port of ``mmidv1_tpu/models/sepaihrd.py`` (:45-311). The state is a
``(..., 11, n_ages)`` tensor (compartment-major, leading batch dimensions
written out); parameters may be batched the same way (see
:mod:`mmidv1_tpu_torch.params`). Equations (reference ``Readme.md:134-177``)::

    pi_j    = (P_j + A_j + theta * I_j) * h_infec_j / N_j
    lambda_i = beta(t) * kappa(t) * a_i * sum_j M_ij pi_j     (clamped >= 0)
    dS  = -lambda * S
    dE  = lambda * S - sigma * E
    dP  = sigma * E - gamma_p * P
    dA  = p * gamma_p * P - gamma_A * A
    dI  = (1-p) * gamma_p * P - (gamma_I + h + d_community) * I
    dH  = h * I - (gamma_H + d_H + icu) * H
    dICU= icu * H - (gamma_ICU + d_ICU) * ICU
    dR  = gamma_A * A + gamma_I * I + gamma_H * H + gamma_ICU * ICU
    dD  = d_H * H + d_ICU * ICU + d_community * I
    dCumH = h * I ;  dCumICU = icu * H
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..params import SEPAIHRDParams, beta_at, kappa_at


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-chain scalar ``(...)`` as ``(..., 1)`` against the age axis."""
    return x.unsqueeze(-1)


def _contact_matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(..., A, A) @ (..., A)`` as an exact broadcast-multiply + sum.

    Never a matmul: a float32 matmul may run in TF32 on the card, which keeps
    ~3 decimal digits and would inject ~1e-3 relative noise into the force of
    infection (tens of log-likelihood units over a year)."""
    return torch.sum(M * v.unsqueeze(-2), dim=-1)


def max0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with ``jnp.maximum``'s gradient: at a tie (x == 0) half
    the cotangent goes to x. ``torch.clamp_min`` would pass all of it; the
    forward values are the same, NaN included."""
    return torch.maximum(x, x.new_zeros(()))


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` (``minimum(maximum(x, 0), 1)``), ties split."""
    return torch.minimum(max0(x), x.new_ones(()))


def inv_population(params: SEPAIHRDParams) -> torch.Tensor:
    """Safe 1/N per age group (reference ``AgeSEPAIHRDModel.cpp:46-49``)."""
    N = params.N
    return torch.where(N > C.MIN_POPULATION_FOR_DIVISION, 1.0 / N,
                       torch.zeros_like(N))


def force_of_infection(params: SEPAIHRDParams, y: torch.Tensor,
                       t) -> torch.Tensor:
    """lambda_i(t) >= 0, shape ``(..., n_ages)`` (reference
    ``AgeSEPAIHRDModel::computeDerivatives`` lines 152-196): the ``lam`` of
    :class:`FrozenRHS` with the schedule factor evaluated at ``t``."""
    t = torch.as_tensor(t, dtype=params.dtype, device=params.device)
    P_, A_, I_ = y[..., C.P, :], y[..., C.A, :], y[..., C.I, :]
    inf_pressure = (P_ + A_ + _col(params.theta) * I_) * params.h_infec \
        * inv_population(params)
    lam = _contact_matvec(params.contact_matrix(), inf_pressure)
    beta_eff = beta_at(params, t) * kappa_at(params, t)
    return max0(_col(beta_eff) * params.a * lam)


def rhs(t, y: torch.Tensor, params: SEPAIHRDParams) -> torch.Tensor:
    """Time derivative with the schedule factor evaluated at ``t`` (a
    scalar tensor). Exactly :func:`rhs_frozen` with beta(t)*kappa(t)."""
    t = torch.as_tensor(t, dtype=params.dtype, device=params.device)
    return rhs_frozen(t, y, params, beta_at(params, t) * kappa_at(params, t))


def rhs_frozen(t, y: torch.Tensor, params: SEPAIHRDParams,
               beta_eff: torch.Tensor) -> torch.Tensor:
    """RHS with the time-varying factor beta(t)*kappa(t) frozen to
    ``beta_eff`` (shape ``(...)``, one per chain). ``t`` is unused."""
    del t
    f = FrozenRHS(params)
    return f(y, f.beta_a(beta_eff))


class FrozenRHS:
    """:func:`rhs_frozen` for one set of parameters, with what depends on
    the parameters alone (1/N, the contact matrix, the rates as columns
    against the age axis) computed once instead of at every stage, and
    beta_eff * a once per interval (:meth:`beta_a`): an eager solve is bound
    by the host's cost of each call. The flows and the order of the sums are
    those of the equations above, term by term, so the results are the same
    to the bit as computing everything at every call."""

    def __init__(self, params: SEPAIHRDParams):
        pr = params
        self.a, self.p = pr.a, pr.p
        self.M = pr.contact_matrix()
        self.theta = _col(pr.theta)
        self.h_infec, self.inv_n = pr.h_infec, inv_population(pr)
        self.sigma, self.gamma_p = _col(pr.sigma), _col(pr.gamma_p)
        self.gamma_A, self.gamma_I = _col(pr.gamma_A), _col(pr.gamma_I)
        self.gamma_H, self.gamma_ICU = _col(pr.gamma_H), _col(pr.gamma_ICU)
        self.h, self.d_community = pr.h, pr.d_community
        self.icu, self.d_H, self.d_ICU = pr.icu, pr.d_H, pr.d_ICU
        self.icu_out = self.gamma_ICU + pr.d_ICU

    def beta_a(self, beta_eff: torch.Tensor) -> torch.Tensor:
        """``beta_eff (...)`` times the age susceptibility, ``(..., A)``."""
        return _col(beta_eff) * self.a

    def __call__(self, y: torch.Tensor, beta_a: torch.Tensor) -> torch.Tensor:
        S_, E_, P_, A_, I_, H_, ICU_ = y.unbind(-2)[:C.ICU + 1]
        inf_pressure = (P_ + A_ + self.theta * I_) * self.h_infec * self.inv_n
        lam = max0(beta_a * _contact_matvec(self.M, inf_pressure))

        flow_SE = lam * S_
        flow_EP = self.sigma * E_
        flow_P_out = self.gamma_p * P_
        flow_PA = self.p * flow_P_out
        flow_PI = flow_P_out - flow_PA

        flow_IH = self.h * I_
        flow_IR = self.gamma_I * I_
        flow_ID_comm = self.d_community * I_

        flow_H_ICU = self.icu * H_
        flow_AR = self.gamma_A * A_
        flow_HR = self.gamma_H * H_
        flow_HD = self.d_H * H_

        dS = -flow_SE
        dE = flow_SE - flow_EP
        dP = flow_EP - flow_P_out
        dA = flow_PA - flow_AR
        dI = flow_PI - (flow_IR + flow_IH + flow_ID_comm)
        dH = flow_IH - (flow_HR + flow_HD + flow_H_ICU)
        dICU = flow_H_ICU - self.icu_out * ICU_
        dR = flow_AR + flow_IR + flow_HR + self.gamma_ICU * ICU_
        dD = flow_HD + self.d_ICU * ICU_ + flow_ID_comm
        dCumH = flow_IH
        dCumICU = flow_H_ICU

        out = [dS, dE, dP, dA, dI, dH, dICU, dR, dD, dCumH, dCumICU]
        shape = torch.broadcast_shapes(*(o.shape for o in out))
        return torch.stack([o.expand(shape) for o in out], dim=-2)


def interval_beta_eff(params: SEPAIHRDParams, ts: torch.Tensor) -> torch.Tensor:
    """Per-output-interval beta(t)*kappa(t) at interval midpoints,
    ``(..., len(ts) - 1)``."""
    mids = 0.5 * (ts[:-1] + ts[1:])
    return beta_at(params, mids) * kappa_at(params, mids)


def solve(params: SEPAIHRDParams, y0: torch.Tensor, ts, *, method="fixed",
          tableau="dopri5", substeps=4, atol=1e-6, rtol=1e-6, dt0=1.0,
          freeze_schedules=True, stats=None) -> torch.Tensor:
    """Integrate over the output grid ``ts``; returns ``(len(ts), ..., 11, A)``.

    ``method``: "fixed" (``substeps`` equal RK steps per interval; the
    throughput and differentiable path) or "adaptive" (odeint
    ``integrate_times`` semantics at ``atol`` / ``rtol`` from ``dt0``, one
    controller for the whole of ``y0``, reference ``Simulator.cpp:60-150``;
    ``stats`` as in :func:`mmidv1_tpu_torch.ode.integrate_times`).

    ``freeze_schedules`` evaluates beta(t)*kappa(t) once per output interval
    (at the midpoint), exact when schedule breakpoints align with ``ts``.
    """
    from ..ode import integrate_times, integrate_times_fixed

    if method not in ("fixed", "adaptive"):
        raise ValueError(f"unknown method {method!r}")
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    if freeze_schedules:
        frozen = FrozenRHS(params)
        ctx = frozen.beta_a(interval_beta_eff(params, ts).movedim(-1, 0))
        f = lambda t, y, beta_a: frozen(y, beta_a)
    else:
        ctx = None
        f = lambda t, y: rhs(t, y, params)
    if method == "adaptive":
        return integrate_times(f, y0, ts, atol=atol, rtol=rtol, dt0=dt0,
                               method=tableau, interval_ctx=ctx, stats=stats)
    return integrate_times_fixed(f, y0, ts, substeps=substeps, method=tableau,
                                 interval_ctx=ctx)


def state_names(n_ages: int) -> list:
    """Flat state names matching ``AgeSEPAIHRDModel::getStateNames``
    (reference ``src/model/AgeSEPAIHRDModel.cpp:251-259``): S0..S3, E0..E3,
    ..., CumICU0..CumICU3."""
    from .results import state_names as _flat_names
    return _flat_names(C.COMPARTMENTS, n_ages)


def infer_initial_state(
    *,
    N: torch.Tensor,
    cumulative_confirmed_day0: torch.Tensor,
    cumulative_deaths_day0: torch.Tensor,
    cumulative_hosp_day0: torch.Tensor,
    cumulative_icu_day0: torch.Tensor,
    sigma,
    gamma_p,
    gamma_A,
    gamma_I,
    p: torch.Tensor,
    h: torch.Tensor,
) -> torch.Tensor:
    """Quasi-steady-state back-inference of the day-0 SEPAIHRD state from data.

    Port of ``CalibrationData::getInitialSEPAIHRDState`` (reference:
    ``src/utils/GetCalibrationData.cpp:107-234``), vectorized over ages. ``h``
    is accepted for signature parity (the reference does not use it).
    """
    del h
    z = torch.zeros_like(N)
    one = torch.ones_like(N)
    zero = torch.zeros((), dtype=N.dtype, device=N.device)

    D0 = max0(cumulative_deaths_day0)
    H0 = max0(cumulative_hosp_day0)
    ICU0 = max0(cumulative_icu_day0)
    CumH0 = H0
    CumICU0 = ICU0

    I0 = max0(cumulative_confirmed_day0 - D0)

    p_c = clip01(p)
    one_minus_p = 1.0 - p_c

    P0 = torch.where((gamma_p > 1e-9) & (one_minus_p > 1e-9),
                     I0 * gamma_I / torch.where(one_minus_p > 1e-9,
                                                one_minus_p * gamma_p, one),
                     I0)
    A0 = torch.where(gamma_A > 1e-9,
                     P0 * p_c * gamma_p / torch.where(gamma_A > 1e-9, gamma_A, one),
                     P0 * p_c)
    E0 = torch.where(sigma > 1e-9,
                     P0 * gamma_p / torch.where(sigma > 1e-9, sigma, one), P0)

    E0 = max0(E0)
    P0 = max0(P0)
    A0 = max0(A0)
    R0 = z

    # Sequential population-budget clamping (GetCalibrationData.cpp:168-174)
    D0 = torch.minimum(D0, N)
    ICU0 = torch.minimum(ICU0, max0(N - D0))
    H0 = torch.minimum(H0, max0(N - D0 - ICU0))
    I0 = torch.minimum(I0, max0(N - D0 - ICU0 - H0))
    R0 = torch.minimum(R0, max0(N - D0 - ICU0 - H0 - I0))

    # Joint rescale of inferred (E,P,A) into the remaining budget (:182-196)
    sum_set = I0 + H0 + ICU0 + R0 + D0
    sum_inferred = E0 + P0 + A0
    available = max0(N - sum_set)
    scale = torch.where(
        sum_inferred > available,
        torch.where(sum_inferred > 1e-9,
                    available / torch.where(sum_inferred > 1e-9, sum_inferred, one),
                    zero),
        one)
    E0, P0, A0 = E0 * scale, P0 * scale, A0 * scale

    S0 = max0(N - (E0 + P0 + A0 + I0 + H0 + ICU0 + R0 + D0))

    return torch.stack([S0, E0, P0, A0, I0, H0, ICU0, R0, D0, CumH0, CumICU0])


def age_fraction(N: torch.Tensor) -> torch.Tensor:
    """Each age group's share of the population ``N (..., A)`` (0 for an
    empty population): how run-up seeding spreads ``seed_exposed``."""
    total = torch.sum(N, dim=-1, keepdim=True)
    return torch.where(total > 0, N / total, torch.zeros_like(N))


def runup_seeded_state(params: SEPAIHRDParams, base_state=None) -> torch.Tensor:
    """Run-up seeding: E = seed_exposed * age_fraction at t = -runup_days, all
    other non-S compartments zero, S = N - E (reference ``main.cpp:274-316``).
    Returns ``(..., 11, A)`` with the batch shape of ``seed_exposed``."""
    del base_state
    N = params.N
    E0 = _col(params.seed_exposed) * age_fraction(N)
    y = torch.zeros(E0.shape[:-1] + (C.NUM_COMPARTMENTS, N.shape[-1]),
                    dtype=N.dtype, device=N.device)
    y[..., C.E, :] = E0
    y[..., C.S, :] = N - E0
    return y


def multiplier_scaled_state(params: SEPAIHRDParams, base_state: torch.Tensor):
    """Apply E0..D0 multipliers to a data-inferred ``(11, A)`` state; returns
    the scaled state with S recomputed as N - sum(E..D) and an infeasibility
    flag (reference ``SEPAIHRDObjectiveFunction.cpp:144-163``)."""
    mults = torch.stack(torch.broadcast_tensors(
        params.E0_multiplier, params.P0_multiplier, params.A0_multiplier,
        params.I0_multiplier, params.H0_multiplier, params.ICU0_multiplier,
        params.R0_multiplier, params.D0_multiplier), dim=-1)   # (..., 8)
    base = torch.as_tensor(base_state, dtype=params.dtype, device=params.device)
    base = base.expand(mults.shape[:-1] + base.shape)
    # out of place, so that autograd can differentiate through the multipliers
    scaled = base[..., C.E:C.D + 1, :] * mults.unsqueeze(-1)
    sum_non_S = torch.sum(scaled, dim=-2)
    infeasible = torch.any(sum_non_S > params.N, dim=-1)
    S0 = (params.N - sum_non_S).unsqueeze(-2)
    y = torch.cat([S0, scaled, base[..., C.D + 1:, :]], dim=-2)
    return y, infeasible


def initial_state_for_params(params: SEPAIHRDParams, base_state: torch.Tensor):
    """Initial state used by the objective (reference
    ``SEPAIHRDObjectiveFunction::calculate`` :124-163): run-up seeding if
    ``runup_days > 0 and seed_exposed > 0``, else the multipliers; returns
    ``(state (..., 11, A), infeasible (...))``."""
    seeded = runup_seeded_state(params, base_state)
    scaled, infeasible_m = multiplier_scaled_state(params, base_state)
    use_seed = (params.runup_days > 0) & (params.seed_exposed > 0)
    seeded, scaled = torch.broadcast_tensors(seeded, scaled)
    y = torch.where(use_seed[..., None, None], seeded, scaled)
    seed_infeasible = torch.any(
        torch.sum(seeded[..., C.E:C.D + 1, :], dim=-2) > params.N, dim=-1)
    infeasible = torch.where(use_seed, seed_infeasible, infeasible_m)
    return y, infeasible
