"""Classic SIR model family: deterministic, vital dynamics, stochastic, age-structured.

Port of ``mmidv1_tpu/models/sir.py``, re-design of the reference's GSL-based
scalar models (``src/base/SIRModel.cpp``, ``SIR_population_variable.cpp``,
``SIR_stochastic.cpp``) and of ``AgeSIRModel``
(``src/sir_age_structured/AgeSIRModel.cpp``). All models are functions of
tensors; parameters may carry leading batch dimensions and broadcast against
the state:

- :func:`sir_rhs` / :func:`sir_vital_rhs`: the scalar ODE right-hand sides
  on a state ``(..., 3)``
- :func:`equilibria`: DFE / R0 / endemic equilibrium of the vital-dynamics
  model (``SIR_population_variable.cpp:46-73``)
- :func:`run_stochastic_sir`: the Bailey-style binomial chain
  (``SIR_stochastic.cpp:144-208``), every simulation advancing in lockstep
- :func:`run_gillespie_sir`: an exact Gillespie SSA sampled onto a uniform
  grid, batched over simulations with an active mask each
- :func:`stochastic_statistics`: per-step mean/median/p5/p95 across
  simulations (``SIR_stochastic.cpp:211-255``), NumPy on the host
- :func:`age_sir_rhs`: the age-structured SIR on a state ``(..., 3, A)``
  with zero-clamped outflows from near-empty compartments
  (``AgeSIRModel.cpp:106-139``); interventions are parameter
  transformations (:func:`apply_age_sir_intervention`)

The random runs take their draws from outside: a ``binomial(count, prob)``
callable for the chain, an ``event_draws(e)`` callable for Gillespie. At run
time they come from a ``torch.Generator``; a test hands in the JAX package's
own draws and gets its trajectories back exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.exceptions import InterventionException


def _where0(cond, x: torch.Tensor) -> torch.Tensor:
    """``jnp.where(cond, x, 0.0)`` for a tensor or a Python ``cond`` (the
    latter decided on the host: no tensor is made for it)."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))
    return x if cond else torch.zeros_like(x)


# --------------------------------------------------------------------------
# Scalar SIR (reference src/base/SIRModel.cpp)
# --------------------------------------------------------------------------

class SIRParams(NamedTuple):
    """Parameters of the scalar models (mirrors ``ModelParameters``,
    ``include/base/ModelParameters.hpp``). A field is a Python float or a
    tensor whose shape is the state's batch shape."""

    N: float
    beta: float
    gamma: float
    B: float = 0.0    # birth rate (vital dynamics only)
    mu: float = 0.0   # natural death rate (vital dynamics only)


def sir_rhs(t, y: torch.Tensor, p: SIRParams) -> torch.Tensor:
    """Classic SIR: y = (..., [S, I, R])."""
    del t
    S, I = y[..., 0], y[..., 1]
    inc = _where0(p.N > 0, p.beta * S * I / p.N)
    return torch.stack([-inc, inc - p.gamma * I, p.gamma * I], dim=-1)


def sir_vital_rhs(t, y: torch.Tensor, p: SIRParams) -> torch.Tensor:
    """SIR with births B and per-capita mortality mu; N is the live sum
    (``SIR_population_variable.cpp:21-44``)."""
    del t
    S, I, R = y[..., 0], y[..., 1], y[..., 2]
    n = S + I + R
    inc = _where0(n > 0, p.beta * S * I / n)
    dS = p.B - inc - p.mu * S
    dI = inc - p.gamma * I - p.mu * I
    dR = p.gamma * I - p.mu * R
    return torch.stack([dS, dI, dR], dim=-1)


def equilibria(p: SIRParams):
    """DFE, R0 and endemic equilibrium of the vital-dynamics model
    (``SIR_population_variable.cpp:46-73``), from Python floats."""
    N_dfe = p.B / p.mu if p.mu > 0 else p.N
    r0 = p.beta / (p.gamma + p.mu) if (p.gamma + p.mu) > 0 else np.inf
    out = {"dfe": (N_dfe, 0.0, 0.0), "R0": r0, "endemic": None}
    if r0 > 1.0 and p.beta > 0:
        S_star = N_dfe / r0
        I_star = max(0.0, (p.B - p.mu * S_star) / (p.gamma + p.mu))
        R_star = max(0.0, N_dfe - S_star - I_star)
        out["endemic"] = (S_star, I_star, R_star)
    return out


# --------------------------------------------------------------------------
# Stochastic SIR: binomial chain + true Gillespie
# --------------------------------------------------------------------------

def _binomial_chain_step(S, I, R, p: SIRParams, h: float, pR: torch.Tensor,
                         binomial: Callable):
    """One step of every simulation; ``binomial(count, prob)`` is called for
    the new infections, then for the recoveries (probability ``pR``, the
    same at every step)."""
    # integer-rounded compartments for the draws (:157-168)
    S_int = torch.clamp_min(torch.round(S), 0.0)
    I_int = torch.clamp_min(torch.round(I), 0.0)
    pI = 1.0 - torch.exp(-_where0(p.N > 0, p.beta * I * h / p.N))
    pI = torch.clamp(pI, 0.0, 1.0)
    new_I = binomial(S_int, pI)
    new_R = binomial(I_int, pR)
    # Reference parity (SIR_stochastic.cpp:171-177): the step freezes when
    # EITHER compartment empties, the S == 0 case included (the reference's
    # own quirk; run_gillespie_sir keeps the recovery channel active)
    active = (I_int > 0) & (S_int > 0)
    S_next = torch.where(active, torch.clamp_min(S_int - new_I, 0.0), S)
    I_next = torch.where(active, torch.clamp_min(I_int + new_I - new_R, 0.0), I)
    R_next = torch.where(active, torch.clamp_min(R + new_R, 0.0), R)
    return S_next, I_next, R_next


def run_stochastic_sir(p: SIRParams, y0, t_start: float, t_end: float,
                       h: float, num_simulations: int, *,
                       generator: Optional[torch.Generator] = None,
                       binomial: Optional[Callable] = None,
                       dtype: torch.dtype = torch.float64,
                       device="cuda") -> torch.Tensor:
    """Binomial-chain SIR (Bailey 1975): ``(num_simulations, steps + 1, 3)``.

    ``steps = floor((t_end - t_start) / h)`` on the host, as the JAX
    function computes it. The draws come from ``binomial(count, prob)``
    (the same shapes back), by default ``torch.binomial`` on ``generator``.
    """
    dev = resolve_device(device)
    steps = int(np.floor((t_end - t_start) / h))
    if binomial is None:
        binomial = lambda c, q: torch.binomial(c, q, generator=generator)
    y0 = torch.as_tensor(np.asarray(y0, dtype=np.float64)).to(dev, dtype)
    out = torch.empty((num_simulations, steps + 1, 3), dtype=dtype, device=dev)
    out[:, 0] = y0
    S, I, R = (y0[c].expand(num_simulations) for c in range(3))
    pR = torch.as_tensor(-p.gamma * h, dtype=dtype, device=dev)
    pR = torch.clamp(1.0 - torch.exp(pR), 0.0, 1.0)
    pR = pR.expand(num_simulations).contiguous()
    for i in range(steps):
        S, I, R = _binomial_chain_step(S, I, R, p, h, pR, binomial)
        out[:, i + 1] = torch.stack([S, I, R], dim=-1)
    return out


def run_gillespie_sir(p: SIRParams, y0, t_start: float, t_end: float,
                      n_grid: int, num_simulations: int, *,
                      generator: Optional[torch.Generator] = None,
                      event_draws: Optional[Callable] = None,
                      max_events: int = 500_000,
                      dtype: torch.dtype = torch.float64,
                      device="cuda") -> torch.Tensor:
    """Exact Gillespie SSA for the SIR jump process, sampled on the grid
    ``linspace(t_start, t_end, n_grid)``: ``(num_simulations, n_grid, 3)``.

    Events: infection at rate beta*S*I/N, recovery at rate gamma*I. Every
    active simulation takes one event an iteration; a simulation stops when
    ``t >= t_end``, ``I == 0``, it has taken ``max_events`` or filled its
    grid. ``event_draws(e) -> (exponential, uniform)``, each
    ``(num_simulations,)``, gives the draws of every simulation's ``e``-th
    event (by default from ``generator``). Deciding whether any simulation
    is active is one host read an event.
    """
    dev = resolve_device(device)
    if event_draws is None:
        def event_draws(e):
            x = torch.empty(num_simulations, dtype=dtype, device=dev)
            return (x.exponential_(generator=generator),
                    torch.rand(num_simulations, generator=generator,
                               dtype=dtype, device=dev))
    grid = torch.as_tensor(np.linspace(t_start, t_end, n_grid)).to(dev, dtype)
    g_idx = torch.arange(n_grid, device=dev)
    y0 = torch.as_tensor(np.asarray(y0, dtype=np.float64)).to(dev, dtype)
    S, I, R = (y0[c].expand(num_simulations) for c in range(3))
    t = torch.full((num_simulations,), float(t_start), dtype=dtype, device=dev)
    gi = torch.zeros(num_simulations, dtype=torch.int64, device=dev)
    n = torch.zeros(num_simulations, dtype=torch.int64, device=dev)
    out = torch.zeros((num_simulations, n_grid, 3), dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    e = 0
    while True:
        active = (t < t_end) & (I > 0) & (n < max_events) & (gi < n_grid)
        if not bool(active.any()):
            break
        u_exp, u_unif = event_draws(e)
        rate_inf = _where0(p.N > 0, p.beta * S * I / p.N)
        rate_rec = p.gamma * I
        total = rate_inf + rate_rec
        dt = torch.where(total > 0, u_exp / torch.clamp_min(total, 1e-300), inf)
        t_new = t + dt
        # every grid point this jump passes gets the pre-jump state
        fill = active[:, None] & (g_idx >= gi[:, None]) & (grid < t_new[:, None])
        out = torch.where(fill[..., None], torch.stack([S, I, R], -1)[:, None],
                          out)
        infect = u_unif * total < rate_inf
        S_new = torch.where(infect, S - 1, S)
        I_new = torch.where(infect, I + 1, I - 1)
        R_new = torch.where(infect, R, R + 1)
        t = torch.where(active, t_new, t)
        S, I, R = (torch.where(active, a, b) for a, b in
                   ((S_new, S), (I_new, I), (R_new, R)))
        gi = gi + fill.sum(dim=1)
        n = n + active.to(n.dtype)
        e += 1
    # the grid points left get the final state
    rest = g_idx >= gi[:, None]
    return torch.where(rest[..., None], torch.stack([S, I, R], -1)[:, None], out)


def stochastic_statistics(trajectories):
    """Per-(step, compartment) mean/median/p5/p95 across simulations
    (``SIR_stochastic.cpp:211-255``), in float64 NumPy on the host.

    ``trajectories``: ``(num_sims, T, 3)``. Returns a dict of ``(T, 3)``
    arrays. A copy of the JAX package's function (NumPy only)."""
    if isinstance(trajectories, torch.Tensor):
        trajectories = trajectories.detach().cpu().numpy()
    traj = np.asarray(trajectories, dtype=np.float64)
    return {
        "mean": np.mean(traj, axis=0),
        "median": np.median(traj, axis=0),
        "p05": np.percentile(traj, 5.0, axis=0),
        "p95": np.percentile(traj, 95.0, axis=0),
    }


# --------------------------------------------------------------------------
# Age-structured SIR (reference src/sir_age_structured/AgeSIRModel.cpp)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AgeSIRParams:
    """Parameters of the age-structured SIR (state ``(..., 3, A)``: S, I, R
    rows). ``q`` and ``scale_C`` are ``(...)``, ``gamma`` ``(..., A)``: a
    batch of parameters broadcasts against a batch of states."""

    N: torch.Tensor            # (A,)
    C_baseline: torch.Tensor   # (A, A) contact matrix
    q: torch.Tensor            # (...) transmissibility
    gamma: torch.Tensor        # (..., A) recovery rates
    scale_C: torch.Tensor      # (...) overall contact scale

    @property
    def n_ages(self) -> int:
        return int(self.N.shape[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.N.dtype

    @property
    def device(self) -> torch.device:
        return self.N.device

    def replace(self, **changes) -> "AgeSIRParams":
        return dataclasses.replace(self, **changes)

    def contact_matrix(self) -> torch.Tensor:
        """The scaled contact matrix, ``(..., A, A)``."""
        return self.C_baseline * self.scale_C[..., None, None]


def make_age_sir_params(*, N, C, q, gamma, scale_C=1.0,
                        dtype: torch.dtype = torch.float64,
                        device="cuda") -> AgeSIRParams:
    """Validated construction (reference ``AgeSIRModel::create``, :10-38)."""
    N = np.asarray(N, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    gamma = np.asarray(gamma, dtype=np.float64)
    A = N.size
    if C.shape != (A, A):
        raise ValueError(f"contact matrix shape {C.shape} != ({A},{A})")
    if gamma.size != A:
        raise ValueError("gamma size mismatch")
    if q < 0 or scale_C < 0 or np.any(gamma < 0) or np.any(N < 0):
        raise ValueError("q, scale_C, gamma, N must be non-negative")
    dev = resolve_device(device)
    f = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64)).to(dev, dtype)
    return AgeSIRParams(N=f(N), C_baseline=f(C), q=f(q), gamma=f(gamma),
                        scale_C=f(scale_C))


def _force_of_infection(p: AgeSIRParams, I: torch.Tensor) -> torch.Tensor:
    """lambda = max(q * C_current (I/N), 0) per age, ``(..., A)``: a
    broadcast-multiply and sum, never a matmul (a float32 matmul may run in
    TF32 on the card, ~1e-3 relative noise in the force of infection)."""
    I_over_N = torch.where(p.N > 1e-9, I / p.N, torch.zeros_like(I))
    return torch.clamp_min(
        p.q[..., None] * torch.sum(p.contact_matrix() * I_over_N[..., None, :],
                                   dim=-1), 0.0)


def age_sir_rhs(t, y: torch.Tensor, p: AgeSIRParams) -> torch.Tensor:
    """lambda = q * C_current (I/N); zero-clamp outflows from ~empty
    compartments (``AgeSIRModel.cpp:106-139``)."""
    del t
    S, I, R = y[..., 0, :], y[..., 1, :], y[..., 2, :]
    lam = _force_of_infection(p, I)
    dS = -lam * S
    dI = lam * S - p.gamma * I
    dR = p.gamma * I
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    dS = torch.where((S < 1e-9) & (dS < 0), zero, dS)
    dI = torch.where((I < 1e-9) & (dI < 0), zero, dI)
    dR = torch.where((R < 1e-9) & (dR < 0), zero, dR)
    return torch.stack(torch.broadcast_tensors(dS, dI, dR), dim=-2)


AGE_SIR_INTERVENTIONS = ("contact_reduction", "social_distancing", "lockdown",
                         "mask_mandate", "transmission_reduction")


def apply_age_sir_intervention(p: AgeSIRParams, name: str, value: float
                               ) -> AgeSIRParams:
    """Interventions as parameter transformations
    (``AgeSIRModel::applyIntervention``, :141-173): contact-scale
    interventions multiply scale_C; transmission interventions reduce q by
    the given fraction. Unknown names raise (the reference's taxonomy)."""
    if name in ("contact_reduction", "social_distancing", "lockdown"):
        if value < 0:
            raise InterventionException("apply_age_sir_intervention",
                                        f"Contact scaling factor for '{name}' "
                                        "cannot be negative.")
        return p.replace(scale_C=p.scale_C * value)
    if name in ("mask_mandate", "transmission_reduction"):
        if not (0.0 <= value <= 1.0):
            raise InterventionException("apply_age_sir_intervention",
                                        f"Transmission reduction for '{name}' "
                                        "must be in [0, 1].")
        return p.replace(q=p.q * (1.0 - value))
    raise InterventionException("apply_age_sir_intervention",
                                f"Unknown intervention type: '{name}'.")


def solve_age_sir(p: AgeSIRParams, y0: torch.Tensor, ts, *, method="fixed",
                  substeps=4, tableau="dopri5", atol=1e-6, rtol=1e-6,
                  stats=None) -> torch.Tensor:
    """Integrate the age-SIR system over ``ts``: ``(len(ts), *y0.shape)``
    (the integrators of SEPAIHRD; ``stats`` as in
    :func:`mmidv1_tpu_torch.ode.integrate_times`)."""
    from ..ode import integrate_times, integrate_times_fixed

    f = lambda t, y: age_sir_rhs(t, y, p)
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    if method == "fixed":
        return integrate_times_fixed(f, y0, ts, substeps=substeps,
                                     method=tableau)
    return integrate_times(f, y0, ts, atol=atol, rtol=rtol, method=tableau,
                           stats=stats)


def sir_incidence(p: AgeSIRParams, traj: torch.Tensor) -> torch.Tensor:
    """Incidence lambda*S per output point, ``(T, ..., A)`` from a
    trajectory ``(T, ..., 3, A)``
    (``SimulationResultProcessor::getIncidenceData``, :144-189)."""
    return _force_of_infection(p, traj[..., 1, :]) * traj[..., 0, :]
