"""Parallel adaptive hill climbing with cloud search, as batched device code.

Port of ``mmidv1_tpu/calibration/hill.py`` (:79-210), re-design of
``HillClimbingOptimizer`` (reference:
``src/sir_age_structured/optimizers/HillClimbingOptimizer.cpp``):

- per-iteration candidate cloud: half correlated moves ``L z`` via the Cholesky
  factor of an adapted covariance, half single-axis moves (:192-221),
  evaluated with one batched objective call
- early-accept of the cloud winner + robust two-phase line search along the
  CONSTRAINED winning direction (:38-109): a backtracking ladder (step
  halvings) then an expansion ladder (step doublings with moving anchor), each
  one batched objective call
- CMA-ES-style rank-1 covariance adaptation with alpha = 2/(n+2), forced
  symmetry, trace-proportional jitter, and a diagonal floor at 1% of the
  proposal variances (:276-301)
- Cholesky refresh every 10 iterations with diagonal fallback (:308-336)
- learned covariance returned for the Phase-2 MCMC warm start (:347)

Documented deviations (as in the JAX package): both line-search ladders are
evaluated as batches (10 backtrack positions, 12 expansion positions) instead
of sequential early-exit loops; the backtrack pick is exactly the sequential
result, the expansion takes the longest prefix of successive improvements.
Cloud size is an explicit setting.

Random draws: :func:`hill_step` takes its draws as tensors — ``z (h, d)``
standard normals for the correlated half of the cloud, ``axis (c - h,)``
integer axes and ``axis_z (c - h,)`` standard normals for the single-axis
half; :func:`run_hill_climb` draws them from a ``torch.Generator`` or takes
them from the caller. Every decision is a tensor select, so an iteration
never waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from .mh import safe_logp
from .param_space import ParameterSpace


@dataclasses.dataclass(frozen=True)
class HillClimbConfig:
    iterations: int = 200
    cloud_size: int = 40         # reference: max(4, threads * cloud_size_multiplier)
    max_backtrack: int = 10
    max_expansion: int = 12
    chol_refresh: int = 10

    @classmethod
    def from_settings(cls, s: dict, n_devices_hint: int = 8) -> "HillClimbConfig":
        g = s.get
        mult = max(1, int(g("cloud_size_multiplier", 8)))
        return cls(iterations=int(g("iterations", 2000)),
                   cloud_size=max(4, n_devices_hint * mult))


class HillClimbState(NamedTuple):
    x: torch.Tensor          # (d,) current position
    logl: torch.Tensor       # ()
    best_x: torch.Tensor
    best_logl: torch.Tensor
    cov: torch.Tensor        # (d, d)
    chol: torch.Tensor       # (d, d)
    prev_x: torch.Tensor     # anchor of the last accepted move
    evals: int


class HillClimbResult(NamedTuple):
    best_x: torch.Tensor
    best_logl: torch.Tensor
    final_cov: torch.Tensor
    history_best: torch.Tensor
    final_state: HillClimbState


def _line_search(x, logl, direction, space: ParameterSpace, fitness_batch,
                 cfg: HillClimbConfig):
    """Two-phase robust line search (:38-109), batched."""
    dtype, dev = x.dtype, x.device
    # Phase 1: backtracking ladder, steps 1, 1/2, ..., 1/2^(mb-1)
    steps = 0.5 ** torch.arange(cfg.max_backtrack, dtype=dtype, device=dev)
    cands = space.clamp(x[None, :] + steps[:, None] * direction)
    scores = safe_logp(fitness_batch(cands))
    # degenerate candidates (no movement) score as no-improvement
    moved = torch.sum((cands - x) ** 2, dim=1) >= 1e-16
    improving = (scores > logl) & moved
    any_improve = torch.any(improving)
    # largest improving step (sequential semantics): the first True
    first = torch.argmax(improving.to(torch.int32))
    x1 = torch.where(any_improve, cands[first], x)
    l1 = torch.where(any_improve, scores[first], logl)

    # Phase 2: expansion ladder along the realized step s = x1 - x:
    # moving-anchor positions x1 + (2^(k+1) - 2) * s for k = 1..me
    s = x1 - x
    factors = (2.0 ** torch.arange(1, cfg.max_expansion + 1, dtype=dtype,
                                   device=dev)) * 2.0 - 2.0
    cands2 = space.clamp(x1[None, :] + factors[:, None] * s)
    scores2 = safe_logp(fitness_batch(cands2))
    # Sequential walk semantics: candidate k is taken iff every candidate up to
    # and including k improved on its predecessor (anchor chain unbroken).
    prev = torch.cat([l1[None], scores2[:-1]])
    prefix_ok = torch.cumprod((scores2 > prev).to(torch.int32), dim=0) == 1
    any2 = torch.any(prefix_ok) & any_improve
    ks = torch.arange(cfg.max_expansion, device=dev)
    last = torch.max(torch.where(prefix_ok, ks, torch.full_like(ks, -1)))
    last = torch.clamp_min(last, 0)
    x2 = torch.where(any2, cands2[last], x1)
    l2 = torch.where(any2, scores2[last], l1)
    return x2, l2, any_improve


def _refresh_cholesky(c: torch.Tensor) -> torch.Tensor:
    """Cholesky of the regularized covariance, or its diagonal square root
    where the factorization fails (:308-336). ``cholesky_ex`` reports the
    failure in ``info`` where ``jnp.linalg.cholesky`` returns NaNs."""
    d = c.shape[0]
    eye = torch.eye(d, dtype=c.dtype, device=c.device)
    lam = 1e-6 * torch.trace(c) / d
    L, info = torch.linalg.cholesky_ex(c + lam * eye)
    ok = (info == 0) & torch.all(torch.isfinite(L))
    L_diag = torch.diag(torch.sqrt(torch.clamp_min(torch.diagonal(c), 1e-12)))
    return torch.where(ok, L, L_diag)


def hill_step(state: HillClimbState, it: int, z: torch.Tensor,
              axis: torch.Tensor, axis_z: torch.Tensor,
              space: ParameterSpace, fitness_batch: Callable,
              cfg: HillClimbConfig, min_var: torch.Tensor) -> HillClimbState:
    """Iteration ``it`` (0-based) of the climber, given its draws."""
    d = state.x.shape[0]
    dtype, dev = state.x.dtype, state.x.device
    n_ax = axis.shape[0]

    # A. candidate cloud: correlated + axis-aligned (:192-221)
    corr_steps = z @ state.chol.T
    sigma_ax = torch.sqrt(torch.diagonal(state.cov))[axis]
    axis_steps = torch.zeros((n_ax, d), dtype=dtype, device=dev)
    axis_steps[torch.arange(n_ax, device=dev), axis] = sigma_ax * axis_z
    steps = torch.cat([corr_steps, axis_steps])

    # B. batched evaluation of the constrained cloud
    cands = space.clamp(state.x[None, :] + steps)
    scores = safe_logp(fitness_batch(cands))

    # C/D. winner + early accept + line search along constrained direction
    w = torch.argmax(scores)
    won = scores[w] > state.logl
    x_ea = torch.where(won, cands[w], state.x)
    l_ea = torch.where(won, scores[w], state.logl)
    direction = cands[w] - state.x
    x_new, l_new, ls_moved = _line_search(x_ea, l_ea, direction, space,
                                          fitness_batch, cfg)
    moved = won | ls_moved

    # E. rank-1 covariance adaptation on the realized move (:276-301)
    actual = x_new - state.prev_x
    step_norm = torch.sum(actual ** 2)
    alpha = 2.0 / (d + 2.0)
    cov_upd = (1 - alpha) * state.cov + alpha * torch.outer(actual, actual)
    cov_upd = 0.5 * (cov_upd + cov_upd.T)
    jitter = 1e-8 * torch.trace(cov_upd) / d
    cov_upd = cov_upd + jitter * torch.eye(d, dtype=dtype, device=dev)
    diag = torch.diagonal(cov_upd)
    cov_upd = cov_upd + torch.diag(torch.clamp_min(min_var - diag, 0.0))
    do_adapt = moved & (step_norm > 1e-14)
    cov = torch.where(do_adapt, cov_upd, state.cov)
    prev_x = torch.where(moved, x_new, state.prev_x)

    # F. Cholesky refresh every `chol_refresh` iterations (:308-336)
    chol = (_refresh_cholesky(cov) if it > 0 and it % cfg.chol_refresh == 0
            else state.chol)

    best_logl = torch.maximum(state.best_logl, l_new)
    best_x = torch.where(l_new > state.best_logl, x_new, state.best_x)
    return HillClimbState(
        x=x_new, logl=l_new, best_x=best_x, best_logl=best_logl,
        cov=cov, chol=chol, prev_x=prev_x,
        evals=state.evals + cfg.cloud_size + cfg.max_backtrack
        + cfg.max_expansion)


def run_hill_climb(
    loglik_batch: Callable[[torch.Tensor], torch.Tensor],
    space: ParameterSpace,
    theta0: torch.Tensor,
    cfg: HillClimbConfig,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[tuple]] = None,
) -> HillClimbResult:
    """Climb from ``theta0`` (d,) for ``cfg.iterations`` iterations on the
    batched objective ``loglik_batch`` ((B, d) -> (B,)). Each iteration's
    draws ``(z, axis, axis_z)`` (see :func:`hill_step`) come from
    ``draws[it]`` when given, else from ``generator`` (on the device of
    ``theta0``)."""
    d = space.dim
    dtype, dev = theta0.dtype, theta0.device
    if draws is None and generator is None:
        raise ValueError("run_hill_climb needs a generator or the draws")
    if draws is not None and len(draws) != cfg.iterations:
        raise ValueError(f"{len(draws)} sets of draws for {cfg.iterations} "
                         "iterations")

    sig = space.sigmas.to(dtype)
    var = torch.where(sig > 0, sig * sig, torch.full_like(sig, 1e-4))
    cov0 = torch.diag(var)
    min_var = torch.where(sig > 0, sig * sig * 0.01, torch.full_like(sig, 1e-8))

    logl0 = safe_logp(loglik_batch(theta0[None, :]))[0]
    state = HillClimbState(
        x=theta0, logl=logl0, best_x=theta0, best_logl=logl0,
        cov=cov0, chol=torch.sqrt(cov0), prev_x=theta0, evals=1)

    half = cfg.cloud_size // 2
    n_ax = cfg.cloud_size - half
    history = []
    for it in range(cfg.iterations):
        if draws is not None:
            z, axis, axis_z = draws[it]
        else:
            z = torch.randn((half, d), generator=generator, dtype=dtype,
                            device=dev)
            axis = torch.randint(0, d, (n_ax,), generator=generator,
                                 device=dev)
            axis_z = torch.randn((n_ax,), generator=generator, dtype=dtype,
                                 device=dev)
        state = hill_step(state, it, z, axis, axis_z, space, loglik_batch,
                          cfg, min_var)
        history.append(state.best_logl)
    hist = (torch.stack(history) if history
            else logl0.new_zeros((0,)))
    return HillClimbResult(best_x=state.best_x, best_logl=state.best_logl,
                           final_cov=state.cov, history_best=hist,
                           final_state=state)
