"""Ensemble Adaptive-Metropolis MCMC: thousands of chains in lockstep.

Port of ``mmidv1_tpu/calibration/mh.py`` (:60-403), re-design of
``MetropolisHastingsSampler`` (reference:
``src/sir_age_structured/optimizers/MetropolisHastingsSampler.cpp``). An
ensemble of B chains advances together; each step makes one batched
objective call.

Same math as the reference:
- proposal Y = X + scale * L z with a shared Cholesky factor L (:91-102)
- reflection constraints applied to proposals before evaluation (:305-309)
- accept/reject in log space with lowest()-on-failure semantics (:314-343)
- initial covariance: Phase-1 warm start or diag(sigma^2) * 2.38^2/d, plus
  regularization epsilon (:219-246)
- covariance re-estimation with (2.38^2/d) scaling + regularization (:168-199)
- Robbins-Monro scale adaptation toward the target acceptance rate with
  gamma = min(1/sqrt(t+1), 0.1), log-scale clamped to [-6.9, 2.3] (:104-152)

Ensemble upgrades, as in the JAX package: the covariance is re-estimated
from the ensemble cross-section every ``adaptation_period`` steps, and the
scale is adapted per chain. The JAX package's differential-evolution
proposals and its sharding hooks belong to a later slice.

Random draws: :func:`mh_step` takes its Gaussian proposals ``z (B, d)`` and
accept uniforms ``u (B,)`` as tensors; :func:`run_mh` draws them from a
``torch.Generator``. (The JAX package's threefry stream cannot be reproduced
in PyTorch, so tests feed both sides the same draws.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from .param_space import ParameterSpace


@dataclasses.dataclass(frozen=True)
class MHConfig:
    """Settings; names/defaults follow ``mcmc_settings.txt`` and
    ``MetropolisHastingsSampler::configure`` (:25-50)."""

    iterations: int = 10_000
    burn_in: int = 1_000
    adaptation_period: int = 100
    thinning: int = 1
    target_acceptance_rate: float = 0.234
    adapt_scale: bool = True
    regularization_epsilon: float = 1e-6
    store_samples: bool = True

    @classmethod
    def from_settings(cls, settings: dict) -> "MHConfig":
        g = settings.get
        return cls(
            iterations=int(g("mcmc_iterations", 10_000)),
            burn_in=int(g("burn_in", 1_000)),
            adaptation_period=int(g("adaptation_period", 100)),
            thinning=max(1, int(g("thinning", 1))),
            target_acceptance_rate=float(g("target_acceptance_rate", 0.234)),
            adapt_scale=bool(g("adapt_scale", 1.0)),
            regularization_epsilon=float(g("regularization_epsilon", 1e-6)),
            store_samples=bool(g("store_samples", 1.0)),
        )


def safe_logp(lp: torch.Tensor) -> torch.Tensor:
    """NaN/Inf objective values -> -1e18, mirroring
    ``MetropolisHastingsSampler::safeEvaluate`` (:65-74). The finite floor (not
    finfo.min) keeps log-ratio arithmetic free of inf-inf NaNs."""
    floor = torch.full_like(lp, -1e18)
    return torch.where(torch.isfinite(lp), torch.maximum(lp, floor), floor)


class MHState(NamedTuple):
    x: torch.Tensor           # (B, d) current positions
    logp: torch.Tensor        # (B,) current log-posteriors
    log_scale: torch.Tensor   # (B,) per-chain Robbins-Monro log scale
    chol: torch.Tensor        # (d, d) shared proposal Cholesky factor
    cov: torch.Tensor         # (d, d) shared proposal covariance
    best_x: torch.Tensor      # (B, d) per-chain MAP position
    best_logp: torch.Tensor   # (B,)
    accept_count: torch.Tensor  # (B,) accepted proposals so far
    step: int                 # global step counter


class MHResult(NamedTuple):
    samples: torch.Tensor             # (n_stored, B, d) thinned chain states
    sample_logps: torch.Tensor        # (n_stored, B)
    best_x: torch.Tensor              # (d,) global MAP
    best_logp: torch.Tensor           # ()
    acceptance_rate: torch.Tensor     # (B,)
    final_cov: torch.Tensor           # (d, d)
    final_scale: torch.Tensor         # (B,)
    final_state: MHState


def _init_covariance(space: ParameterSpace, d: int, dtype,
                     initial_cov: Optional[torch.Tensor],
                     reg_eps: float) -> torch.Tensor:
    dev = space.device
    if initial_cov is not None:
        cov = torch.as_tensor(initial_cov, dtype=dtype, device=dev)
    else:
        sig = space.sigmas.to(dtype)
        cov = torch.diag(torch.where(sig > 0, sig * sig,
                                     torch.full_like(sig, 1e-6))) * (2.38 ** 2 / d)
    return cov + reg_eps * torch.eye(d, dtype=dtype, device=dev)


def _safe_cholesky(cov: torch.Tensor, reg_eps: float, prev: torch.Tensor):
    """Cholesky with the reference's fallback: keep the previous factor if the
    decomposition fails (:192-198). No host sync: the choice is a select."""
    d = cov.shape[0]
    chol, info = torch.linalg.cholesky_ex(
        cov + reg_eps * torch.eye(d, dtype=cov.dtype, device=cov.device))
    ok = (info == 0) & torch.all(torch.isfinite(chol))
    return torch.where(ok, chol, prev), ok


def init_mh_state(space: ParameterSpace, theta0: torch.Tensor,
                  loglik_batch: Callable, z: torch.Tensor, *,
                  jitter: float = 1.0,
                  initial_cov: Optional[torch.Tensor] = None,
                  reg_eps: float = 1e-6) -> MHState:
    """Initialize the ensemble around ``theta0`` (d,): chain i starts at
    ``theta0 + jitter * sigmas * z[i]``, reflected into bounds; chain 0 starts
    exactly at theta0. A ``(B, d)`` ``theta0`` is taken as the start as is."""
    d = space.dim
    dtype = theta0.dtype
    if theta0.dim() == 1:
        x0 = theta0[None, :] + jitter * space.sigmas.to(dtype) * z
        x0[0] = theta0
    else:
        x0 = theta0
    x0 = space.reflect(x0)
    logp0 = safe_logp(loglik_batch(x0))
    cov = _init_covariance(space, d, dtype, initial_cov, reg_eps)
    chol = torch.linalg.cholesky(cov)
    B = x0.shape[0]
    return MHState(
        x=x0, logp=logp0,
        log_scale=torch.zeros(B, dtype=dtype, device=x0.device),
        chol=chol, cov=cov,
        best_x=x0, best_logp=logp0,
        accept_count=torch.zeros(B, dtype=torch.int32, device=x0.device),
        step=0)


def mh_step(state: MHState, z: torch.Tensor, u: torch.Tensor,
            space: ParameterSpace, loglik_batch: Callable,
            cfg: MHConfig) -> MHState:
    """One Metropolis step for the whole ensemble, given its draws: Gaussian
    proposals ``z (B, d)`` and accept uniforms ``u (B,)``."""
    dtype = state.x.dtype
    scale = torch.exp(state.log_scale)[:, None]
    proposal = space.reflect(state.x + scale * (z @ state.chol.T))

    logp_prop = safe_logp(loglik_batch(proposal))
    log_ratio = logp_prop - state.logp
    # clamp: an f32 uniform hits exactly 0 ~2^-23/draw; log(0) = -inf
    # would unconditionally accept arbitrarily bad proposals
    log_u = torch.log(torch.clamp_min(u, 1e-12))
    accept = (log_ratio >= 0) | (log_u < log_ratio)

    x = torch.where(accept[:, None], proposal, state.x)
    logp = torch.where(accept, logp_prop, state.logp)

    better = logp > state.best_logp
    best_x = torch.where(better[:, None], x, state.best_x)
    best_logp = torch.where(better, logp, state.best_logp)

    step = state.step + 1
    if cfg.adapt_scale:
        gamma = min(1.0 / math.sqrt(step + 1.0), 0.1)
        delta = accept.to(dtype) - cfg.target_acceptance_rate
        log_scale = torch.clamp(state.log_scale + gamma * delta, -6.9, 2.3)
    else:
        log_scale = state.log_scale

    return state._replace(
        x=x, logp=logp, log_scale=log_scale, best_x=best_x, best_logp=best_logp,
        accept_count=state.accept_count + accept.to(torch.int32), step=step)


def adapt_covariance(state: MHState, cfg: MHConfig) -> MHState:
    """Re-estimate the shared proposal covariance from the ensemble
    cross-section with the optimal (2.38^2/d) scaling (reference :168-199,
    ensemble estimator)."""
    B, d = state.x.shape
    centered = state.x - torch.mean(state.x, dim=0)
    cov = (centered.T @ centered) / (B - 1)
    cov = (2.38 ** 2 / d) * cov + cfg.regularization_epsilon * torch.eye(
        d, dtype=cov.dtype, device=cov.device)
    chol, _ok = _safe_cholesky(cov, cfg.regularization_epsilon, state.chol)
    return state._replace(cov=cov, chol=chol)


def run_mh(loglik_batch: Callable, space: ParameterSpace, theta0: torch.Tensor,
           cfg: MHConfig, *, generator: torch.Generator, n_chains: int = 8,
           initial_cov: Optional[torch.Tensor] = None,
           initial_state: Optional[MHState] = None,
           jitter: float = 1.0) -> MHResult:
    """Run the full ensemble sampler; ``loglik_batch`` maps ``(B, d)`` thetas
    to ``(B,)``. Returns thinned samples of shape
    ``(ceil(iterations/thinning), B, d)``; ``initial_state`` resumes a run.
    Every draw comes from ``generator`` (on the device of ``theta0``)."""
    if cfg.iterations <= 0:
        raise ValueError(f"iterations must be positive, got {cfg.iterations}")
    dtype, dev = theta0.dtype, theta0.device
    d = space.dim

    if initial_state is not None:
        state = initial_state
    else:
        z0 = torch.randn((n_chains, d), generator=generator, dtype=dtype,
                         device=dev)
        state = init_mh_state(space, theta0, loglik_batch, z0, jitter=jitter,
                              initial_cov=initial_cov,
                              reg_eps=cfg.regularization_epsilon)
    B = state.x.shape[0]
    thin = max(1, cfg.thinning)
    # ceil-division: at least `iterations` steps, in whole thinning blocks
    n_blocks = -(-cfg.iterations // thin)
    # adapt at block boundaries once past burn-in; with the reference
    # production config (thinning=100, adaptation_period=100) this is the
    # every-100-steps full recomputation
    adapt_every_blocks = max(1, cfg.adaptation_period // thin)
    samples, logps = [], []
    for _block in range(n_blocks):
        for _ in range(thin):
            z = torch.randn((B, d), generator=generator, dtype=dtype, device=dev)
            u = torch.rand((B,), generator=generator, dtype=dtype, device=dev)
            state = mh_step(state, z, u, space, loglik_batch, cfg)
        if state.step > cfg.burn_in and \
                (state.step // thin) % adapt_every_blocks == 0:
            state = adapt_covariance(state, cfg)
        if cfg.store_samples:
            samples.append(state.x)
            logps.append(state.logp)
    i = torch.argmax(state.best_logp)
    if samples:
        samples, logps = torch.stack(samples), torch.stack(logps)
    else:
        samples = state.x.new_zeros((0, B, d))
        logps = state.logp.new_zeros((0, B))
    return MHResult(
        samples=samples, sample_logps=logps,
        best_x=state.best_x[i], best_logp=state.best_logp[i],
        acceptance_rate=state.accept_count.to(dtype) / max(state.step, 1),
        final_cov=state.cov, final_scale=torch.exp(state.log_scale),
        final_state=state)
