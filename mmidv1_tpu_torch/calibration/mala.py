"""Ensemble preconditioned MALA: gradient-guided MCMC at chain scale.

Port of ``mmidv1_tpu/calibration/mala.py``: a Metropolis-adjusted Langevin
ensemble (chains in lockstep, like :mod:`.mh`) whose gradients come from a
batch-level ``value_and_grad_batch`` (the K2/K3 engine,
:func:`mmidv1_tpu_torch.ops.build_objective_fused_grad`, or autograd).

The proposal is the preconditioned Langevin step

    x' = x + (eps^2 / 2) C grad logp(x) + eps L z,       C = L L^T

with the Metropolis-Hastings correction from the full asymmetric proposal
densities (triangular solves against L). The preconditioner C is
re-estimated from the ensemble cross-section every ``adaptation_period``
steps past burn-in; eps is Robbins-Monro-adapted per chain toward 0.574
acceptance. Proposals outside the box evaluate to the -1e18 floor and are
rejected; gradients are norm-clipped per chain at ``grad_clip_norm``.

Random draws: :func:`mala_step` takes its Gaussian proposals ``z (B, d)``
and accept uniforms ``u (B,)`` as tensors; :func:`run_mala` asks a draw
source (:mod:`.draws`) for them, by default one ``torch.Generator``.

Sharding (``mesh``, as in :mod:`.mh`): the drift, the proposal densities and
the accept/reject are chain-local; the preconditioner's moments, the
progress means and the MAP are reduced over ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..parallel.mesh import LOCAL
from .draws import GeneratorDraws, shard_draws
from .mh import _global_best, _safe_cholesky, safe_logp
from .nuts import value_and_grad_of
from .param_space import ParameterSpace

GRAD_CLIP_NORM = 1000.0


@dataclasses.dataclass(frozen=True)
class MALAConfig:
    """Settings; the shared knobs follow ``mcmc_settings.txt`` naming."""

    iterations: int = 1_000
    burn_in: int = 100
    adaptation_period: int = 100
    thinning: int = 1
    target_acceptance_rate: float = 0.574
    adapt_scale: bool = True
    regularization_epsilon: float = 1e-6
    initial_step_size: float = 0.1      # eps0 (in preconditioner units)
    grad_clip_norm: float = GRAD_CLIP_NORM
    report_interval: int = 0

    @classmethod
    def from_settings(cls, settings: dict) -> "MALAConfig":
        g = settings.get
        return cls(
            iterations=int(g("mcmc_iterations", 1_000)),
            burn_in=int(g("burn_in", 100)),
            adaptation_period=int(g("adaptation_period", 100)),
            thinning=max(1, int(g("thinning", 1))),
            target_acceptance_rate=float(g("target_acceptance_rate", 0.574)),
            adapt_scale=bool(g("adapt_scale", 1.0)),
            regularization_epsilon=float(g("regularization_epsilon", 1e-6)),
            initial_step_size=float(g("mala_step_size", 0.1)),
            report_interval=int(g("report_interval", 0)),
        )


class MALAState(NamedTuple):
    x: torch.Tensor            # (B, d) positions
    logp: torch.Tensor         # (B,)
    grad: torch.Tensor         # (B, d) clipped gradients at x
    log_eps: torch.Tensor      # (B,) per-chain Robbins-Monro log step size
    chol: torch.Tensor         # (d, d) preconditioner Cholesky factor L
    cov: torch.Tensor          # (d, d) preconditioner C = L L^T
    best_x: torch.Tensor       # (B, d)
    best_logp: torch.Tensor    # (B,)
    accept_count: torch.Tensor  # (B,) int32
    step: int


class MALAResult(NamedTuple):
    samples: torch.Tensor          # (n_stored, B, d)
    sample_logps: torch.Tensor     # (n_stored, B)
    best_x: torch.Tensor           # (d,)
    best_logp: torch.Tensor        # ()
    acceptance_rate: torch.Tensor  # (B,)
    final_cov: torch.Tensor        # (d, d)
    final_eps: torch.Tensor        # (B,)
    final_state: MALAState


def _clip_grad(grad: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Per-chain gradient-norm clipping (``NUTSSampler.cpp:84-91``); also
    zeroes non-finite components so a -inf plateau cannot poison the
    drift."""
    grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
    nrm = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    factor = torch.where(nrm > max_norm, max_norm / torch.clamp(nrm, min=1e-30),
                         torch.ones_like(nrm))
    return grad * factor


def _bounded_value_and_grad(space: ParameterSpace, vg_batch: Callable,
                            max_norm: float):
    """Evaluate (logp, clipped grad) with out-of-support positions floored
    to -1e18 (hard-reject bound handling)."""

    def eval_batch(x):
        logp, grad = vg_batch(x)
        inside = space.in_bounds(x)
        logp = torch.where(inside, safe_logp(logp), torch.full_like(logp, -1e18))
        grad = torch.where(inside[:, None], _clip_grad(grad, max_norm),
                           torch.zeros_like(grad))
        return logp, grad

    return eval_batch


def init_mala_state(space: ParameterSpace, theta0: torch.Tensor,
                    eval_batch: Callable, noise: Optional[torch.Tensor], *,
                    jitter: float = 1.0, initial_cov=None,
                    cfg: MALAConfig = MALAConfig(),
                    offset: int = 0) -> MALAState:
    """Jittered ensemble around a (d,) ``theta0`` (chain i at ``theta0 +
    jitter * sigmas * noise[i]``, global chain 0 exactly at theta0 --
    ``offset`` is the global index of this rank's first chain -- reflected
    into the box), or a (B, d) ``theta0`` used as is."""
    d = space.dim
    dtype, dev = theta0.dtype, theta0.device
    if theta0.dim() == 1:
        x0 = theta0[None, :] + jitter * space.sigmas.to(dtype) * noise
        if offset == 0:
            x0[0] = theta0
        x0 = space.reflect(x0)              # init inside support only
    else:
        x0 = theta0
    logp0, grad0 = eval_batch(x0)
    if initial_cov is not None:
        cov = torch.as_tensor(initial_cov, dtype=dtype, device=dev)
    else:
        sig = space.sigmas.to(dtype)
        cov = torch.diag(torch.where(sig > 0, sig * sig,
                                     torch.full_like(sig, 1e-6)))
    cov = cov + cfg.regularization_epsilon * torch.eye(d, dtype=dtype,
                                                       device=dev)
    chol = torch.linalg.cholesky(cov)
    B = x0.shape[0]
    return MALAState(
        x=x0, logp=logp0, grad=grad0,
        log_eps=torch.full((B,), math.log(cfg.initial_step_size), dtype=dtype,
                           device=dev),
        chol=chol, cov=cov, best_x=x0, best_logp=logp0,
        accept_count=torch.zeros(B, dtype=torch.int32, device=dev), step=0)


def mala_step(state: MALAState, z: torch.Tensor, u: torch.Tensor,
              space: ParameterSpace, eval_batch: Callable,
              cfg: MALAConfig) -> MALAState:
    """One preconditioned-MALA step for the whole ensemble, given its
    draws: Gaussian ``z (B, d)`` and accept uniforms ``u (B,)``."""
    d = state.x.shape[1]
    dtype = state.x.dtype
    eps = torch.exp(state.log_eps)[:, None]                     # (B, 1)
    L = state.chol

    def drift(grad):
        return 0.5 * (grad @ state.cov.T)

    mean_fwd = state.x + eps ** 2 * drift(state.grad)
    proposal = mean_fwd + eps * (z @ L.T)

    logp_prop, grad_prop = eval_batch(proposal)
    mean_rev = proposal + eps ** 2 * drift(grad_prop)

    def log_q(y, mean, eps):
        # N(y; mean, eps^2 C): -||L^{-1}(y-mean)||^2 / (2 eps^2) - d log eps
        r = torch.linalg.solve_triangular(L, (y - mean).T, upper=False).T
        return (-0.5 * torch.sum(r * r, dim=-1) / (eps[:, 0] ** 2)
                - d * torch.log(eps[:, 0]))

    log_ratio = (logp_prop - state.logp
                 + log_q(state.x, mean_rev, eps)
                 - log_q(proposal, mean_fwd, eps))
    # u clamped away from 0: log(0) = -inf would accept unconditionally
    accept = (log_ratio >= 0) | (torch.log(torch.clamp(u, min=1e-12)) < log_ratio)

    x = torch.where(accept[:, None], proposal, state.x)
    logp = torch.where(accept, logp_prop, state.logp)
    grad = torch.where(accept[:, None], grad_prop, state.grad)

    better = logp > state.best_logp
    best_x = torch.where(better[:, None], x, state.best_x)
    best_logp = torch.where(better, logp, state.best_logp)

    step = state.step + 1
    if cfg.adapt_scale:
        gamma = min(1.0 / math.sqrt(step + 1.0), 0.1)
        log_eps = torch.clamp(state.log_eps + gamma * (
            accept.to(dtype) - cfg.target_acceptance_rate), -6.9, 2.3)
    else:
        log_eps = state.log_eps
    return state._replace(
        x=x, logp=logp, grad=grad, log_eps=log_eps, best_x=best_x,
        best_logp=best_logp,
        accept_count=state.accept_count + accept.to(torch.int32), step=step)


def adapt_preconditioner(state: MALAState, cfg: MALAConfig,
                         mesh=LOCAL) -> MALAState:
    """Ensemble-cross-section covariance as the Langevin preconditioner
    (no 2.38^2/d: eps carries the global scale), moments summed over
    ranks."""
    B, d = state.x.shape
    B = B * mesh.world_size
    centered = state.x - mesh.psum(torch.sum(state.x, dim=0)) / B
    # max(B-1, 1): a single-chain ensemble would give a 0/0 NaN covariance
    cov = mesh.psum(centered.T @ centered) / max(B - 1, 1)
    cov = cov + cfg.regularization_epsilon * torch.eye(
        d, dtype=cov.dtype, device=cov.device)
    chol, ok = _safe_cholesky(cov, cfg.regularization_epsilon, state.chol)
    # commit cov only when the factorization succeeded, so cov and chol
    # stay consistent
    cov = torch.where(ok, cov, state.cov)
    return state._replace(cov=cov, chol=chol)


def run_mala(loglik_batch: Optional[Callable], space: ParameterSpace,
             theta0: torch.Tensor, cfg: MALAConfig, *,
             generator: Optional[torch.Generator] = None, n_chains: int = 8,
             initial_cov: Optional[torch.Tensor] = None,
             initial_state: Optional[MALAState] = None, jitter: float = 1.0,
             progress_fn: Optional[Callable] = None,
             value_and_grad_batch: Optional[Callable] = None,
             draws=None, mesh=LOCAL) -> MALAResult:
    """Run the ensemble MALA sampler. Gradients default to
    ``torch.autograd`` through ``loglik_batch``; pass
    ``value_and_grad_batch`` for a batch-native engine. Returns thinned
    samples ``(ceil(iterations/thinning), B, d)``, like :func:`mh.run_mh`.
    ``progress_fn(step, mean_accept, best_logp, mean_eps)`` is called every
    ``report_interval`` blocks (on a mesh, on every rank or on none: the
    numbers are reduced over ranks). The start's jitter is ``draws.init()``
    and step ``i``'s draws ``draws.step(i)``, from ``generator`` unless a
    draw source is given. On a ``mesh`` ``n_chains`` is the GLOBAL count,
    as for :func:`mh.run_mh`; the result is global but ``final_state``."""
    if cfg.iterations <= 0:
        raise ValueError(f"iterations must be positive, got {cfg.iterations}")
    if value_and_grad_batch is None:
        value_and_grad_batch = value_and_grad_of(loglik_batch)
    eval_batch = _bounded_value_and_grad(space, value_and_grad_batch,
                                         cfg.grad_clip_norm)
    dtype, dev = theta0.dtype, theta0.device
    if initial_state is not None:
        n_chains = initial_state.x.shape[0] * mesh.world_size
    if draws is None:
        if generator is None:
            raise ValueError("run_mala needs a generator or a draw source")
        draws = GeneratorDraws(generator, n_chains, space.dim, dtype, dev)
    draws = shard_draws(draws, mesh, n_chains)
    if initial_state is not None:
        state = initial_state
    else:
        state = init_mala_state(space, theta0, eval_batch, draws.init(),
                                jitter=jitter, initial_cov=initial_cov, cfg=cfg,
                                offset=mesh.offset(n_chains))
    thin = max(1, cfg.thinning)
    n_blocks = -(-cfg.iterations // thin)
    adapt_every_blocks = max(1, cfg.adaptation_period // thin)
    report_every = max(1, cfg.report_interval)
    samples, logps = [], []
    for block in range(n_blocks):
        for t in range(thin):
            z, u = draws.step(block * thin + t)
            state = mala_step(state, z, u, space, eval_batch, cfg)
        if state.step > cfg.burn_in and \
                (state.step // thin) % adapt_every_blocks == 0:
            state = adapt_preconditioner(state, cfg, mesh)
        if progress_fn is not None and (block + 1) % report_every == 0:
            progress_fn(state.step,
                        float(mesh.mean(state.accept_count.to(dtype)
                                        / max(state.step, 1))),
                        float(mesh.pmax(torch.max(state.best_logp))),
                        float(mesh.mean(torch.exp(state.log_eps))))
        samples.append(state.x)
        logps.append(state.logp)
    best_x, best_logp = _global_best(state.best_logp, state.best_x, mesh)
    return MALAResult(
        samples=mesh.all_gather(torch.stack(samples), dim=1),
        sample_logps=mesh.all_gather(torch.stack(logps), dim=1),
        best_x=best_x, best_logp=best_logp,
        acceptance_rate=mesh.all_gather(state.accept_count.to(dtype)
                                        / max(state.step, 1)),
        final_cov=state.cov, final_eps=mesh.all_gather(torch.exp(state.log_eps)),
        final_state=state)
