"""Ensemble Adaptive-Metropolis MCMC: thousands of chains in lockstep.

Port of ``mmidv1_tpu/calibration/mh.py``, re-design of
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
- progress lines every ``report_interval`` blocks (:363-378)

Ensemble upgrades, as in the JAX package: the covariance is re-estimated
from the ensemble cross-section every ``adaptation_period`` steps, the
scale is adapted per chain, and ``proposal="de"`` swaps the Gaussian for
differential-evolution moves updated red-black (see :class:`MHConfig`).
The JAX package's sharding hooks belong to the multi-device slice.

Random draws: :func:`mh_step` takes its Gaussian proposals ``z (B, d)``,
accept uniforms ``u (B,)`` and, for DE, its partner draws as tensors; the
runners ask a draw source (:mod:`.draws`) for them step by step.
:func:`run_mh` reads one ``torch.Generator``; :func:`run_mh_checkpointed`
seeds every segment's draws from ``(seed, segment)``, so a resumed
campaign repeats the uninterrupted one bit for bit. (The JAX package's
threefry stream cannot be reproduced in PyTorch, so tests feed both sides
the same draws.)
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.logging import get_logger
from .draws import GeneratorDraws, SeededRunDraws
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
    report_interval: int = 0   # blocks between progress callbacks (0 = every block)
    # proposal family: "am" = adaptive-Metropolis Gaussian (reference
    # semantics); "de" = differential evolution (ter Braak 2006): the
    # proposal is gamma * (x_j - x_k) between two other walkers, which
    # follows curved posterior manifolds a fixed Gaussian covariance cannot.
    # Symmetric, so the accept rule is unchanged. Moving every walker at once
    # from the same ensemble would break detailed balance of the joint
    # kernel, so the step alternates RED-BLACK halves by chain parity: the
    # other half is frozen, and the active half draws its partners only from
    # it (as emcee's parallel stretch move, Foreman-Mackey et al. 2013 §3).
    # A chain is proposed every second step; n_chains must be even.
    proposal: str = "am"
    de_gamma1_prob: float = 0.1   # P(gamma = 1) per chain-step (mode jumps)
    de_noise: float = 1e-6        # residual N(0, (de_noise*sigmas)^2) jitter

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
            report_interval=int(g("report_interval", 0)),
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
    return torch.where(ok, chol, prev).contiguous(), ok


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
    # row-major, as a checkpoint loads it: the factor LAPACK returns is
    # column-major, and a product with the other layout may round otherwise
    chol = torch.linalg.cholesky(cov).contiguous()
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
            cfg: MHConfig, *, j: Optional[torch.Tensor] = None,
            k: Optional[torch.Tensor] = None,
            g_u: Optional[torch.Tensor] = None) -> MHState:
    """One Metropolis step for the whole ensemble, given its draws: Gaussian
    proposals ``z (B, d)`` and accept uniforms ``u (B,)``; with
    ``proposal="de"`` also the partner rows ``j, k`` (ints in ``[0, B/2)``,
    indices into the frozen half) and the gamma uniforms ``g_u (B,)``."""
    B, d = state.x.shape
    dtype = state.x.dtype
    scale = torch.exp(state.log_scale)[:, None]
    active = None
    if cfg.proposal == "de":
        # red-black halves (see MHConfig): the half whose parity matches the
        # step moves, with partners 2 r + (1 - parity) from the frozen half;
        # j == k is allowed (the move degenerates to the jitter)
        if B % 2:
            raise ValueError(f"proposal='de' needs an even ensemble, "
                             f"got n_chains={B}")
        parity = state.step % 2
        active = (torch.arange(B, device=state.x.device) % 2) == parity
        jj = 2 * j.long() + (1 - parity)
        kk = 2 * k.long() + (1 - parity)
        gamma = torch.where(g_u < cfg.de_gamma1_prob, torch.ones_like(g_u),
                            torch.full_like(g_u, 2.38 / math.sqrt(2 * d)))
        diff = state.x[jj] - state.x[kk]
        jit_e = cfg.de_noise * space.sigmas.to(dtype) * z
        proposal = state.x + (scale * gamma[:, None]) * diff + jit_e
        proposal = torch.where(active[:, None], proposal, state.x)
    else:
        proposal = state.x + scale * (z @ state.chol.T)
    proposal = space.reflect(proposal)

    logp_prop = safe_logp(loglik_batch(proposal))
    log_ratio = logp_prop - state.logp
    # clamp: an f32 uniform hits exactly 0 ~2^-23/draw; log(0) = -inf
    # would unconditionally accept arbitrarily bad proposals
    log_u = torch.log(torch.clamp_min(u, 1e-12))
    accept = (log_ratio >= 0) | (log_u < log_ratio)
    if active is not None:
        # the frozen half would self-accept its unchanged state
        accept = accept & active

    x = torch.where(accept[:, None], proposal, state.x)
    logp = torch.where(accept, logp_prop, state.logp)

    better = logp > state.best_logp
    best_x = torch.where(better[:, None], x, state.best_x)
    best_logp = torch.where(better, logp, state.best_logp)

    step = state.step + 1
    if cfg.adapt_scale:
        gamma = min(1.0 / math.sqrt(step + 1.0), 0.1)
        delta = accept.to(dtype) - cfg.target_acceptance_rate
        if active is not None:
            delta = torch.where(active, delta, torch.zeros_like(delta))
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


def _proposal_steps(cfg: MHConfig, step: int) -> int:
    """Proposals a chain has had after ``step`` steps: under the red-black
    DE scheme a chain is proposed every second step."""
    return step // 2 if cfg.proposal == "de" else step


def make_mh_runner(space: ParameterSpace, cfg: MHConfig,
                   loglik_batch: Callable, *,
                   progress_fn: Optional[Callable] = None) -> Callable:
    """The segment program ``run(state0, draws) -> MHResult`` for ``cfg``:
    ``ceil(iterations / thinning)`` blocks of ``thinning`` steps, the
    covariance re-estimated at block boundaries past burn-in (AM only), a
    thinned sample stored per block. ``draws`` is a draw source
    (:mod:`.draws`); step ``i`` of the run takes ``draws.step(i)`` (and
    ``draws.partners(i)`` for DE). ``progress_fn(step, accept_rate,
    best_logp, mean_scale)`` is called every ``report_interval`` blocks, the
    only host reads of the run."""
    if cfg.iterations <= 0:
        raise ValueError(f"iterations must be positive, got {cfg.iterations}")
    thin = max(1, cfg.thinning)
    # ceil-division: at least `iterations` steps, in whole thinning blocks
    n_blocks = -(-cfg.iterations // thin)
    # adapt at block boundaries once past burn-in; with the reference
    # production config (thinning=100, adaptation_period=100) this is the
    # every-100-steps full recomputation
    adapt_every_blocks = max(1, cfg.adaptation_period // thin)
    report_every = max(1, cfg.report_interval)
    de = cfg.proposal == "de"

    def run(state0: MHState, draws) -> MHResult:
        state = state0
        samples, logps = [], []
        for block in range(n_blocks):
            for t in range(thin):
                i = block * thin + t
                z, u = draws.step(i)
                j = k = g_u = None
                if de:
                    j, k, g_u = draws.partners(i)
                state = mh_step(state, z, u, space, loglik_batch, cfg,
                                j=j, k=k, g_u=g_u)
            if not de and state.step > cfg.burn_in and \
                    (state.step // thin) % adapt_every_blocks == 0:
                state = adapt_covariance(state, cfg)
            if progress_fn is not None and (block + 1) % report_every == 0:
                ps = max(_proposal_steps(cfg, state.step), 1)
                progress_fn(state.step,
                            float(torch.mean(state.accept_count / ps)),
                            float(torch.max(state.best_logp)),
                            float(torch.mean(torch.exp(state.log_scale))))
            if cfg.store_samples:
                samples.append(state.x)
                logps.append(state.logp)
        B, d = state.x.shape
        i = torch.argmax(state.best_logp)
        if samples:
            samples, logps = torch.stack(samples), torch.stack(logps)
        else:
            samples = state.x.new_zeros((0, B, d))
            logps = state.logp.new_zeros((0, B))
        ps = max(_proposal_steps(cfg, state.step), 1)
        return MHResult(
            samples=samples, sample_logps=logps,
            best_x=state.best_x[i], best_logp=state.best_logp[i],
            acceptance_rate=state.accept_count.to(state.x.dtype) / ps,
            final_cov=state.cov, final_scale=torch.exp(state.log_scale),
            final_state=state)

    return run


def run_mh(loglik_batch: Callable, space: ParameterSpace, theta0: torch.Tensor,
           cfg: MHConfig, *, generator: Optional[torch.Generator] = None,
           n_chains: int = 8, initial_cov: Optional[torch.Tensor] = None,
           initial_state: Optional[MHState] = None, jitter: float = 1.0,
           progress_fn: Optional[Callable] = None, draws=None) -> MHResult:
    """Run the full ensemble sampler; ``loglik_batch`` maps ``(B, d)`` thetas
    to ``(B,)``. Returns thinned samples of shape
    ``(ceil(iterations/thinning), B, d)``; ``initial_state`` resumes a run.
    Every draw comes from ``generator`` (on the device of ``theta0``), or
    from the draw source ``draws``."""
    run = make_mh_runner(space, cfg, loglik_batch, progress_fn=progress_fn)
    dtype, dev = theta0.dtype, theta0.device
    if draws is None:
        if generator is None:
            raise ValueError("run_mh needs a generator or a draw source")
        B = n_chains if initial_state is None else initial_state.x.shape[0]
        draws = GeneratorDraws(generator, B, space.dim, dtype, dev)
    if initial_state is not None:
        state = initial_state
    else:
        state = init_mh_state(space, theta0, loglik_batch, draws.init(),
                              jitter=jitter, initial_cov=initial_cov,
                              reg_eps=cfg.regularization_epsilon)
    return run(state, draws)


def run_mh_checkpointed(
    loglik_batch: Callable,
    space: ParameterSpace,
    theta0: torch.Tensor,
    cfg: MHConfig,
    *,
    seed: int = 0,
    n_chains: int = 8,
    segments: int = 10,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    initial_cov: Optional[torch.Tensor] = None,
    jitter: float = 1.0,
    progress_fn: Optional[Callable] = None,
    on_segment: Optional[Callable] = None,
    draws_for_segment: Optional[Callable] = None,
) -> MHResult:
    """Production campaign driver: the run split into ``segments`` segments
    with a disk checkpoint after each (port of ``run_mh_checkpointed``).

    ``on_segment(segment_index, segment_result)`` fires after each segment,
    BEFORE the state checkpoint is written (artifacts first, state last: the
    checkpoint is the commit point). ``resume=True`` continues from an
    existing checkpoint at the segment its step falls in: each segment runs
    ``ceil(per_segment / thinning) * thinning`` steps, and the resume index
    divides by that. A checkpoint that already covers every segment raises
    ``ValueError``.

    Segment ``s`` draws from ``draws_for_segment(s)``, by default a
    :class:`~.draws.SeededRunDraws` of ``(seed, s)``, so a killed-and-resumed
    campaign gives exactly the uninterrupted campaign's samples. The
    returned :class:`MHResult` is the last segment's, with the thinned
    samples of every segment run in THIS process, moved to the host segment
    by segment; segments from before a resume live in their own files.
    """
    if segments <= 0:
        raise ValueError("segments must be positive")
    per_segment = -(-cfg.iterations // segments)
    seg_cfg = dataclasses.replace(cfg, iterations=per_segment)
    dtype, dev = theta0.dtype, theta0.device
    if draws_for_segment is None:
        draws_for_segment = lambda s: SeededRunDraws(seed, s, n_chains,
                                                     space.dim, dtype, dev)

    state = None
    start_segment = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        from ..utils.checkpoint import load_mh_state

        state = load_mh_state(checkpoint_path, device=dev)
        # each segment runs ceil(per_segment/thinning)*thinning steps: dividing
        # by per_segment would drift whenever thinning does not divide it
        thin = max(1, cfg.thinning)
        steps_per_segment = -(-per_segment // thin) * thin
        start_segment = state.step // steps_per_segment
        get_logger("mh").info(
            f"resuming campaign from {checkpoint_path} at step {state.step} "
            f"(segment {start_segment})")

    runner = make_mh_runner(space, seg_cfg, loglik_batch,
                            progress_fn=progress_fn)
    all_samples, all_logps = [], []
    result = None
    for s in range(start_segment, segments):
        draws = draws_for_segment(s)
        if state is None:
            state = init_mh_state(space, theta0, loglik_batch, draws.init(),
                                  jitter=jitter, initial_cov=initial_cov,
                                  reg_eps=seg_cfg.regularization_epsilon)
        result = runner(state, draws)
        state = result.final_state
        all_samples.append(result.samples.cpu())
        all_logps.append(result.sample_logps.cpu())
        if on_segment is not None:
            on_segment(s, result)
        if checkpoint_path:
            from ..utils.checkpoint import save_mh_state

            save_mh_state(checkpoint_path, state)
    if result is None:   # fully resumed campaign with nothing left to run
        raise ValueError(
            f"checkpoint already covers all {segments} segments "
            f"({state.step} steps); nothing to run")
    return result._replace(samples=torch.cat(all_samples),
                           sample_logps=torch.cat(all_logps))
