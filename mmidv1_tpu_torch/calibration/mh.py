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

Sharding (``mesh``, an :class:`~mmidv1_tpu_torch.parallel.mesh.EnsembleMesh`;
the JAX package's ``axis_name`` / ``n_total`` / ``offset`` hooks): each rank
holds a contiguous block of the ensemble's chains, draws its rows of the
global draw tables (:class:`.draws.ShardDraws`), and the cross-chain parts
are collectives: DE's walker table (an all-gather), the covariance moments
and the progress numbers (all-reduces), the global MAP (the first maximum
across ranks). A sharded run gives the unsharded run's samples up to the
order of those sums; on a mesh of one, the same bits.

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

from ..parallel.mesh import LOCAL
from ..utils.graphs import GraphCache
from ..utils.logging import get_logger
from ..utils.trace import span
from .draws import GeneratorDraws, SeededRunDraws, shard_draws
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
    """Sharded, every field is global but ``final_state``: this rank's."""
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
                  reg_eps: float = 1e-6, offset: int = 0) -> MHState:
    """Initialize the ensemble around ``theta0`` (d,): chain i starts at
    ``theta0 + jitter * sigmas * z[i]``, reflected into bounds; global chain
    0 starts exactly at theta0 (``offset``: the global index of this rank's
    first chain). A ``(B, d)`` ``theta0`` is taken as the start as is."""
    d = space.dim
    dtype = theta0.dtype
    if theta0.dim() == 1:
        x0 = theta0[None, :] + jitter * space.sigmas.to(dtype) * z
        if offset == 0:
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
            g_u: Optional[torch.Tensor] = None, mesh=LOCAL) -> MHState:
    """One Metropolis step for the whole ensemble (this rank's chains of
    it), given its draws: Gaussian proposals ``z (B, d)`` and accept
    uniforms ``u (B,)``; with ``proposal="de"`` also the partner rows ``j,
    k`` (ints in ``[0, B_total/2)``, indices into the frozen half of the
    global ensemble) and the gamma uniforms ``g_u (B,)``. The step is
    :func:`mh_propose`, one objective call on the proposals, then
    :func:`mh_accept`."""
    proposal, active = mh_propose(state, z, space, cfg, j=j, k=k, g_u=g_u,
                                  mesh=mesh)
    return mh_accept(state, proposal, loglik_batch(proposal), u, cfg,
                     active=active)


def mh_propose(state: MHState, z: torch.Tensor, space: ParameterSpace,
               cfg: MHConfig, *, j: Optional[torch.Tensor] = None,
               k: Optional[torch.Tensor] = None,
               g_u: Optional[torch.Tensor] = None, mesh=LOCAL):
    """The part of :func:`mh_step` before the objective call: the reflected
    proposals ``(B, d)``, and for DE the mask of the chains that move (None
    for AM)."""
    B, d = state.x.shape
    dtype = state.x.dtype
    scale = torch.exp(state.log_scale)[:, None]
    active = None
    if cfg.proposal == "de":
        # red-black halves (see MHConfig): the half whose parity matches the
        # step moves, with partners 2 r + (1 - parity) from the frozen half;
        # j == k is allowed (the move degenerates to the jitter). Parity is
        # that of the GLOBAL chain id, and the walkers come from every rank
        n_total = B * mesh.world_size
        if n_total % 2:
            raise ValueError(f"proposal='de' needs an even ensemble, "
                             f"got n_chains={n_total}")
        parity = state.step % 2
        ids = mesh.offset(n_total) + torch.arange(B, device=state.x.device)
        active = (ids % 2) == parity
        jj = 2 * j.long() + (1 - parity)
        kk = 2 * k.long() + (1 - parity)
        gamma = torch.where(g_u < cfg.de_gamma1_prob, torch.ones_like(g_u),
                            torch.full_like(g_u, 2.38 / math.sqrt(2 * d)))
        x_all = mesh.all_gather(state.x)
        diff = x_all[jj] - x_all[kk]
        jit_e = cfg.de_noise * space.sigmas.to(dtype) * z
        proposal = state.x + (scale * gamma[:, None]) * diff + jit_e
        proposal = torch.where(active[:, None], proposal, state.x)
    else:
        proposal = state.x + scale * (z @ state.chol.T)
    return space.reflect(proposal), active


def rm_gain(step: int) -> float:
    """The Robbins-Monro gain of the step that brings the count to
    ``step``: ``min(1 / sqrt(step + 1), 0.1)``, in double."""
    return min(1.0 / math.sqrt(step + 1.0), 0.1)


def mh_accept(state: MHState, proposal: torch.Tensor, logp_prop: torch.Tensor,
              u: torch.Tensor, cfg: MHConfig, *,
              active: Optional[torch.Tensor] = None,
              gamma=None, in_place: bool = False) -> MHState:
    """The part of :func:`mh_step` after the objective call, given the
    objective's values ``logp_prop (B,)`` at ``proposal``: the accept test,
    the new positions and values, each chain's best, the Robbins-Monro
    scale and the accept count. ``gamma`` is the step's Robbins-Monro gain,
    by default the Python float :func:`rm_gain` gives; the step graphs pass
    it as a 0-dim tensor of the state's dtype holding that float, which
    gives the same bits, as PyTorch rounds a Python scalar to the tensor's
    dtype. ``in_place`` writes each new field into ``state``'s own tensor
    (the step graphs' buffers), by the same elementwise ops; every old
    value is read before its tensor is written."""
    dtype = state.x.dtype
    out = (lambda f: getattr(state, f)) if in_place else (lambda f: None)
    logp_prop = safe_logp(logp_prop)
    log_ratio = logp_prop - state.logp
    # clamp: an f32 uniform hits exactly 0 ~2^-23/draw; log(0) = -inf
    # would unconditionally accept arbitrarily bad proposals
    log_u = torch.log(torch.clamp_min(u, 1e-12))
    accept = (log_ratio >= 0) | (log_u < log_ratio)
    if active is not None:
        # the frozen half would self-accept its unchanged state
        accept = accept & active

    x = torch.where(accept[:, None], proposal, state.x, out=out("x"))
    logp = torch.where(accept, logp_prop, state.logp, out=out("logp"))

    better = logp > state.best_logp
    best_x = torch.where(better[:, None], x, state.best_x, out=out("best_x"))
    best_logp = torch.where(better, logp, state.best_logp,
                            out=out("best_logp"))

    step = state.step + 1
    if cfg.adapt_scale:
        if gamma is None:
            gamma = rm_gain(step)
        delta = accept.to(dtype) - cfg.target_acceptance_rate
        if active is not None:
            delta = torch.where(active, delta, torch.zeros_like(delta))
        log_scale = torch.clamp(state.log_scale + gamma * delta, -6.9, 2.3,
                                out=out("log_scale"))
    else:
        log_scale = state.log_scale
    accept_count = torch.add(state.accept_count, accept.to(torch.int32),
                             out=out("accept_count"))

    return state._replace(
        x=x, logp=logp, log_scale=log_scale, best_x=best_x, best_logp=best_logp,
        accept_count=accept_count, step=step)


# eager steps at a (device, dtype, chain count) before the step graphs
# capture, AM's here and PT's (tempering._StepGraphs): they warm the
# allocator, cuBLAS and the kernels
EAGER_STEPS = 2
# the state fields the step graphs hold in fixed buffers
_BUFFERED = ("chol", "x", "logp", "log_scale", "best_x", "best_logp",
             "accept_count")


class _StepBuffers:
    """An AM step's state, draws and gain in fixed tensors, and the two
    parts of :func:`mh_step` on them: what :class:`_StepGraphs` captures.
    :meth:`accept` writes the new state into the buffers."""

    def __init__(self, state: MHState, space: ParameterSpace, cfg: MHConfig):
        self.space, self.cfg = space, cfg
        self.state = state._replace(**{
            f: torch.empty_like(getattr(state, f),
                                memory_format=torch.contiguous_format)
            for f in _BUFFERED})
        self.z = torch.empty_like(state.x)
        self.u = torch.empty_like(state.logp)
        self.lp = torch.empty_like(state.logp)   # the objective's values
        self.gamma = torch.empty((), dtype=state.x.dtype,
                                 device=state.x.device)

    def load(self, state: MHState, z: torch.Tensor, u: torch.Tensor):
        """Copy in the fields of ``state`` held outside the buffers (a new
        segment's state, a new covariance factor), the draws and the gain
        of ``state``'s next step."""
        for f in _BUFFERED:
            src, buf = getattr(state, f), getattr(self.state, f)
            if src is not buf:
                buf.copy_(src)
        self.z.copy_(z)
        self.u.copy_(u)
        if self.cfg.adapt_scale:
            self.gamma.fill_(rm_gain(state.step + 1))

    def propose(self) -> torch.Tensor:
        return mh_propose(self.state, self.z, self.space, self.cfg)[0]

    def accept(self, proposal: torch.Tensor):
        """:func:`mh_accept` on the objective's values in ``lp``, in place."""
        mh_accept(self.state, proposal, self.lp, self.u, self.cfg,
                  gamma=self.gamma, in_place=True)

    def result(self, state: MHState) -> MHState:
        """The state after ``state``'s step: the buffers, which the next step
        overwrites."""
        return self.state._replace(cov=state.cov, step=state.step + 1)


class _StepGraphs:
    """The single-rank AM step (:func:`mh_step`) replayed as two CUDA graphs
    a device, dtype and chain count around the objective call, which stays
    a Python call (:class:`..utils.graphs.GraphCache`: :data:`EAGER_STEPS`
    eager steps first, counter ``mh.graph``): ``before`` (:func:`mh_propose`)
    writes the proposals, ``after`` (:func:`mh_accept`) the new state, into
    fixed buffers (:class:`_StepBuffers`). A replayed step, the span
    ``mh.replay``, copies in what the state holds outside the buffers, its
    draws and its gain, replays ``before``, calls ``loglik_batch`` once on
    the proposals (through whatever wraps it), copies the values in and
    replays ``after``. The state returned holds the buffers, which the next
    step overwrites: a caller copies what it keeps (:meth:`release`)."""

    def __init__(self, space: ParameterSpace, cfg: MHConfig):
        self.space, self.cfg = space, cfg
        self.cache = GraphCache("mh.graph", EAGER_STEPS)

    def __call__(self, state: MHState, z: torch.Tensor, u: torch.Tensor,
                 loglik_batch: Callable) -> MHState:
        x = state.x
        B = int(x.shape[0])
        graphs = self.cache.get((x.device, x.dtype, B) if x.is_cuda else None,
                                x.device, B, lambda: self._build(state))
        if graphs is None:
            return mh_step(state, z, u, self.space, loglik_batch, self.cfg)
        bufs, proposal = graphs.held, graphs.outputs[0]
        with span("mh.replay"):
            bufs.load(state, z, u)
            graphs.replay(0)
            bufs.lp.copy_(loglik_batch(proposal))
            graphs.replay(1)
        return bufs.result(state)

    def _build(self, state: MHState):
        bufs = _StepBuffers(state, self.space, self.cfg)
        return bufs, (bufs.propose, bufs.accept)

    def release(self, state: MHState) -> MHState:
        """``state`` with copies of the buffers it holds."""
        held = {id(getattr(g.held.state, f))
                for g in self.cache.entries.values() for f in _BUFFERED}
        return state._replace(**{f: getattr(state, f).clone()
                                 for f in _BUFFERED
                                 if id(getattr(state, f)) in held})


def adapt_covariance(state: MHState, cfg: MHConfig, mesh=LOCAL) -> MHState:
    """Re-estimate the shared proposal covariance from the ensemble
    cross-section with the optimal (2.38^2/d) scaling (reference :168-199,
    ensemble estimator); sharded, the moments are summed over ranks, so
    every rank gets the GLOBAL covariance."""
    B_local, d = state.x.shape
    B = B_local * mesh.world_size
    centered = state.x - mesh.psum(torch.sum(state.x, dim=0)) / B
    cov = mesh.psum(centered.T @ centered) / (B - 1)
    cov = (2.38 ** 2 / d) * cov + cfg.regularization_epsilon * torch.eye(
        d, dtype=cov.dtype, device=cov.device)
    chol, _ok = _safe_cholesky(cov, cfg.regularization_epsilon, state.chol)
    return state._replace(cov=cov, chol=chol)


def _global_best(best_logp: torch.Tensor, best_x: torch.Tensor, mesh):
    """The MAP over every rank's chains (the first maximum)."""
    n = best_logp.shape[0]
    ids = mesh.offset(n * mesh.world_size) + torch.arange(
        n, device=best_logp.device)
    return mesh.first_max(best_logp, best_x, ids)


def _proposal_steps(cfg: MHConfig, step: int) -> int:
    """Proposals a chain has had after ``step`` steps: under the red-black
    DE scheme a chain is proposed every second step."""
    return step // 2 if cfg.proposal == "de" else step


def make_mh_runner(space: ParameterSpace, cfg: MHConfig,
                   loglik_batch: Callable, *,
                   progress_fn: Optional[Callable] = None,
                   mesh=LOCAL) -> Callable:
    """The segment program ``run(state0, draws) -> MHResult`` for ``cfg``:
    ``ceil(iterations / thinning)`` blocks of ``thinning`` steps, the
    covariance re-estimated at block boundaries past burn-in (AM only), a
    thinned sample stored per block. ``draws`` is a draw source
    (:mod:`.draws`); step ``i`` of the run takes ``draws.step(i)`` (and
    ``draws.partners(i)`` for DE). ``progress_fn(step, accept_rate,
    best_logp, mean_scale)`` is called every ``report_interval`` blocks, the
    only host reads of the run. The tracer's spans of a run: ``mh.draws``
    (a step's draws), ``mh.step`` (holding ``mh.replay`` where the step
    replays), ``mh.adapt_cov`` and ``mh.finish`` (the stack and gather at
    the end).

    Single-rank AM steps on the card replay as CUDA graphs
    (:class:`_StepGraphs`) from the third step at a chain count on; the
    samples and the final state a run returns are copies of the graphs'
    buffers. DE-MC and a mesh of more than one rank step eagerly.

    On a ``mesh`` the state is this rank's chains and ``draws`` gives its
    rows; the progress numbers are reduced over ranks (a collective: pass
    ``progress_fn`` on every rank or on none), and the result's samples,
    acceptance and scales are gathered from every rank."""
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
    graphs = None if de or mesh.world_size > 1 else _StepGraphs(space, cfg)
    # the step graphs' buffers change at the next step: keep copies
    keep = (lambda t: t) if graphs is None else torch.clone

    def run(state0: MHState, draws) -> MHResult:
        state = state0
        samples, logps = [], []
        for block in range(n_blocks):
            for t in range(thin):
                i = block * thin + t
                with span("mh.draws"):
                    z, u = draws.step(i)
                    j = k = g_u = None
                    if de:
                        j, k, g_u = draws.partners(i)
                with span("mh.step"):
                    if graphs is not None:
                        state = graphs(state, z, u, loglik_batch)
                    else:
                        state = mh_step(state, z, u, space, loglik_batch, cfg,
                                        j=j, k=k, g_u=g_u, mesh=mesh)
            if not de and state.step > cfg.burn_in and \
                    (state.step // thin) % adapt_every_blocks == 0:
                with span("mh.adapt_cov"):
                    state = adapt_covariance(state, cfg, mesh)
            if progress_fn is not None and (block + 1) % report_every == 0:
                ps = max(_proposal_steps(cfg, state.step), 1)
                progress_fn(state.step,
                            float(mesh.mean(state.accept_count / ps)),
                            float(mesh.pmax(torch.max(state.best_logp))),
                            float(mesh.mean(torch.exp(state.log_scale))))
            if cfg.store_samples:
                samples.append(keep(state.x))
                logps.append(keep(state.logp))
        with span("mh.finish"):
            if graphs is not None:
                state = graphs.release(state)
            return _finish(state, samples, logps, cfg, mesh)

    return run


def _finish(state: MHState, samples, logps, cfg: MHConfig, mesh) -> MHResult:
    """A run's result from its final state and stored samples."""
    B, d = state.x.shape
    best_x, best_logp = _global_best(state.best_logp, state.best_x, mesh)
    if samples:
        samples, logps = torch.stack(samples), torch.stack(logps)
    else:
        samples = state.x.new_zeros((0, B, d))
        logps = state.logp.new_zeros((0, B))
    ps = max(_proposal_steps(cfg, state.step), 1)
    return MHResult(
        samples=mesh.all_gather(samples, dim=1),
        sample_logps=mesh.all_gather(logps, dim=1),
        best_x=best_x, best_logp=best_logp,
        acceptance_rate=mesh.all_gather(
            state.accept_count.to(state.x.dtype) / ps),
        final_cov=state.cov,
        final_scale=mesh.all_gather(torch.exp(state.log_scale)),
        final_state=state)


def run_mh(loglik_batch: Callable, space: ParameterSpace, theta0: torch.Tensor,
           cfg: MHConfig, *, generator: Optional[torch.Generator] = None,
           n_chains: int = 8, initial_cov: Optional[torch.Tensor] = None,
           initial_state: Optional[MHState] = None, jitter: float = 1.0,
           progress_fn: Optional[Callable] = None, draws=None,
           mesh=LOCAL) -> MHResult:
    """Run the full ensemble sampler; ``loglik_batch`` maps ``(B, d)`` thetas
    to ``(B,)``. Returns thinned samples of shape
    ``(ceil(iterations/thinning), B, d)``; ``initial_state`` resumes a run.
    Every draw comes from ``generator`` (on the device of ``theta0``), or
    from the draw source ``draws``, either made for the whole ensemble.

    On a ``mesh`` (:func:`mmidv1_tpu_torch.parallel.run_mh_sharded`)
    ``n_chains`` is the GLOBAL chain count, this rank runs its share, takes
    its rows of every draw table, and ``initial_state`` is this rank's
    ``final_state`` of an earlier run."""
    run = make_mh_runner(space, cfg, loglik_batch, progress_fn=progress_fn,
                         mesh=mesh)
    dtype, dev = theta0.dtype, theta0.device
    if initial_state is not None:
        n_chains = initial_state.x.shape[0] * mesh.world_size
    if draws is None:
        if generator is None:
            raise ValueError("run_mh needs a generator or a draw source")
        draws = GeneratorDraws(generator, n_chains, space.dim, dtype, dev)
    draws = shard_draws(draws, mesh, n_chains)
    if initial_state is not None:
        state = initial_state
    else:
        state = init_mh_state(space, theta0, loglik_batch, draws.init(),
                              jitter=jitter, initial_cov=initial_cov,
                              reg_eps=cfg.regularization_epsilon,
                              offset=mesh.offset(n_chains))
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

    The tracer's spans of a segment: ``campaign.segment`` (the segment
    program), ``campaign.to_host`` (the thinned samples' copy) and
    ``campaign.checkpoint`` (:func:`~..utils.checkpoint.save_mh_state`).
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
        with span("campaign.segment"):
            result = runner(state, draws)
        state = result.final_state
        with span("campaign.to_host"):
            all_samples.append(result.samples.cpu())
            all_logps.append(result.sample_logps.cpu())
        if on_segment is not None:
            on_segment(s, result)
        if checkpoint_path:
            from ..utils.checkpoint import save_mh_state

            with span("campaign.checkpoint"):
                save_mh_state(checkpoint_path, state)
    if result is None:   # fully resumed campaign with nothing left to run
        raise ValueError(
            f"checkpoint already covers all {segments} segments "
            f"({state.step} steps); nothing to run")
    return result._replace(samples=torch.cat(all_samples),
                           sample_logps=torch.cat(all_logps))
