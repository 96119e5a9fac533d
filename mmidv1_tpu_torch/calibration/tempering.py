"""Replica-exchange (parallel tempering) ensemble MCMC.

Port of ``mmidv1_tpu/calibration/tempering.py``. Beyond the reference: the
Spain-2020 posterior is multimodal enough that plain ensemble AM leaves
chains stuck in their starting basins (split-R-hat >> 1 across 8192
chains), and the reference's single AM chain
(``MetropolisHastingsSampler.cpp:283-384``) has no remedy. K temperature
rungs x N chains is just a larger batch for the same objective: one call
over ``K * N`` rows a step; the per-rung proposals and the swaps are a few
tensor ops.

Design (as in the JAX package):

- state ``x`` is (K, N, d): rung 0 is the cold (true) posterior, rung K-1
  the hottest, on a ladder that starts geometric
  (``beta_k = beta_min ** (k / (K-1))``) and adapts during burn-in;
- ``logp`` is stored UNTEMPERED; tempering enters only the accept ratios, so
  a swap exchanges (x, logp) rows;
- each rung keeps its OWN proposal covariance, re-estimated from the rung's
  ensemble cross-section, plus the per-chain Robbins-Monro scale of
  :func:`.mh.mh_step`;
- swaps use the even-odd pairing: on parity p, every adjacent pair (k, k+1)
  with k = p (mod 2) exchanges chain i of rung k with chain i of rung k+1
  with log-acceptance (beta_k - beta_{k+1}) * (logp_{k+1} - logp_k), all in
  one masked op.

The step counter is a Python int, so the swap cadence, the ladder's burn-in
freeze and the covariance schedule cost no host read. Draws come from a draw
source (:mod:`.draws`) as for :mod:`.mh`. The cold rung's thinned history is
the returned sample; the MAP is taken over ALL rungs (hot-rung
log-densities are untempered, hence comparable). :func:`run_pt_checkpointed`
is the campaign driver: segments of the segment program with a disk
checkpoint after each, as :func:`.mh.run_mh_checkpointed` runs AM-MH.

Sharding (``mesh``, as in :mod:`.mh`) splits the CHAIN axis (dim 1) of the
``(K, N, ...)`` fields; the rung axis stays whole on every rank. Swaps
exchange rung rows chain by chain, so they stay local; the swap rates' mean
over chains, the swap counters, the per-rung covariance and the MAP are
reduced over ranks, so the ladder and the ``(K, d, d)`` state are the same
on every rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import LOCAL
from ..utils.trace import count, span
from ..utils.graphs import GraphCache
from . import mh
from .draws import GeneratorDraws, SeededRunDraws, shard_draws
from .mh import rm_gain, safe_logp
from .param_space import ParameterSpace


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """Settings. MH knobs mirror :class:`.mh.MHConfig`; tempering adds the
    ladder (``n_rungs``, ``beta_min``) and the swap cadence."""

    iterations: int = 10_000
    burn_in: int = 1_000
    adaptation_period: int = 100
    thinning: int = 1
    target_acceptance_rate: float = 0.234
    adapt_scale: bool = True
    regularization_epsilon: float = 1e-6
    n_rungs: int = 8
    beta_min: float = 0.05
    swap_every: int = 1          # steps between swap sweeps
    # Ladder adaptation (Vousden, Farr & Mandel 2016 MNRAS 455:1919):
    # equalize adjacent swap rates by Robbins-Monro on the log temperature
    # spacings, endpoints beta_0 = 1 and beta_{K-1} = beta_min fixed. It runs
    # during burn-in only, so the kept cold-rung samples come from a fixed
    # ladder.
    adapt_ladder: bool = True
    ladder_kappa: float = 0.3    # initial RM gain on log spacings
    ladder_t0: float = 1000.0    # gain decay timescale (in swap sweeps)
    ladder_ema: float = 0.1      # per-pair swap-probability EMA weight

    def ladder(self, dtype=torch.float64, device="cpu") -> torch.Tensor:
        """Geometric inverse-temperature ladder, beta_0 = 1 .. beta_min."""
        K = self.n_rungs
        if K < 1:
            raise ValueError("n_rungs must be >= 1")
        if not (0.0 < self.beta_min <= 1.0):
            raise ValueError("beta_min must be in (0, 1]")
        if K == 1:
            return torch.ones((1,), dtype=dtype, device=device)
        expo = np.arange(K) / (K - 1)
        return torch.as_tensor(self.beta_min ** expo).to(device=device,
                                                         dtype=dtype)


class PTState(NamedTuple):
    x: torch.Tensor           # (K, N, d) positions
    logp: torch.Tensor        # (K, N) UNTEMPERED log-posteriors
    log_scale: torch.Tensor   # (K, N) per-chain Robbins-Monro log scale
    chol: torch.Tensor        # (K, d, d) per-rung proposal Cholesky factors
    cov: torch.Tensor         # (K, d, d)
    best_x: torch.Tensor      # (K, N, d) per-slot MAP (slot-attached: swap
    best_logp: torch.Tensor   # (K, N)     moves do NOT migrate the records)
    accept_count: torch.Tensor   # (K, N) int32
    swap_accept: torch.Tensor    # (K-1,) int32 accepted swaps per pair
    swap_tries: torch.Tensor     # (K-1,) int32
    step: int                 # global step counter
    betas: torch.Tensor       # (K,) current inverse-temperature ladder
    ladder_s: torch.Tensor    # (K-1,) log spacings of T=1/beta (softmax param)
    swap_prob: torch.Tensor   # (K-1,) per-pair mean swap-probability EMA


class PTResult(NamedTuple):
    samples: torch.Tensor         # (n_stored, N, d) cold-rung thinned history
    sample_logps: torch.Tensor    # (n_stored, N)
    best_x: torch.Tensor          # (d,)
    best_logp: torch.Tensor       # ()
    acceptance_rate: torch.Tensor  # (K, N)
    swap_rate: torch.Tensor       # (K-1,) exchange acceptance per pair
    final_state: PTState


def _ladder_from_spacings(ladder_s: torch.Tensor, t_max) -> torch.Tensor:
    """(K,) inverse temperatures from (K-1,) log T-spacings: endpoints pinned
    at T_0 = 1 and T_{K-1} = t_max; interior rungs at the softmax-normalized
    cumulative spacings."""
    cum = torch.cumsum(torch.softmax(ladder_s, dim=0), dim=0)
    T = torch.cat([torch.ones((1,), dtype=ladder_s.dtype,
                              device=ladder_s.device),
                   1.0 + (t_max - 1.0) * cum])
    return 1.0 / T


def _spacings_from_betas(betas) -> np.ndarray:
    """Inverse of :func:`_ladder_from_spacings` (softmax is shift-invariant,
    so any representative works)."""
    T = 1.0 / np.asarray(betas, np.float64)
    if len(T) < 2:
        return np.zeros((1,))
    return np.log(np.maximum(np.diff(T), 1e-30))


def init_pt_state(space: ParameterSpace, theta0: torch.Tensor,
                  loglik_batch: Callable, z: torch.Tensor, *,
                  n_rungs: int, n_chains: int, jitter: float = 1.0,
                  initial_cov: Optional[torch.Tensor] = None,
                  reg_eps: float = 1e-6,
                  betas: Optional[torch.Tensor] = None,
                  beta_min: float = 0.05, offset: int = 0) -> PTState:
    """Initialize all rungs around ``theta0`` (d,), jittered by ``jitter *
    sigmas * z`` (``z`` is ``(K*N, d)``; rung-0 global chain 0 starts
    exactly at ``theta0``; ``offset``: the global index of this rank's first
    chain); every rung starts from the same conditioned covariance.
    ``betas`` seeds the ladder (default: the geometric ``beta_min``
    ladder); with ladder adaptation on it is only the starting point."""
    d = space.dim
    dtype, dev = theta0.dtype, theta0.device
    K, N = n_rungs, n_chains
    x0 = theta0[None, :] + jitter * space.sigmas.to(dtype) * z
    if offset == 0:
        x0[0] = theta0
    x0 = space.reflect(x0).reshape(K, N, d)
    logp0 = safe_logp(loglik_batch(x0.reshape(K * N, d))).reshape(K, N)

    if initial_cov is not None:
        cov1 = torch.as_tensor(initial_cov).to(device=dev, dtype=dtype)
    else:
        sig = space.sigmas.to(dtype)
        cov1 = torch.diag(torch.where(sig > 0, sig * sig,
                                      torch.full_like(sig, 1e-6))) \
            * (2.38 ** 2 / d)
    cov1 = cov1 + reg_eps * torch.eye(d, dtype=dtype, device=dev)
    cov = cov1.expand(K, d, d).clone()
    # row-major, as a checkpoint loads it (see mh.init_mh_state)
    chol = torch.linalg.cholesky(cov1).expand(K, d, d).contiguous()

    if betas is None:
        betas = PTConfig(n_rungs=K, beta_min=beta_min).ladder(dtype, dev)
    betas = torch.as_tensor(betas).to(device=dev, dtype=dtype)
    ladder_s = torch.as_tensor(_spacings_from_betas(betas.cpu().numpy())) \
        .to(device=dev, dtype=dtype)
    n_pairs = max(K - 1, 1)
    return PTState(
        x=x0, logp=logp0,
        log_scale=torch.zeros((K, N), dtype=dtype, device=dev),
        chol=chol, cov=cov,
        best_x=x0, best_logp=logp0,
        accept_count=torch.zeros((K, N), dtype=torch.int32, device=dev),
        swap_accept=torch.zeros((n_pairs,), dtype=torch.int32, device=dev),
        swap_tries=torch.zeros((n_pairs,), dtype=torch.int32, device=dev),
        step=0, betas=betas, ladder_s=ladder_s,
        swap_prob=torch.zeros((n_pairs,), dtype=dtype, device=dev))


def pt_mh_step(state: PTState, z: torch.Tensor, u: torch.Tensor,
               space: ParameterSpace, loglik_batch: Callable, cfg: PTConfig,
               betas: torch.Tensor) -> PTState:
    """One tempered Metropolis update of every chain on every rung, given
    its draws ``z (K, N, d)`` and ``u (K, N)``: :func:`pt_propose`, one
    objective call over ``K * N`` rows, then :func:`pt_accept`."""
    K, N, d = state.x.shape
    proposal = pt_propose(state, z, space)
    logp_prop = loglik_batch(proposal.reshape(K * N, d)).reshape(K, N)
    return pt_accept(state, proposal, logp_prop, u, cfg, betas)


def pt_propose(state: PTState, z: torch.Tensor,
               space: ParameterSpace) -> torch.Tensor:
    """The part of :func:`pt_mh_step` before the objective call: the
    reflected per-rung correlated proposals ``(K, N, d)``."""
    scale = torch.exp(state.log_scale)[..., None]
    # per-rung correlated proposal z @ L_k^T (TF32 is off: utils/device.py)
    corr = torch.einsum("knd,ked->kne", z, state.chol)
    return space.reflect(state.x + scale * corr)


def pt_accept(state: PTState, proposal: torch.Tensor,
              logp_prop: torch.Tensor, u: torch.Tensor, cfg: PTConfig,
              betas: torch.Tensor, *, gamma=None,
              in_place: bool = False) -> PTState:
    """The part of :func:`pt_mh_step` after the objective call, given its
    values ``logp_prop (K, N)`` at ``proposal``: the tempered accept test,
    the new positions and values, each slot's best, the Robbins-Monro scale
    and the accept count. ``gamma`` and ``in_place`` are those of
    :func:`.mh.mh_accept`: the step's gain as a 0-dim tensor (the same bits
    as the Python float :func:`.mh.rm_gain` gives), and each new field
    written into ``state``'s own tensor (the step graphs' buffers) after
    every old value it needs is read."""
    dtype = state.x.dtype
    out = (lambda f: getattr(state, f)) if in_place else (lambda f: None)
    logp_prop = safe_logp(logp_prop)
    log_ratio = betas[:, None] * (logp_prop - state.logp)
    accept = (log_ratio >= 0) | (torch.log(torch.clamp_min(u, 1e-12))
                                 < log_ratio)

    x = torch.where(accept[..., None], proposal, state.x, out=out("x"))
    logp = torch.where(accept, logp_prop, state.logp, out=out("logp"))

    better = logp > state.best_logp
    best_x = torch.where(better[..., None], x, state.best_x,
                         out=out("best_x"))
    best_logp = torch.where(better, logp, state.best_logp,
                            out=out("best_logp"))

    step = state.step + 1
    if cfg.adapt_scale:
        if gamma is None:
            gamma = rm_gain(step)
        log_scale = torch.clamp(state.log_scale + gamma * (
            accept.to(dtype) - cfg.target_acceptance_rate), -6.9, 2.3,
            out=out("log_scale"))
    else:
        log_scale = state.log_scale
    accept_count = torch.add(state.accept_count, accept.to(torch.int32),
                             out=out("accept_count"))

    return state._replace(
        x=x, logp=logp, log_scale=log_scale, best_x=best_x,
        best_logp=best_logp, accept_count=accept_count, step=step)


def _pair_mask(K: int, parity: int, device) -> torch.Tensor:
    """``(K-1,)``: the adjacent pairs ``(k, k+1)`` a sweep of ``parity``
    tries, those with ``k = parity (mod 2)``."""
    return (torch.arange(K - 1, device=device) % 2) == (parity % 2)


def pt_swap_step(state: PTState, u: torch.Tensor, betas: torch.Tensor,
                 parity: int, ema: float = 0.1, mesh=LOCAL, *,
                 pair_on: Optional[torch.Tensor] = None,
                 in_place: bool = False) -> PTState:
    """One even-odd swap sweep, given its uniforms ``u (K-1, N)``: adjacent
    pairs (k, k+1) with k = parity (mod 2) exchange (x, logp) chain-column
    wise with the replica-exchange acceptance probability. Also keeps the
    per-pair mean swap-probability EMA the ladder adaptation reads (the
    analytic ``min(1, exp(log_alpha))`` averaged over every rank's
    chains). ``pair_on``, the parity's pair mask as a tensor
    (:func:`_pair_mask`), stands in for ``parity``; ``in_place`` writes
    each new field into ``state``'s own tensor, as :func:`pt_accept`
    does."""
    K, N, _d = state.x.shape
    n_total = N * mesh.world_size
    if K == 1:
        return state
    dev = state.x.device
    out = (lambda f: getattr(state, f)) if in_place else (lambda f: None)
    dlogp = state.logp[1:] - state.logp[:-1]                 # (K-1, N)
    dbeta = (betas[:-1] - betas[1:])[:, None]                # (K-1, 1)
    log_alpha = dbeta * dlogp
    if pair_on is None:
        pair_on = _pair_mask(K, parity, dev)
    accept = ((log_alpha >= 0) | (torch.log(torch.clamp_min(u, 1e-12))
                                  < log_alpha)) & pair_on[:, None]

    p_pair = mesh.psum(torch.sum(torch.exp(torch.clamp_max(log_alpha, 0.0)),
                                 dim=1)) / n_total
    swap_prob = torch.where(pair_on,
                            (1.0 - ema) * state.swap_prob + ema * p_pair,
                            state.swap_prob, out=out("swap_prob"))

    pad = torch.zeros((1, N), dtype=torch.bool, device=dev)
    take_upper = torch.cat([accept, pad], dim=0)      # rung k <- k+1
    take_lower = torch.cat([pad, accept], dim=0)      # rung k <- k-1

    def exchange(f):
        a = getattr(state, f)
        down = torch.cat([a[1:], a[-1:]], dim=0)      # a[k+1]
        up = torch.cat([a[:1], a[:-1]], dim=0)        # a[k-1]
        tail = (1,) * (a.dim() - 2)
        m_up = take_upper.reshape(take_upper.shape + tail)
        m_lo = take_lower.reshape(take_lower.shape + tail)
        return torch.where(m_up, down, torch.where(m_lo, up, a), out=out(f))

    return state._replace(
        x=exchange("x"), logp=exchange("logp"),
        swap_accept=torch.add(state.swap_accept,
                              mesh.psum(accept.sum(dim=1)).to(torch.int32),
                              out=out("swap_accept")),
        swap_tries=torch.add(state.swap_tries,
                             (pair_on * n_total).to(torch.int32),
                             out=out("swap_tries")),
        swap_prob=swap_prob)


def pt_adapt_ladder(state: PTState, cfg: PTConfig) -> PTState:
    """One Robbins-Monro update of the temperature ladder (Vousden, Farr &
    Mandel 2016 eq. 11-12, fixed endpoints): widen the log T-spacing of
    pairs swapping more than average, shrink the rest. The gain decays as
    ``kappa * t0 / (t + t0)`` in swap sweeps."""
    K = state.x.shape[0]
    if K < 3:          # endpoints are pinned; nothing to adapt below 3 rungs
        return state
    # the gain timescale is in SWAP SWEEPS; state.step counts MH steps
    t = float(state.step // max(1, cfg.swap_every))
    # hold until both swap parities have been tried once: before that the
    # untried pairs' EMA still carries its 0.0 initialization
    gain = cfg.ladder_kappa * cfg.ladder_t0 / (t + cfg.ladder_t0) \
        if t >= 2.0 else 0.0
    s = state.ladder_s + gain * (state.swap_prob - torch.mean(state.swap_prob))
    t_max = 1.0 / state.betas[-1]   # hottest endpoint stays pinned
    return state._replace(ladder_s=s, betas=_ladder_from_spacings(s, t_max))


def pt_adapt_covariance(state: PTState, cfg: PTConfig,
                        mesh=LOCAL) -> PTState:
    """Per-rung ensemble covariance re-estimation (the per-rung
    :func:`.mh.adapt_covariance`, moments summed over ranks); a rung whose
    factorization fails keeps its previous factor."""
    K, N, d = state.x.shape
    n_total = N * mesh.world_size
    dtype, dev = state.x.dtype, state.x.device
    c = state.x - mesh.psum(torch.sum(state.x, dim=1, keepdim=True)) / n_total
    cov = mesh.psum(torch.einsum("knd,kne->kde", c, c)) / max(n_total - 1, 1)
    eye = torch.eye(d, dtype=dtype, device=dev)
    cov = (2.38 ** 2 / d) * cov + cfg.regularization_epsilon * eye
    chol, info = torch.linalg.cholesky_ex(cov + cfg.regularization_epsilon
                                          * eye)
    ok = (info == 0) & torch.isfinite(chol).flatten(1).all(dim=1)
    return state._replace(
        cov=cov,
        chol=torch.where(ok[:, None, None], chol, state.chol).contiguous())


# the state fields the step graphs hold in fixed buffers
_BUFFERED = ("x", "logp", "log_scale", "chol", "best_x", "best_logp",
             "accept_count", "betas", "swap_accept", "swap_tries",
             "swap_prob")


class _StepBuffers:
    """A tempered step's state, draws and gain, and a swap sweep's uniforms
    and pair mask, in fixed tensors; the parts of :func:`pt_mh_step` and
    :func:`pt_swap_step` on them: what :class:`_StepGraphs` captures.
    :meth:`accept` and :meth:`swap` write the new state into the
    buffers."""

    def __init__(self, state: PTState, space: ParameterSpace, cfg: PTConfig):
        self.space, self.cfg = space, cfg
        self.state = state._replace(**{
            f: torch.empty_like(getattr(state, f),
                                memory_format=torch.contiguous_format)
            for f in _BUFFERED})
        K, N, _d = state.x.shape
        self.z = torch.empty_like(state.x)
        self.u = torch.empty_like(state.logp)
        self.lp = torch.empty_like(state.logp)   # the objective's values
        self.gamma = torch.empty((), dtype=state.x.dtype,
                                 device=state.x.device)
        self.u_swap = state.logp.new_empty((K - 1, N))
        self.masks = tuple(_pair_mask(K, p, state.x.device) for p in (0, 1))
        self.pair_on = torch.empty_like(self.masks[0])

    def _load_state(self, state: PTState):
        """Copy in the fields of ``state`` held outside the buffers (a new
        segment's state, a new covariance factor or ladder)."""
        for f in _BUFFERED:
            src, buf = getattr(state, f), getattr(self.state, f)
            if src is not buf:
                buf.copy_(src)

    def load(self, state: PTState, z: torch.Tensor, u: torch.Tensor):
        """:meth:`_load_state`, then the draws and the gain of ``state``'s
        next step."""
        self._load_state(state)
        self.z.copy_(z)
        self.u.copy_(u)
        if self.cfg.adapt_scale:
            self.gamma.fill_(rm_gain(state.step + 1))

    def load_swap(self, state: PTState, u_swap: torch.Tensor, parity: int):
        """:meth:`_load_state`, then a sweep's uniforms and its pair mask."""
        self._load_state(state)
        self.u_swap.copy_(u_swap)
        self.pair_on.copy_(self.masks[parity % 2])

    def propose(self) -> torch.Tensor:
        return pt_propose(self.state, self.z, self.space)

    def accept(self, proposal: torch.Tensor):
        """:func:`pt_accept` on the objective's values in ``lp``, in
        place."""
        pt_accept(self.state, proposal, self.lp, self.u, self.cfg,
                  self.state.betas, gamma=self.gamma, in_place=True)

    def swap(self):
        """:func:`pt_swap_step` on ``u_swap`` and ``pair_on``, in place."""
        pt_swap_step(self.state, self.u_swap, self.state.betas, 0,
                     ema=self.cfg.ladder_ema, pair_on=self.pair_on,
                     in_place=True)

    def result(self, state: PTState, steps: int) -> PTState:
        """The state ``steps`` steps after ``state``: the buffers, which the
        next step overwrites."""
        return self.state._replace(cov=state.cov, ladder_s=state.ladder_s,
                                   step=state.step + steps)


class _StepGraphs:
    """The single-rank tempered step (:func:`pt_mh_step`) and swap sweep
    (:func:`pt_swap_step`) replayed as three CUDA graphs a device, dtype
    and ``(K, N)`` around the objective call, which stays a Python call
    (:class:`..utils.graphs.GraphCache`: :data:`.mh.EAGER_STEPS` eager
    steps first, counter ``pt.graph`` by ``K * N``): ``propose``
    (:func:`pt_propose`) writes the proposals, ``accept`` (:func:`pt_accept`)
    and ``swap`` the new state, into fixed buffers (:class:`_StepBuffers`).
    A replayed step copies in what the state holds outside the buffers, its
    draws and its gain, replays ``propose``, calls ``loglik_batch`` once on
    the proposals (through whatever wraps it), copies the values in and
    replays ``accept``; a sweep after it copies in its uniforms and its
    parity's pair mask and replays ``swap``, so one graph serves both
    parities and any ``swap_every``. The state returned holds the buffers,
    which the next step overwrites: a caller copies what it keeps
    (:meth:`release`)."""

    def __init__(self, space: ParameterSpace, cfg: PTConfig):
        self.space, self.cfg = space, cfg
        self.cache = GraphCache("pt.graph", mh.EAGER_STEPS)
        self.entry = None          # the graphs of the last step, or None

    def step(self, state: PTState, z: torch.Tensor, u: torch.Tensor,
             loglik_batch: Callable) -> PTState:
        x = state.x
        K, N, d = x.shape
        self.entry = self.cache.get(self._key(x), x.device, K * N,
                                    lambda: self._build(state))
        if self.entry is None:
            return pt_mh_step(state, z, u, self.space, loglik_batch, self.cfg,
                              state.betas)
        bufs, proposal = self.entry.held, self.entry.outputs[0]
        bufs.load(state, z, u)
        self.entry.replay(0)
        bufs.lp.copy_(loglik_batch(proposal.reshape(K * N, d)).reshape(K, N))
        self.entry.replay(1)
        return bufs.result(state, 1)

    def swap(self, state: PTState, u_swap: torch.Tensor,
             parity: int) -> PTState:
        """The sweep after :meth:`step`, graphed where that step was."""
        if self.entry is None:
            return pt_swap_step(state, u_swap, state.betas, parity,
                                ema=self.cfg.ladder_ema)
        bufs = self.entry.held
        bufs.load_swap(state, u_swap, parity)
        self.entry.replay(2)
        return bufs.result(state, 0)

    @staticmethod
    def _key(x: torch.Tensor):
        """The cache's key of the positions ``x``: None (eager) on the
        host."""
        return (x.device, x.dtype) + tuple(x.shape[:2]) if x.is_cuda else None

    def _build(self, state: PTState):
        bufs = _StepBuffers(state, self.space, self.cfg)
        return bufs, (bufs.propose, bufs.accept, lambda _: bufs.swap())

    def release(self, state: PTState) -> PTState:
        """``state`` with copies of the buffers it holds."""
        held = {id(getattr(g.held.state, f))
                for g in self.cache.entries.values() for f in _BUFFERED}
        return state._replace(**{f: getattr(state, f).clone()
                                 for f in _BUFFERED
                                 if id(getattr(state, f)) in held})


def make_pt_runner(space: ParameterSpace, cfg: PTConfig,
                   loglik_batch: Callable, mesh=LOCAL, *,
                   progress_fn: Optional[Callable] = None) -> Callable:
    """The segment program ``run(state0, draws) -> PTResult`` (the PT
    :func:`.mh.make_mh_runner`): step ``i`` takes ``draws.step(i)`` over
    ``K * N`` chains and, on a swap sweep, ``draws.swap(i, (K-1, N))``. On
    a ``mesh`` the state holds this rank's chains of every rung and the
    result's samples and acceptance are gathered from every rank.
    ``progress_fn(step, accept_rate, best_logp, mean_scale)``, over every
    rung's chains, is called after each block: the only host reads of the
    run.

    Single-rank steps and sweeps on the card replay as CUDA graphs
    (:class:`_StepGraphs`) from the third step at a ``(K, N)`` on; the
    samples and the final state a run returns are copies of the graphs'
    buffers. A mesh of more than one rank steps eagerly, as host tensors
    do.

    The tracer's spans of a run: ``pt.draws`` (a step's ``draws.step``, and
    ``draws.swap`` on a sweep), ``pt.step`` (:func:`pt_mh_step` or its
    replay, holding the objective's own spans), ``pt.swap``
    (:func:`pt_swap_step` or its replay), ``pt.adapt_ladder``,
    ``pt.adapt_cov`` and ``pt.finish`` (the stack, the MAP and the gathers
    at the end); the counter ``pt.sweeps`` counts the swap sweeps by
    ``(pair parity, K, N)``."""
    if cfg.iterations <= 0:
        raise ValueError(f"iterations must be positive, got {cfg.iterations}")
    thin = max(1, cfg.thinning)
    n_blocks = -(-cfg.iterations // thin)
    adapt_every_blocks = max(1, cfg.adaptation_period // thin)
    swap_every = max(1, cfg.swap_every)
    graphs = _StepGraphs(space, cfg) if mesh.world_size == 1 else None
    # the step graphs' buffers change at the next step: keep copies
    keep = (lambda t: t) if graphs is None else torch.clone

    def run(state0: PTState, draws) -> PTResult:
        state = state0
        K, N, d = state.x.shape
        samples, logps = [], []
        for block in range(n_blocks):
            for t in range(thin):
                i = block * thin + t
                with span("pt.draws"):
                    z, u = draws.step(i)
                z, u = z.reshape(K, N, d), u.reshape(K, N)
                with span("pt.step"):
                    if graphs is not None:
                        state = graphs.step(state, z, u, loglik_batch)
                    else:
                        state = pt_mh_step(state, z, u, space, loglik_batch,
                                           cfg, state.betas)
                if state.step % swap_every == 0:
                    # pair parity alternates between swap sweeps
                    parity = (state.step // swap_every) % 2
                    with span("pt.draws"):
                        u_swap = draws.swap(i, (K - 1, N))
                    with span("pt.swap"):
                        if graphs is not None:
                            state = graphs.swap(state, u_swap, parity)
                        else:
                            state = pt_swap_step(state, u_swap, state.betas,
                                                 parity, ema=cfg.ladder_ema,
                                                 mesh=mesh)
                    count("pt.sweeps", (parity, K, N))
                    if cfg.adapt_ladder and state.step <= cfg.burn_in:
                        with span("pt.adapt_ladder"):
                            state = pt_adapt_ladder(state, cfg)
            # Unlike mh.py, covariance adaptation runs from step 0: PT
            # burn-in doubles as the ladder-adaptation window, and freezing
            # every rung's proposal at the warm init that long would cripple
            # mixing and feed the ladder swap rates from a mis-scaled
            # sampler. Burn-in still gates the ladder freeze.
            if (state.step // thin) % adapt_every_blocks == 0:
                with span("pt.adapt_cov"):
                    state = pt_adapt_covariance(state, cfg, mesh)
            if progress_fn is not None:
                progress_fn(state.step,
                            float(mesh.mean(state.accept_count
                                            / max(state.step, 1))),
                            float(mesh.pmax(torch.max(state.best_logp))),
                            float(mesh.mean(torch.exp(state.log_scale))))
            samples.append(keep(state.x[0]))
            logps.append(keep(state.logp[0]))
        with span("pt.finish"):
            if graphs is not None:
                state = graphs.release(state)
            # the first maximum in the unsharded (K, n_total) rung-major order
            n_total = N * mesh.world_size
            ids = (torch.arange(K, device=state.x.device)[:, None] * n_total
                   + mesh.offset(n_total)
                   + torch.arange(N, device=state.x.device)[None, :])
            best_x, best_logp = mesh.first_max(state.best_logp.reshape(-1),
                                               state.best_x.reshape(K * N, d),
                                               ids.reshape(-1))
            dtype = state.x.dtype
            return PTResult(
                samples=mesh.all_gather(torch.stack(samples), dim=1),
                sample_logps=mesh.all_gather(torch.stack(logps), dim=1),
                best_x=best_x, best_logp=best_logp,
                acceptance_rate=mesh.all_gather(
                    state.accept_count.to(dtype) / max(state.step, 1), dim=1),
                swap_rate=state.swap_accept.to(dtype)
                / torch.clamp_min(state.swap_tries, 1).to(dtype),
                final_state=state)

    return run


def run_pt(loglik_batch: Callable, space: ParameterSpace,
           theta0: torch.Tensor, cfg: PTConfig, *,
           generator: Optional[torch.Generator] = None, n_chains: int = 8,
           initial_cov: Optional[torch.Tensor] = None,
           initial_state: Optional[PTState] = None, jitter: float = 1.0,
           draws=None, mesh=LOCAL) -> PTResult:
    """Run the replica-exchange sampler. ``loglik_batch`` sees batches of
    ``n_rungs * n_chains`` thetas. Returns the COLD rung's thinned samples;
    ``swap_rate`` should sit in ~[0.2, 0.6] per pair — a near-zero entry
    means the ladder has a gap (raise ``n_rungs`` or ``beta_min``). Every
    draw comes from ``generator`` (on the device of ``theta0``), or from
    the draw source ``draws``, made for every rung's whole ensemble. On a
    ``mesh`` ``n_chains`` is the GLOBAL count a rung and this rank runs its
    share (:func:`mmidv1_tpu_torch.parallel.run_pt_gspmd`)."""
    run = make_pt_runner(space, cfg, loglik_batch, mesh)
    dtype, dev = theta0.dtype, theta0.device
    K = cfg.n_rungs
    if initial_state is not None:
        K, N = initial_state.x.shape[:2]
        n_chains = N * mesh.world_size
    if draws is None:
        if generator is None:
            raise ValueError("run_pt needs a generator or a draw source")
        draws = GeneratorDraws(generator, K * n_chains, space.dim, dtype, dev)
    draws = shard_draws(draws, mesh, n_chains, rungs=K)
    if initial_state is not None:
        state = initial_state
    else:
        state = init_pt_state(space, theta0, loglik_batch, draws.init(),
                              n_rungs=K, n_chains=mesh.n_local(n_chains),
                              jitter=jitter, initial_cov=initial_cov,
                              reg_eps=cfg.regularization_epsilon,
                              betas=cfg.ladder(dtype, dev),
                              offset=mesh.offset(n_chains))
    return run(state, draws)


def run_pt_checkpointed(
    loglik_batch: Callable,
    space: ParameterSpace,
    theta0: torch.Tensor,
    cfg: PTConfig,
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
) -> PTResult:
    """The replica-exchange campaign driver (the PT
    :func:`.mh.run_mh_checkpointed`): ``cfg.iterations`` split into
    ``segments`` segments of the segment program (:func:`make_pt_runner`)
    with a disk checkpoint (:func:`~..utils.checkpoint.save_pt_state`)
    after each. ``n_chains`` is the count a rung, as in :func:`run_pt`.

    ``on_segment(segment_index, segment_result)`` fires after each segment,
    BEFORE the state checkpoint is written (artifacts first, state last: the
    checkpoint is the commit point). ``resume=True`` continues from an
    existing checkpoint at the segment its step falls in: each segment runs
    ``ceil(per_segment / thinning) * thinning`` steps, and the resume index
    divides by that. A checkpoint that already covers every segment raises
    ``ValueError``. A resume is not logged: the caller reports it.

    Segment ``s`` draws from ``draws_for_segment(s)``, by default a
    :class:`~.draws.SeededRunDraws` of ``(seed, s)`` over every rung's
    chains, so a killed-and-resumed campaign gives exactly the
    uninterrupted campaign's samples. The returned :class:`PTResult` is the
    last segment's, with the cold rung's thinned samples of every segment
    run in THIS process, moved to the host segment by segment.

    The tracer's spans of a segment: ``campaign.segment`` (the segment
    program), ``campaign.to_host`` (the thinned samples' copy) and
    ``campaign.checkpoint`` (``save_pt_state``).
    """
    if segments <= 0:
        raise ValueError("segments must be positive")
    per_segment = -(-cfg.iterations // segments)
    seg_cfg = dataclasses.replace(cfg, iterations=per_segment)
    K = cfg.n_rungs
    dtype, dev = theta0.dtype, theta0.device
    if draws_for_segment is None:
        draws_for_segment = lambda s: SeededRunDraws(seed, s, K * n_chains,
                                                     space.dim, dtype, dev)

    state = None
    start_segment = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        from ..utils.checkpoint import load_pt_state

        state = load_pt_state(checkpoint_path, device=dev)
        thin = max(1, cfg.thinning)
        start_segment = state.step // (-(-per_segment // thin) * thin)

    runner = make_pt_runner(space, seg_cfg, loglik_batch,
                            progress_fn=progress_fn)
    all_samples, all_logps = [], []
    result = None
    for s in range(start_segment, segments):
        draws = draws_for_segment(s)
        if state is None:
            state = init_pt_state(space, theta0, loglik_batch, draws.init(),
                                  n_rungs=K, n_chains=n_chains, jitter=jitter,
                                  initial_cov=initial_cov,
                                  reg_eps=seg_cfg.regularization_epsilon,
                                  betas=cfg.ladder(dtype, dev))
        with span("campaign.segment"):
            result = runner(state, draws)
        state = result.final_state
        with span("campaign.to_host"):
            all_samples.append(result.samples.cpu())
            all_logps.append(result.sample_logps.cpu())
        if on_segment is not None:
            on_segment(s, result)
        if checkpoint_path:
            from ..utils.checkpoint import save_pt_state

            with span("campaign.checkpoint"):
                save_pt_state(checkpoint_path, state)
    if result is None:   # fully resumed campaign with nothing left to run
        raise ValueError(
            f"checkpoint already covers all {segments} segments "
            f"({state.step} steps); nothing to run")
    return result._replace(samples=torch.cat(all_samples),
                           sample_logps=torch.cat(all_logps))
