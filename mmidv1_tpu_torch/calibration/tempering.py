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
log-densities are untempered, hence comparable).

Sharding (``mesh``, as in :mod:`.mh`) splits the CHAIN axis (dim 1) of the
``(K, N, ...)`` fields; the rung axis stays whole on every rank. Swaps
exchange rung rows chain by chain, so they stay local; the swap rates' mean
over chains, the swap counters, the per-rung covariance and the MAP are
reduced over ranks, so the ladder and the ``(K, d, d)`` state are the same
on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import LOCAL
from .draws import GeneratorDraws, shard_draws
from .mh import safe_logp
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
    its draws ``z (K, N, d)`` and ``u (K, N)``: one objective call over
    ``K * N`` rows."""
    K, N, d = state.x.shape
    dtype = state.x.dtype
    scale = torch.exp(state.log_scale)[..., None]
    # per-rung correlated proposal z @ L_k^T (TF32 is off: utils/device.py)
    corr = torch.einsum("knd,ked->kne", z, state.chol)
    proposal = space.reflect(state.x + scale * corr)

    logp_prop = safe_logp(loglik_batch(proposal.reshape(K * N, d))) \
        .reshape(K, N)
    log_ratio = betas[:, None] * (logp_prop - state.logp)
    accept = (log_ratio >= 0) | (torch.log(torch.clamp_min(u, 1e-12))
                                 < log_ratio)

    x = torch.where(accept[..., None], proposal, state.x)
    logp = torch.where(accept, logp_prop, state.logp)

    better = logp > state.best_logp
    best_x = torch.where(better[..., None], x, state.best_x)
    best_logp = torch.where(better, logp, state.best_logp)

    step = state.step + 1
    if cfg.adapt_scale:
        gamma = min(1.0 / np.sqrt(step + 1.0), 0.1)
        log_scale = torch.clamp(state.log_scale + gamma * (
            accept.to(dtype) - cfg.target_acceptance_rate), -6.9, 2.3)
    else:
        log_scale = state.log_scale

    return state._replace(
        x=x, logp=logp, log_scale=log_scale, best_x=best_x,
        best_logp=best_logp,
        accept_count=state.accept_count + accept.to(torch.int32), step=step)


def pt_swap_step(state: PTState, u: torch.Tensor, betas: torch.Tensor,
                 parity: int, ema: float = 0.1, mesh=LOCAL) -> PTState:
    """One even-odd swap sweep, given its uniforms ``u (K-1, N)``: adjacent
    pairs (k, k+1) with k = parity (mod 2) exchange (x, logp) chain-column
    wise with the replica-exchange acceptance probability. Also keeps the
    per-pair mean swap-probability EMA the ladder adaptation reads (the
    analytic ``min(1, exp(log_alpha))`` averaged over every rank's
    chains)."""
    K, N, _d = state.x.shape
    n_total = N * mesh.world_size
    if K == 1:
        return state
    dev = state.x.device
    dlogp = state.logp[1:] - state.logp[:-1]                 # (K-1, N)
    dbeta = (betas[:-1] - betas[1:])[:, None]                # (K-1, 1)
    log_alpha = dbeta * dlogp
    pair_on = (torch.arange(K - 1, device=dev) % 2) == (parity % 2)
    accept = ((log_alpha >= 0) | (torch.log(torch.clamp_min(u, 1e-12))
                                  < log_alpha)) & pair_on[:, None]

    p_pair = mesh.psum(torch.sum(torch.exp(torch.clamp_max(log_alpha, 0.0)),
                                 dim=1)) / n_total
    swap_prob = torch.where(pair_on,
                            (1.0 - ema) * state.swap_prob + ema * p_pair,
                            state.swap_prob)

    pad = torch.zeros((1, N), dtype=torch.bool, device=dev)
    take_upper = torch.cat([accept, pad], dim=0)      # rung k <- k+1
    take_lower = torch.cat([pad, accept], dim=0)      # rung k <- k-1

    def exchange(a):
        down = torch.cat([a[1:], a[-1:]], dim=0)      # a[k+1]
        up = torch.cat([a[:1], a[:-1]], dim=0)        # a[k-1]
        tail = (1,) * (a.dim() - 2)
        m_up = take_upper.reshape(take_upper.shape + tail)
        m_lo = take_lower.reshape(take_lower.shape + tail)
        return torch.where(m_up, down, torch.where(m_lo, up, a))

    return state._replace(
        x=exchange(state.x), logp=exchange(state.logp),
        swap_accept=state.swap_accept
        + mesh.psum(accept.sum(dim=1)).to(torch.int32),
        swap_tries=state.swap_tries + (pair_on * n_total).to(torch.int32),
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


def make_pt_runner(space: ParameterSpace, cfg: PTConfig,
                   loglik_batch: Callable, mesh=LOCAL) -> Callable:
    """The segment program ``run(state0, draws) -> PTResult`` (the PT
    :func:`.mh.make_mh_runner`): step ``i`` takes ``draws.step(i)`` over
    ``K * N`` chains and, on a swap sweep, ``draws.swap(i, (K-1, N))``. On
    a ``mesh`` the state holds this rank's chains of every rung and the
    result's samples and acceptance are gathered from every rank."""
    if cfg.iterations <= 0:
        raise ValueError(f"iterations must be positive, got {cfg.iterations}")
    thin = max(1, cfg.thinning)
    n_blocks = -(-cfg.iterations // thin)
    adapt_every_blocks = max(1, cfg.adaptation_period // thin)
    swap_every = max(1, cfg.swap_every)

    def run(state0: PTState, draws) -> PTResult:
        state = state0
        K, N, d = state.x.shape
        samples, logps = [], []
        for block in range(n_blocks):
            for t in range(thin):
                i = block * thin + t
                z, u = draws.step(i)
                state = pt_mh_step(state, z.reshape(K, N, d), u.reshape(K, N),
                                   space, loglik_batch, cfg, state.betas)
                if state.step % swap_every == 0:
                    # pair parity alternates between swap sweeps
                    state = pt_swap_step(state, draws.swap(i, (K - 1, N)),
                                         state.betas,
                                         state.step // swap_every,
                                         ema=cfg.ladder_ema, mesh=mesh)
                    if cfg.adapt_ladder and state.step <= cfg.burn_in:
                        state = pt_adapt_ladder(state, cfg)
            # Unlike mh.py, covariance adaptation runs from step 0: PT
            # burn-in doubles as the ladder-adaptation window, and freezing
            # every rung's proposal at the warm init that long would cripple
            # mixing and feed the ladder swap rates from a mis-scaled
            # sampler. Burn-in still gates the ladder freeze.
            if (state.step // thin) % adapt_every_blocks == 0:
                state = pt_adapt_covariance(state, cfg, mesh)
            samples.append(state.x[0])
            logps.append(state.logp[0])
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
