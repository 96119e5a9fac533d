"""No-U-Turn Sampler with exact gradients through the ODE solve.

Port of ``mmidv1_tpu/calibration/nuts.py``, the re-design of ``NUTSSampler``
(reference: ``src/model/optimizers/NUTSSampler.cpp``, Hoffman & Gelman 2014
Alg. 6). The gradient engine is a batch-level
``value_and_grad_batch(thetas (B, d)) -> (logp (B,), grad (B, d))``: pass
:func:`mmidv1_tpu_torch.ops.build_objective_fused_grad` to run every
leapfrog's gradient through the K2/K3 kernels.

Faithful pieces (as in the JAX package):
- heuristic initial step size with 5 doubling/halving probes (:215-286)
- dual-averaging adaptation (mu = log(10 eps0), gamma=0.05, t0=10,
  kappa=0.75, delta target from settings) (:66-71, :167-181)
- leapfrog with gradient-norm clipping at 1000 and constraint clamping
  (:289-318)
- slice-variable doubling tree with DELTA_MAX=1000 divergence check and the
  U-turn criterion (:321-427), built iteratively over the 2^j leaves with an
  O(j) checkpoint stack
- non-finite iterations repeat the previous sample (:99-106)

The sampler is batch-native: every tree operation acts on ``(B, d)``
ensembles with per-chain masks. Python loops take the place of ``lax.scan``.

Random draws: every draw is a tensor handed in. One iteration's draws are a
:class:`NUTSDraws`; a whole run's come from a draw source
(:class:`SeededDraws` by default), whose draws are a pure function of
``(seed, purpose, iteration)``, so a run resumed from a :class:`NUTSState`
with the same seed continues bit for bit, as the JAX key table does. The
JAX package's threefry stream cannot be reproduced in PyTorch, so tests hand
both sides the draws JAX makes from its keys.

Sharding (``chain_sharding``, an
:class:`~mmidv1_tpu_torch.parallel.mesh.EnsembleMesh`): tree building, step
sizes and acceptance are chain-local, so each rank runs its block of chains
on its rows of the global draw tables (:class:`.draws.ShardDraws`); only the
best-chain argmax reduces across ranks, and the result is gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import LOCAL, EnsembleMesh
from .draws import seeded_generator, shard_draws
from .param_space import ParameterSpace

DELTA_MAX = 1000.0
GRAD_CLIP_NORM = 1000.0


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    """Settings mirror ``nuts_settings.txt``. ``eps_floor`` / ``eps_ceil``
    clamp the dual-averaged step (see the JAX package for why)."""

    iterations: int = 25
    adaptation_window: int = 5
    delta_target: float = 0.8
    max_tree_depth: int = 3
    eps_floor: float = 0.0
    eps_ceil: float = float("inf")

    @classmethod
    def from_settings(cls, s: dict) -> "NUTSConfig":
        g = s.get
        return cls(iterations=int(g("nuts_iterations", 25)),
                   adaptation_window=int(g("nuts_adaptation_window", 5)),
                   delta_target=float(g("nuts_delta_target", 0.8)),
                   max_tree_depth=int(g("nuts_max_tree_depth", 3)),
                   eps_floor=float(g("nuts_eps_floor", 0.0)),
                   eps_ceil=float(g("nuts_eps_ceil", float("inf"))))


class NUTSState(NamedTuple):
    """Full sampler state between iterations: the checkpoint/resume unit."""

    x: torch.Tensor              # (B, d) current positions
    logp: torch.Tensor           # (B,)
    grad: torch.Tensor           # (B, d)
    eps: torch.Tensor            # (B,) current step sizes
    log_eps_bar: torch.Tensor    # (B,) dual-averaging iterate
    h_bar: torch.Tensor          # (B,) dual-averaging statistic
    mu: torch.Tensor             # (B,) dual-averaging anchor log(10 eps0)
    it: int                      # iterations completed
    best_x: torch.Tensor         # (B, d)
    best_logp: torch.Tensor      # (B,)


class NUTSResult(NamedTuple):
    samples: torch.Tensor        # (iterations, B, d)
    sample_logps: torch.Tensor   # (iterations, B)
    best_x: torch.Tensor         # (d,)
    best_logp: torch.Tensor      # ()
    step_sizes: torch.Tensor     # (B,) final adapted step sizes
    mean_accept: torch.Tensor    # (B,)
    mean_depth: torch.Tensor     # (B,) mean doublings completed per iteration


class NUTSDraws(NamedTuple):
    """The draws of one iteration (JAX: ``nuts.py:414-434`` and :257)."""

    r0: torch.Tensor                     # (B, d) standard-normal momentum
    u: torch.Tensor                      # (B,) slice uniform in [1e-12, 1)
    v: torch.Tensor                      # (depth, B) direction uniforms
    leaf_u: Tuple[torch.Tensor, ...]     # depth j: (2**j, B) leaf uniforms
    accept_u: torch.Tensor               # (depth, B) subtree-accept uniforms


class SeededDraws:
    """Every draw of a run from ``torch.Generator``s seeded by a pure
    function of ``(seed, purpose, iteration)``."""

    def __init__(self, seed: int, n_chains: int, d: int, depth: int,
                 dtype: torch.dtype, device):
        self.seed, self.B, self.d, self.depth = int(seed), n_chains, d, depth
        self.dtype, self.device = dtype, torch.device(device)

    def _gen(self, *words) -> torch.Generator:
        return seeded_generator(self.seed, words, self.device)

    def _normal(self, g, shape):
        return torch.randn(shape, generator=g, dtype=self.dtype,
                           device=self.device)

    def _uniform(self, g, shape):
        return torch.rand(shape, generator=g, dtype=self.dtype,
                          device=self.device)

    def jitter(self) -> torch.Tensor:
        return self._normal(self._gen(0), (self.B, self.d))

    def eps_momentum(self) -> torch.Tensor:
        return self._normal(self._gen(1), (self.B, self.d))

    def iteration(self, it: int) -> NUTSDraws:
        g = self._gen(2, it)
        r0 = self._normal(g, (self.B, self.d))
        u = torch.clamp(self._uniform(g, (self.B,)), min=1e-12)
        v = self._uniform(g, (self.depth, self.B))
        leaf_u = tuple(self._uniform(g, (1 << j, self.B))
                       for j in range(self.depth))
        accept_u = self._uniform(g, (self.depth, self.B))
        return NUTSDraws(r0, u, v, leaf_u, accept_u)


def value_and_grad_of(loglik_batch: Callable) -> Callable:
    """``value_and_grad_batch`` by ``torch.autograd`` through a batched
    objective (chains independent, so the gradient of the sum is the
    per-chain gradient): the counterpart of ``vmap(value_and_grad(f))``."""

    def vag(thetas: torch.Tensor):
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            lp = loglik_batch(th)
            (g,) = torch.autograd.grad(lp.sum(), th)
        return lp.detach(), g

    return vag


def _clip_grad(g: torch.Tensor) -> torch.Tensor:
    """Per-chain gradient-norm clipping; g is (B, d)."""
    norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    factor = torch.where(norm > GRAD_CLIP_NORM, GRAD_CLIP_NORM / norm,
                         torch.ones_like(norm))
    return torch.where(torch.isfinite(factor), g * factor, torch.zeros_like(g))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)                      # (B,)


def _w(cond, x, y):
    """Per-chain select: cond (B,) against (B,) or (B, d) operands."""
    if x.dim() == cond.dim() + 1:
        cond = cond[..., None]
    return torch.where(cond, x, y)


class _Tree(NamedTuple):
    theta_minus: torch.Tensor    # (B, d)
    r_minus: torch.Tensor
    grad_minus: torch.Tensor
    theta_plus: torch.Tensor
    r_plus: torch.Tensor
    grad_plus: torch.Tensor
    theta_prime: torch.Tensor
    logp_prime: torch.Tensor     # (B,)
    n_prime: torch.Tensor        # (B,) int
    s_prime: torch.Tensor        # (B,) int
    alpha: torch.Tensor          # (B,)
    n_alpha: torch.Tensor        # (B,)


def _tz_slot(s: int, j: int) -> int:
    """min(trailing zeros of s, j); tz(0) -> j."""
    return j if s == 0 else min((s & -s).bit_length() - 1, j)


def _build_tree(vag_batch, space, theta, r, grad, log_u, v, j: int, eps,
                logp0_r0, leaf_u):
    """Iterative subtree of 2^j leapfrogs in direction ``v`` (B,) with the
    O(j) checkpoint stack (JAX ``_build_tree``, whose docstring gives the
    mechanics); ``leaf_u`` (2^j, B) are the reservoir-sampling uniforms."""
    dtype, dev = theta.dtype, theta.device
    B = theta.shape[0]
    ve = (v * eps)[:, None]

    def leapfrog(th, rr, gg):
        r_half = rr + 0.5 * ve * _clip_grad(gg)
        th1 = space.clamp(th + ve * r_half)
        logp1, g1 = vag_batch(th1)
        r1 = r_half + 0.5 * ve * _clip_grad(g1)
        return th1, r1, g1, logp1

    ck_t = [torch.zeros_like(theta) for _ in range(j + 1)]
    ck_r = [torch.zeros_like(theta) for _ in range(j + 1)]
    th, rr, gg = theta, r, grad
    live = torch.ones(B, dtype=torch.bool, device=dev)
    s_flag = torch.ones(B, dtype=torch.int32, device=dev)
    n_sum = torch.zeros(B, dtype=torch.int32, device=dev)
    prop_th = theta
    prop_lp = torch.full((B,), -math.inf, dtype=dtype, device=dev)
    alpha = torch.zeros(B, dtype=dtype, device=dev)
    n_alpha = torch.zeros(B, dtype=dtype, device=dev)
    first = (theta, r, grad)
    one, zero = torch.ones((), dtype=dtype, device=dev), \
        torch.zeros((), dtype=dtype, device=dev)
    for k in range(1 << j):
        th1, r1, g1, logp1 = leapfrog(th, rr, gg)
        joint = logp1 - 0.5 * _dot(r1, r1)
        finite = torch.isfinite(joint)
        n1 = (finite & (log_u <= joint)).to(torch.int32)
        div_ok = finite & (log_u < joint + DELTA_MAX)
        a1 = torch.where(finite, torch.minimum(one, torch.exp(joint - logp0_r0)),
                         zero)

        # reservoir-sample this leaf into the subtree proposal (only live
        # chains extend their subtree; dead chains keep everything)
        n_new = n_sum + n1
        take = live & (leaf_u[k] * torch.clamp(n_new, min=1).to(dtype)
                       < n1.to(dtype))
        prop_th = _w(take, th1, prop_th)
        prop_lp = torch.where(take, logp1, prop_lp)
        n_sum = torch.where(live, n_new, n_sum)
        alpha = torch.where(live, alpha + a1, alpha)
        n_alpha = torch.where(live, n_alpha + 1.0, n_alpha)

        slot = _tz_slot(k, j)
        ck_t[slot] = _w(live, th1, ck_t[slot])
        ck_r[slot] = _w(live, r1, ck_r[slot])

        # U-turn checks for every complete block ending at this leaf
        ok = div_ok
        for m in range(1, j + 1):
            if (k + 1) % (1 << m) != 0:
                continue
            sl = _tz_slot(k + 1 - (1 << m), j)
            # oriented span; momenta enter raw (H&G Alg 6)
            dth = (th1 - ck_t[sl]) * v[:, None]
            no_ut = (_dot(dth, ck_r[sl]) >= 0) & (_dot(dth, r1) >= 0)
            ok = ok & no_ut
        s_flag = torch.where(live, ok.to(torch.int32), s_flag)
        if k == 0:
            first = tuple(_w(live, x, f) for x, f in zip((th1, r1, g1), first))
        # dead chains freeze their end state too
        th = _w(live, th1, th)
        rr = _w(live, r1, rr)
        gg = _w(live, g1, gg)
        live = live & ok

    th_first, r_first, g_first = first
    pos = v > 0
    none_taken = n_sum == 0
    return _Tree(_w(pos, th_first, th), _w(pos, r_first, rr),
                 _w(pos, g_first, gg), _w(pos, th, th_first),
                 _w(pos, rr, r_first), _w(pos, gg, g_first),
                 _w(none_taken, theta, prop_th),
                 torch.where(none_taken, logp0_r0, prop_lp),
                 n_sum, s_flag, alpha, n_alpha)


def find_reasonable_epsilon(vag_batch, space, theta0, sigmas, r0,
                            max_probes: int = 5):
    """Heuristic initial epsilon per chain (:215-286): start from the mean
    proposal sigma, then double/halve until the one-step acceptance crosses
    0.5. ``theta0``, ``r0``: (B, d) (``r0`` the probe momentum); returns
    (B,). Every probe evaluates every chain, as the JAX scan does."""
    dtype, dev = theta0.dtype, theta0.device
    B = theta0.shape[0]
    start = max(float(torch.mean(sigmas.to(dtype))), 1e-4)
    eps = torch.full((B,), start, dtype=dtype, device=dev)
    logp0, grad0 = vag_batch(theta0)
    joint0 = logp0 - 0.5 * _dot(r0, r0)
    log_half = math.log(0.5)

    def full_ratio(eps):
        r_half = r0 + 0.5 * eps[:, None] * _clip_grad(grad0)
        theta1 = space.clamp(theta0 + eps[:, None] * r_half)
        logp1, grad1 = vag_batch(theta1)
        r1 = r_half + 0.5 * eps[:, None] * _clip_grad(grad1)
        return logp1 - 0.5 * _dot(r1, r1) - joint0

    up = full_ratio(eps) > log_half
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_probes):
        ratio = full_ratio(eps)
        crossed = torch.where(up, ratio <= log_half, ratio > log_half)
        done = done | crossed | ~torch.isfinite(ratio)
        eps = torch.where(done, eps, eps * torch.where(up, 2.0, 0.5))
    return torch.clamp(eps, 1e-8, 1e2)


def _safe(value_and_grad_batch):
    def safe_vag(thetas):
        lp, g = value_and_grad_batch(thetas)
        lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -1e18))
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return lp, g

    return safe_vag


def nuts_iteration(state: NUTSState, draws: NUTSDraws, safe_vag,
                   space: ParameterSpace, cfg: NUTSConfig):
    """One NUTS iteration of the whole ensemble, given its draws. Returns
    ``(state, (x, logp, accept_stat, depth_count))``."""
    gamma, t0, kappa = 0.05, 10.0, 0.75
    x, logp, grad, eps = state.x, state.logp, state.grad, state.eps
    dtype, dev = x.dtype, x.device
    B = x.shape[0]
    r0 = draws.r0
    joint0 = logp - 0.5 * _dot(r0, r0)
    log_u = joint0 + torch.log(draws.u)

    tree = _Tree(x, r0, grad, x, r0, grad, x, logp,
                 torch.ones(B, dtype=torch.int32, device=dev),
                 torch.ones(B, dtype=torch.int32, device=dev),
                 torch.zeros(B, dtype=dtype, device=dev),
                 torch.ones(B, dtype=dtype, device=dev))
    sample_x, sample_logp = x, logp
    alpha_stat = torch.zeros(B, dtype=dtype, device=dev)
    n_alpha_stat = torch.zeros(B, dtype=dtype, device=dev)
    n_cum = torch.ones(B, dtype=dtype, device=dev)
    depth_count = torch.zeros(B, dtype=dtype, device=dev)
    for j in range(cfg.max_tree_depth):
        v = torch.where(draws.v[j] < 0.5, -1.0, 1.0).to(dtype)
        pos = v > 0
        sub = _build_tree(safe_vag, space,
                          _w(pos, tree.theta_plus, tree.theta_minus),
                          _w(pos, tree.r_plus, tree.r_minus),
                          _w(pos, tree.grad_plus, tree.grad_minus),
                          log_u, v, j, eps, joint0, draws.leaf_u[j])
        valid = tree.s_prime == 1
        depth_count = depth_count + valid.to(dtype)
        # Metropolis-within-doubling acceptance of the new subtree sample
        accept_prob = sub.n_prime.to(dtype) / torch.clamp(n_cum, min=1.0)
        take = valid & (sub.s_prime == 1) & (draws.accept_u[j] < accept_prob)
        sample_x = _w(take, sub.theta_prime, sample_x)
        sample_logp = _w(take, sub.logp_prime, sample_logp)
        alpha_stat = torch.where(valid, alpha_stat + sub.alpha, alpha_stat)
        n_alpha_stat = torch.where(valid, n_alpha_stat + sub.n_alpha,
                                   n_alpha_stat)
        n_cum = torch.where(valid, n_cum + sub.n_prime, n_cum)

        minus, plus = valid & ~pos, valid & pos
        theta_minus = _w(minus, sub.theta_minus, tree.theta_minus)
        r_minus = _w(minus, sub.r_minus, tree.r_minus)
        grad_minus = _w(minus, sub.grad_minus, tree.grad_minus)
        theta_plus = _w(plus, sub.theta_plus, tree.theta_plus)
        r_plus = _w(plus, sub.r_plus, tree.r_plus)
        grad_plus = _w(plus, sub.grad_plus, tree.grad_plus)
        dtheta = theta_plus - theta_minus
        no_uturn = (_dot(dtheta, r_minus) >= 0) & (_dot(dtheta, r_plus) >= 0)
        s_new = torch.where(valid, sub.s_prime * no_uturn.to(torch.int32),
                            tree.s_prime)
        tree = tree._replace(theta_minus=theta_minus, r_minus=r_minus,
                             grad_minus=grad_minus, theta_plus=theta_plus,
                             r_plus=r_plus, grad_plus=grad_plus, s_prime=s_new)

    accept_stat = alpha_stat / torch.clamp(n_alpha_stat, min=1.0)
    new_logp, new_grad = safe_vag(sample_x)
    # non-finite iteration -> repeat previous sample (:99-106)
    ok = torch.isfinite(new_logp) & (new_logp > -1e17)
    x_new = _w(ok, sample_x, x)
    logp_new = torch.where(ok, new_logp, logp)
    grad_new = _w(ok, new_grad, grad)

    # dual averaging (:167-181)
    in_window = state.it < cfg.adaptation_window
    t = state.it + 1.0
    h_bar, log_eps_bar = state.h_bar, state.log_eps_bar
    if in_window:
        h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + \
            (cfg.delta_target - accept_stat) / (t + t0)
        log_eps = state.mu - math.sqrt(t) / gamma * h_bar
        eta = t ** (-kappa)
        log_eps_bar = eta * log_eps + (1 - eta) * log_eps_bar
        eps_new = torch.exp(log_eps)
    else:
        eps_new = torch.exp(log_eps_bar)
    eps_new = torch.clamp(eps_new, cfg.eps_floor, cfg.eps_ceil)

    better = logp_new > state.best_logp
    best_x = _w(better, x_new, state.best_x)
    best_logp = torch.where(better, logp_new, state.best_logp)
    new = NUTSState(x_new, logp_new, grad_new, eps_new, log_eps_bar, h_bar,
                    state.mu, state.it + 1, best_x, best_logp)
    return new, (x_new, logp_new, accept_stat, depth_count)


def run_nuts(loglik_batch: Optional[Callable], space: ParameterSpace,
             theta0: torch.Tensor, cfg: NUTSConfig, *, seed: int = 0,
             n_chains: int = 1, jitter: float = 0.1,
             value_and_grad_batch: Optional[Callable] = None,
             chain_sharding=None, segments: int = 1,
             initial_state: Optional[NUTSState] = None,
             on_segment: Optional[Callable] = None,
             draws=None) -> NUTSResult:
    """Run NUTS for an ensemble of chains.

    ``value_and_grad_batch(thetas (B, d)) -> (logp (B,), grad (B, d))``
    overrides the default, ``torch.autograd`` through ``loglik_batch``;
    pass the K2/K3 engine (:func:`mmidv1_tpu_torch.ops.
    build_objective_fused_grad`) to run the gradients through the kernels.
    ``theta0`` is a (d,) start, jittered by ``jitter * sigmas`` for every
    chain but chain 0, or a (n_chains, d) warm ensemble used as is (both
    clamped into the box).

    ``segments`` splits the iterations into that many equal parts; after
    each, ``on_segment(state, xs, lps)`` sees the carried
    :class:`NUTSState` and that part's samples, and a truthy return stops
    the run. ``initial_state`` resumes a run: with the same ``seed`` and
    ``cfg`` the continuation is bit-identical to the uninterrupted run (the
    draws of iteration ``it`` depend only on the seed and ``it``); the
    samples returned cover only the iterations this call ran. ``draws``
    replaces the :class:`SeededDraws` source (an object with ``jitter()``,
    ``eps_momentum()`` and ``iteration(it)``), made for all ``n_chains``.

    ``chain_sharding`` (an :class:`~mmidv1_tpu_torch.parallel.mesh.
    EnsembleMesh`) splits the ``n_chains`` (global) chains over its ranks:
    a 2-D ``theta0`` and ``initial_state`` / ``on_segment``'s state are
    then this rank's, the returned result is global."""
    if chain_sharding is not None and \
            not isinstance(chain_sharding, EnsembleMesh):
        raise TypeError(f"chain_sharding must be an EnsembleMesh "
                        f"(mmidv1_tpu_torch.parallel.ensemble_mesh), got "
                        f"{type(chain_sharding).__name__}")
    mesh = LOCAL if chain_sharding is None else chain_sharding
    dtype, dev = theta0.dtype, theta0.device
    d = space.dim
    if value_and_grad_batch is None:
        value_and_grad_batch = value_and_grad_of(loglik_batch)
    safe_vag = _safe(value_and_grad_batch)
    B = mesh.n_local(n_chains)
    offset = mesh.offset(n_chains)
    if draws is None:
        draws = SeededDraws(seed, n_chains, d, cfg.max_tree_depth, dtype, dev)
    draws = shard_draws(draws, mesh, n_chains)

    if initial_state is None:
        if theta0.dim() == 2:
            if theta0.shape[0] != n_chains:
                raise ValueError(
                    f"2-D theta0 warm start must have n_chains rows: got "
                    f"{theta0.shape[0]} rows for n_chains={n_chains}")
            x0 = space.clamp(theta0[offset:offset + B])
        else:
            x0 = theta0[None, :] + jitter * space.sigmas.to(dtype) * \
                draws.jitter()
            if offset == 0:
                x0[0] = theta0
            x0 = space.clamp(x0)
        eps0 = find_reasonable_epsilon(safe_vag, space, x0, space.sigmas,
                                       draws.eps_momentum())
        logp0, grad0 = safe_vag(x0)
        state = NUTSState(x0, logp0, grad0, eps0, torch.log(eps0),
                          torch.zeros(B, dtype=dtype, device=dev),
                          torch.log(10.0 * eps0), 0, x0, logp0)
    else:
        state = initial_state

    seg_len = -(-cfg.iterations // max(1, segments))
    xs_all, lps_all = [], []
    acc_sum = torch.zeros(B, dtype=dtype, device=dev)
    dep_sum = torch.zeros(B, dtype=dtype, device=dev)
    n_acc = 0
    for lo in range(state.it, cfg.iterations, seg_len):
        xs, lps = [], []
        for it in range(lo, min(lo + seg_len, cfg.iterations)):
            state, (x, lp, acc, dep) = nuts_iteration(
                state, draws.iteration(it), safe_vag, space, cfg)
            xs.append(x)
            lps.append(lp)
            acc_sum = acc_sum + acc
            dep_sum = dep_sum + dep
            n_acc += 1
        xs, lps = torch.stack(xs), torch.stack(lps)
        xs_all.append(xs)
        lps_all.append(lps)
        if on_segment is not None and on_segment(state, xs, lps):
            break               # early stop requested (e.g. gate met)
    if not xs_all:              # resume of an already-finished run
        xs_all = [torch.zeros((0, B, d), dtype=dtype, device=dev)]
        lps_all = [torch.zeros((0, B), dtype=dtype, device=dev)]
        n_acc = 1
    ids = offset + torch.arange(B, device=dev)
    best_x, best_logp = mesh.first_max(state.best_logp, state.best_x, ids)
    return NUTSResult(samples=mesh.all_gather(torch.cat(xs_all), dim=1),
                      sample_logps=mesh.all_gather(torch.cat(lps_all), dim=1),
                      best_x=best_x, best_logp=best_logp,
                      step_sizes=mesh.all_gather(state.eps),
                      mean_accept=mesh.all_gather(acc_sum / n_acc),
                      mean_depth=mesh.all_gather(dep_sum / n_acc))


def run_nuts_whitened(loglik_batch: Optional[Callable], space: ParameterSpace,
                      theta0: torch.Tensor, cfg: NUTSConfig, *, seed: int = 0,
                      n_chains: int = 1, jitter: float = 0.1,
                      value_and_grad_batch: Optional[Callable] = None,
                      segments: int = 1, draws=None,
                      chain_sharding=None) -> NUTSResult:
    """:func:`run_nuts` in sigma-whitened coordinates ``z = theta / sigmas``
    (a diagonal mass matrix ``diag(1 / sigmas**2)``). Samples and best_x
    come back in theta units; step_sizes stay in whitened units."""
    dtype = theta0.dtype
    s = space.sigmas.to(dtype)
    s = torch.where(s > 0, s, torch.ones_like(s))
    w_space = dataclasses.replace(space, lower=space.lower.to(dtype) / s,
                                  upper=space.upper.to(dtype) / s,
                                  sigmas=torch.ones_like(s))
    if value_and_grad_batch is None:
        value_and_grad_batch = value_and_grad_of(loglik_batch)

    def vag_z(zs):
        lp, g = value_and_grad_batch(zs * s)
        return lp, g * s

    res = run_nuts(None, w_space, theta0 / s, cfg, seed=seed,
                   n_chains=n_chains, jitter=jitter, value_and_grad_batch=vag_z,
                   segments=segments, draws=draws,
                   chain_sharding=chain_sharding)
    return res._replace(samples=res.samples * s, best_x=res.best_x * s)


def run_nuts_dense(loglik_batch: Optional[Callable], space: ParameterSpace,
                   cfg: NUTSConfig, *, mu: torch.Tensor, scale: torch.Tensor,
                   seed: int = 0, n_chains: int = 1, jitter: float = 1.0,
                   value_and_grad_batch: Optional[Callable] = None,
                   segments: int = 1, init: Optional[torch.Tensor] = None,
                   initial_state: Optional[NUTSState] = None,
                   on_segment: Optional[Callable] = None,
                   draws=None, chain_sharding=None) -> NUTSResult:
    """:func:`run_nuts` with a dense mass matrix: ``theta = mu + scale @ z``.

    ``z`` is sampled unbounded; the objective's REFLECT mode folds
    out-of-box excursions back in. Returned samples are reflected into the
    box in theta units; chains start at ``mu`` jittered by ``jitter``
    posterior stds, or at ``init`` (theta units)."""
    dtype, dev = mu.dtype, mu.device
    d = space.dim
    S = scale.to(dtype)
    inf = torch.full((d,), math.inf, dtype=dtype, device=dev)
    z_space = dataclasses.replace(space, lower=-inf, upper=inf,
                                  sigmas=torch.ones(d, dtype=dtype, device=dev))
    if value_and_grad_batch is None:
        value_and_grad_batch = value_and_grad_of(loglik_batch)

    def vag_z(zs):
        lp, g = value_and_grad_batch(mu[None, :] + zs @ S.T)
        return lp, g @ S

    if init is not None:
        z0 = torch.linalg.solve(S, (init.to(dtype) - mu[None, :]).T).T
    else:
        z0 = torch.zeros(d, dtype=dtype, device=dev)
    to_theta = lambda z: space.reflect(mu + z @ S.T)
    on_seg_z = None
    if on_segment is not None:
        on_seg_z = lambda st, xs, lps: on_segment(st, to_theta(xs), lps)
    res = run_nuts(None, z_space, z0, cfg, seed=seed, n_chains=n_chains,
                   jitter=jitter, value_and_grad_batch=vag_z,
                   segments=segments, initial_state=initial_state,
                   on_segment=on_seg_z, draws=draws,
                   chain_sharding=chain_sharding)
    return res._replace(samples=to_theta(res.samples),
                        best_x=space.reflect(mu + res.best_x @ S.T))


def logit_transform(theta, lower, upper, eps: float = 1e-6, power=1.0):
    """Box -> R^d: the power-logit bijection ``u = sigmoid(k*y)^(1/k)``
    inverted, ``y = log(u) - (1/k) log(1 - u^k)`` with ``u = (theta - lo) /
    width`` clipped ``eps`` of the width off each wall. NumPy/torch
    polymorphic."""
    if isinstance(theta, torch.Tensor):
        w = torch.clamp(upper - lower, min=1e-30)
        u = torch.clamp((theta - lower) / w, eps, 1.0 - eps)
        return torch.log(u) - torch.log1p(-(u ** power)) / power
    w = np.maximum(upper - lower, 1e-30)
    u = np.clip((theta - lower) / w, eps, 1.0 - eps)
    return np.log(u) - np.log1p(-(u ** power)) / power


def logit_vag_z(value_and_grad_batch: Callable, lo, width, mu, S, k):
    """``vag_z(zs) -> (logp + log|J|, grad_z)`` in the whitened power-logit
    coordinates of :func:`run_nuts_logit`: ``y = mu + S z``, ``theta = lo +
    width * sigmoid(k y)^(1/k)``, ``value_and_grad_batch`` at theta."""
    log_w_sum = torch.sum(torch.log(width))

    def vag_z(zs):
        ys = mu[None, :] + zs @ S.T
        u = torch.exp(F.logsigmoid(k * ys) / k)
        sig_m = torch.sigmoid(-k * ys)
        lp, g = value_and_grad_batch(lo[None, :] + width[None, :] * u)
        gy = g * (width[None, :] * u * sig_m) + (sig_m - k * torch.sigmoid(k * ys))
        return lp + (log_w_sum + torch.sum(F.logsigmoid(k * ys) / k
                                           + F.logsigmoid(-k * ys), dim=-1)), \
            gy @ S

    return vag_z


def run_nuts_logit(loglik_batch: Optional[Callable], space: ParameterSpace,
                   cfg: NUTSConfig, *, mu: torch.Tensor, scale: torch.Tensor,
                   seed: int = 0, n_chains: int = 1, jitter: float = 1.0,
                   value_and_grad_batch: Optional[Callable] = None,
                   segments: int = 1, init: Optional[torch.Tensor] = None,
                   initial_state: Optional[NUTSState] = None,
                   on_segment: Optional[Callable] = None,
                   power: Optional[torch.Tensor] = None,
                   draws=None, chain_sharding=None) -> NUTSResult:
    """:func:`run_nuts` in unconstrained power-logit coordinates with a dense
    mass (the sampler of the committed posterior, ``nuts_logit-dense``).

    ``theta = lo + width * sigmoid(k y)^(1/k)`` maps R^d onto the open box
    and the log-Jacobian joins the target, so the theta-marginal law is the
    bounded posterior. ``mu``/``scale``: dense mass in y-space (``y = mu +
    scale @ z``); ``init``: warm ensemble in theta units. Samples and best_x
    come back in theta units and ``sample_logps`` are the pure
    log-likelihood (Jacobian removed)."""
    dtype, dev = mu.dtype, mu.device
    d = space.dim
    lo = space.lower.to(dtype)
    width = torch.clamp(space.upper.to(dtype) - lo, min=1e-30)
    S = scale.to(dtype)
    k = torch.ones(d, dtype=dtype, device=dev) if power is None \
        else torch.as_tensor(power, dtype=dtype, device=dev)
    inf = torch.full((d,), math.inf, dtype=dtype, device=dev)
    z_space = dataclasses.replace(space, lower=-inf, upper=inf,
                                  sigmas=torch.ones(d, dtype=dtype, device=dev))
    if value_and_grad_batch is None:
        value_and_grad_batch = value_and_grad_of(loglik_batch)
    log_w_sum = torch.sum(torch.log(width))

    # u = sigmoid(k y)^(1/k); du/dy = u sigmoid(-k y);
    # log|J| = log w + log_sigmoid(k y)/k + log_sigmoid(-k y)
    def u_of(ys):
        return torch.exp(F.logsigmoid(k * ys) / k)

    def log_jac(ys):
        return log_w_sum + torch.sum(F.logsigmoid(k * ys) / k
                                     + F.logsigmoid(-k * ys), dim=-1)

    vag_z = logit_vag_z(value_and_grad_batch, lo, width, mu, S, k)

    if init is not None:
        y0 = logit_transform(init.to(dtype), lo, width + lo, power=k)
        z0 = torch.linalg.solve(S, (y0 - mu[None, :]).T).T
    else:
        z0 = torch.zeros(d, dtype=dtype, device=dev)

    def to_theta(z):
        return lo + width * u_of(mu + z @ S.T)

    def pure_lp(theta, lp_with_jac):
        """Strip the Jacobian using theta only."""
        return lp_with_jac - log_jac(logit_transform(theta, lo, width + lo,
                                                     power=k))

    on_seg_z = None
    if on_segment is not None:
        def on_seg_z(st, xs, lps):
            th = to_theta(xs)
            return on_segment(st, th, pure_lp(th, lps))

    res = run_nuts(None, z_space, z0, cfg, seed=seed, n_chains=n_chains,
                   jitter=jitter, value_and_grad_batch=vag_z,
                   segments=segments, initial_state=initial_state,
                   on_segment=on_seg_z, draws=draws,
                   chain_sharding=chain_sharding)
    th_samples = to_theta(res.samples)
    th_best = to_theta(res.best_x[None, :])
    return res._replace(samples=th_samples,
                        sample_logps=pure_lp(th_samples, res.sample_logps),
                        best_x=th_best[0],
                        best_logp=pure_lp(th_best, res.best_logp[None])[0])
