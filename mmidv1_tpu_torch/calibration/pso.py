"""Particle Swarm Optimization, whole-swarm batched.

Port of ``mmidv1_tpu/calibration/pso.py``, re-design of
``ParticleSwarmOptimization`` (reference:
``src/model/optimizers/ParticleSwarmOptimizer.cpp``). One iteration updates the
entire swarm with batched tensor ops and one batched objective call.

Ported (same math, reference line refs):
- variants STANDARD and ADAPTIVE: the velocity update + vmax clamp +
  reflective boundary handling with velocity dampening (:575-618)
- topologies GLOBAL_BEST / LOCAL_BEST ring(k=2) / VON_NEUMANN grid /
  RANDOM_DYNAMIC (:836-906), as static neighbour tables or per-iteration draws
- evolutionary-state estimation and the four omega/c1/c2 regimes (:427-525)
- opposition-based initialization (:527-574)
- elitist learning: Gaussian polish of the best particle every 5 iterations
  (ADAPTIVE), its three sigma-halved probes in one batch (:706-740)
- stagnation-triggered restart keeping the elite particles (:742-814)
- pbest covariance exported as ``final_cov`` for the Phase-2 MCMC warm start

QUANTUM, LEVY_FLIGHT and HYBRID raise ``NotImplementedError``: they belong
to a later slice of the port.

Random draws: the step functions take their draws as tensors (``PSODraws``,
``RestartDraws``, the elitist ``noise``); :func:`run_pso` makes them from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .param_space import ParameterSpace


class PSOVariant(enum.IntEnum):
    STANDARD = 0
    QUANTUM = 1
    ADAPTIVE = 2
    LEVY_FLIGHT = 3
    HYBRID = 4


class Topology(enum.IntEnum):
    GLOBAL_BEST = 0
    LOCAL_BEST = 1
    VON_NEUMANN = 2
    RANDOM_DYNAMIC = 3


_PORTED_VARIANTS = (PSOVariant.STANDARD, PSOVariant.ADAPTIVE)


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Settings mirror ``pso_settings.txt`` / ``configure`` (:10-103)."""

    iterations: int = 100
    swarm_size: int = 64
    omega_start: float = 0.9
    omega_end: float = 0.4
    c1_initial: float = 2.0
    c1_final: float = 0.5
    c2_initial: float = 0.5
    c2_final: float = 2.0
    variant: PSOVariant = PSOVariant.STANDARD
    topology: Topology = Topology.GLOBAL_BEST
    use_opposition_learning: bool = True
    use_adaptive_parameters: bool = True
    restart_threshold: float = 1e-6
    max_stagnation: int = 20
    elite_count: int = 3

    @classmethod
    def from_settings(cls, s: dict) -> "PSOConfig":
        g = s.get
        return cls(
            iterations=int(g("iterations", 100)),
            swarm_size=int(g("swarm_size", 64)),
            omega_start=float(g("omega_start", 0.9)),
            omega_end=float(g("omega_end", 0.4)),
            c1_initial=float(g("c1_initial", 2.0)),
            c1_final=float(g("c1_final", 0.5)),
            c2_initial=float(g("c2_initial", 0.5)),
            c2_final=float(g("c2_final", 2.0)),
            variant=PSOVariant(int(g("variant", 0))),
            topology=Topology(int(g("topology", 0))),
            use_opposition_learning=bool(g("use_opposition_learning", 1.0)),
            use_adaptive_parameters=bool(g("use_adaptive_parameters", 1.0)),
            restart_threshold=float(g("restart_threshold", 1e-6)),
            max_stagnation=int(g("max_stagnation", 20)),
            # beyond-reference convenience: the reference hard-codes
            # keep_best_count = 3 (ParticleSwarmOptimizer.hpp:509)
            elite_count=int(g("elite_count", 3)),
        )


class PSOState(NamedTuple):
    x: torch.Tensor            # (S, d)
    v: torch.Tensor            # (S, d)
    fitness: torch.Tensor      # (S,) current fitness
    pbest_x: torch.Tensor      # (S, d)
    pbest_f: torch.Tensor      # (S,)
    success_count: torch.Tensor  # (S,)
    total_updates: torch.Tensor  # (S,)
    gbest_x: torch.Tensor      # (d,)
    gbest_f: torch.Tensor      # ()
    prev_gbest_f: torch.Tensor  # ()
    stagnation: int
    evals: int                 # objective-call counter


class PSOResult(NamedTuple):
    best_x: torch.Tensor
    best_f: torch.Tensor
    final_cov: torch.Tensor      # pbest covariance for Phase-2 warm start
    history_best_f: torch.Tensor  # (iterations,)
    final_state: PSOState


class PSODraws(NamedTuple):
    """The random numbers of one :func:`pso_step`."""
    u: torch.Tensor                   # (3,) uniforms of the adaptive regime
    r1: torch.Tensor                  # (S, d) cognitive uniforms
    r2: torch.Tensor                  # (S, d) social uniforms
    neighbours: Optional[torch.Tensor] = None   # (S, 4) RANDOM_DYNAMIC picks


class RestartDraws(NamedTuple):
    """The random numbers of one :func:`_restart_swarm`."""
    assign: torch.Tensor     # (S,) int in [0, elite_count)
    u_sigma: torch.Tensor    # (S, d) uniforms
    z: torch.Tensor          # (S, d) normals
    u_unif: torch.Tensor     # (S, d) uniforms
    u_pick: torch.Tensor     # (S, d) uniforms
    u_v: torch.Tensor        # (S, d) uniforms


def _check_variant(cfg: PSOConfig):
    if cfg.variant not in _PORTED_VARIANTS:
        raise NotImplementedError(
            f"PSO variant {cfg.variant.name}: only STANDARD and ADAPTIVE are "
            "ported; QUANTUM, LEVY_FLIGHT and HYBRID come in a later slice")


def _neighbor_table(cfg: PSOConfig) -> Optional[np.ndarray]:
    """Static neighbor index table (S, K), padded with self-index."""
    S = cfg.swarm_size
    if cfg.topology == Topology.LOCAL_BEST:
        k = 2
        tab = np.empty((S, 2 * k + 1), dtype=np.int64)
        for i in range(S):
            tab[i] = [i] + [((i - j) % S) for j in range(1, k + 1)] + \
                     [((i + j) % S) for j in range(1, k + 1)]
        return tab
    if cfg.topology == Topology.VON_NEUMANN:
        g = int(math.ceil(math.sqrt(S)))
        tab = np.empty((S, 5), dtype=np.int64)
        for i in range(S):
            row, col = divmod(i, g)
            neigh = [i]
            if row > 0 and (row - 1) * g + col < S:
                neigh.append((row - 1) * g + col)
            if row < g - 1 and (row + 1) * g + col < S:
                neigh.append((row + 1) * g + col)
            if col > 0:
                neigh.append(row * g + col - 1)
            if col < g - 1 and row * g + col + 1 < S:
                neigh.append(row * g + col + 1)
            while len(neigh) < 5:
                neigh.append(i)
            tab[i] = neigh
        return tab
    return None


def _evolutionary_factor(state: PSOState) -> torch.Tensor:
    """Swarm-distance + fitness-dispersion factor (:446-479)."""
    dist = torch.linalg.vector_norm(state.x - state.gbest_x[None, :], dim=1)
    mean_d, max_d = torch.mean(dist), torch.max(dist)
    distance_factor = torch.where(max_d > 0, mean_d / max_d,
                                  torch.zeros_like(max_d))
    # floor infeasible fitness (the objective returns finfo.min there)
    # before the dispersion stats: two or more finfo.min entries overflow
    # the mean to -inf and pin the regime at "jumping out" for the whole run
    f = torch.maximum(state.fitness, torch.full_like(state.fitness, -1e18))
    mean_f, max_f, min_f = torch.mean(f), torch.max(f), torch.min(f)
    f_range = torch.clamp_min(max_f - min_f, 1e-10)
    fitness_factor = (max_f - mean_f) / f_range
    return 0.5 * distance_factor + 0.5 * (1.0 - fitness_factor)


def _adapt_parameters(factor: torch.Tensor, ratio: float, u: torch.Tensor):
    """omega/c1/c2 per evolutionary state (:481-525), given three uniforms
    ``u``. Returns 0-d tensors."""
    s0, s1, s2 = factor > 0.7, factor > 0.4, factor > 0.2
    u1, u2, u3 = u.unbind(0)
    sin_r = math.sin(ratio * math.pi)

    def select(v0, v1, v2, v3):
        t = lambda v: torch.as_tensor(v, dtype=u.dtype, device=u.device)
        return torch.where(s0, t(v0), torch.where(s1, t(v1),
                                                  torch.where(s2, t(v2), t(v3))))

    omega = select(0.9 - 0.2 * ratio, 0.7 - 0.3 * ratio, 0.4 - 0.3 * ratio,
                   0.9 + 0.1 * u1)
    c1 = select(1.5 + 0.5 * sin_r, 2.0 - ratio, 1.0 - 0.5 * ratio, 2.5 + u2)
    c2 = select(1.5 - 0.5 * sin_r, 1.0 + ratio, 2.0 + 0.5 * ratio, 0.5 + u3)
    return (torch.clamp(omega, 0.1, 1.0), torch.clamp(c1, 0.0, 4.0),
            torch.clamp(c2, 0.0, 4.0))


def _standard_update(x, v, pbest_x, lbest_x, omega, c1, c2, lo, hi, r1, r2):
    v_new = omega * v + c1 * r1 * (pbest_x - x) + c2 * r2 * (lbest_x - x)
    vmax = 0.2 * (hi - lo)
    v_new = torch.clamp(v_new, -vmax, vmax)
    x_new = x + v_new
    # Reflective boundary handling with velocity dampening (:606-617)
    below, above = x_new < lo, x_new > hi
    x_new = torch.where(below, lo + torch.abs(x_new - lo), x_new)
    x_new = torch.where(above, hi - torch.abs(x_new - hi), x_new)
    v_new = torch.where(below | above, v_new * -0.5, v_new)
    return torch.clamp(x_new, lo, hi), v_new


def _bounds(space: ParameterSpace, dtype):
    return space.lower.to(dtype), space.upper.to(dtype)


def pso_step(state: PSOState, draws: PSODraws, it: int, cfg: PSOConfig,
             space: ParameterSpace, fitness_batch: Callable,
             neighbor_tab: Optional[np.ndarray]) -> PSOState:
    """One swarm update + evaluation (STANDARD and ADAPTIVE variants)."""
    _check_variant(cfg)
    S, d = state.x.shape
    dtype, dev = state.x.dtype, state.x.device
    lo, hi = _bounds(space, dtype)
    ratio = it / max(cfg.iterations - 1, 1) if cfg.iterations > 1 else 0.0

    if cfg.use_adaptive_parameters:
        omega, c1, c2 = _adapt_parameters(_evolutionary_factor(state), ratio,
                                          draws.u)
    else:
        omega = cfg.omega_start + (cfg.omega_end - cfg.omega_start) * ratio
        c1 = cfg.c1_initial + (cfg.c1_final - cfg.c1_initial) * ratio
        c2 = cfg.c2_initial + (cfg.c2_final - cfg.c2_initial) * ratio

    if cfg.topology == Topology.GLOBAL_BEST:
        lbest_x = state.gbest_x.expand(S, d)
    else:
        if cfg.topology == Topology.RANDOM_DYNAMIC:
            tab = torch.cat([torch.arange(S, device=dev)[:, None],
                             draws.neighbours.to(dev)], dim=1)
        else:
            tab = torch.as_tensor(neighbor_tab, device=dev)
        best = torch.argmax(state.pbest_f[tab], dim=1)
        lbest_x = state.pbest_x[torch.gather(tab, 1, best[:, None])[:, 0]]

    x_new, v_new = _standard_update(state.x, state.v, state.pbest_x, lbest_x,
                                    omega, c1, c2, lo, hi, draws.r1, draws.r2)

    f_new = fitness_batch(x_new)
    improved = f_new > state.pbest_f
    pbest_x = torch.where(improved[:, None], x_new, state.pbest_x)
    pbest_f = torch.where(improved, f_new, state.pbest_f)
    best_i = torch.argmax(pbest_f)
    gbest_f = torch.maximum(state.gbest_f, pbest_f[best_i])
    gbest_x = torch.where(pbest_f[best_i] > state.gbest_f, pbest_x[best_i],
                          state.gbest_x)
    return state._replace(
        x=x_new, v=v_new, fitness=f_new, pbest_x=pbest_x, pbest_f=pbest_f,
        success_count=state.success_count + improved.to(torch.int32),
        total_updates=state.total_updates + 1,
        gbest_x=gbest_x, gbest_f=gbest_f, evals=state.evals + S)


def _elitist_learning(state: PSOState, noise: torch.Tensor, cfg: PSOConfig,
                      space: ParameterSpace, fitness_batch) -> PSOState:
    """Gaussian polish of the best particle (:706-740), batched over the three
    sigma-halved attempts; ``noise`` is ``(3, d)`` standard normals."""
    dtype = state.x.dtype
    lo, hi = _bounds(space, dtype)
    best_i = torch.argmax(state.pbest_f)
    bx = state.pbest_x[best_i]
    bf = state.pbest_f[best_i]
    success_rate = (state.success_count[best_i].to(dtype) /
                    torch.clamp_min(state.total_updates[best_i], 1).to(dtype))
    sigma0 = 0.1 * torch.exp(-2.0 * success_rate)
    sigmas = sigma0 * torch.tensor([1.0, 0.5, 0.25], dtype=dtype,
                                   device=bx.device)
    trials = torch.clamp(bx[None, :] + sigmas[:, None] * (hi - lo) * noise, lo, hi)
    tf = fitness_batch(trials)
    # first improving attempt (sequential short-circuit semantics)
    improving = tf > bf
    any_improve = torch.any(improving)
    first = torch.argmax(improving.to(torch.int32))
    new_x = torch.where(any_improve, trials[first], bx)
    new_f = torch.where(any_improve, tf[first], bf)

    pbest_x = state.pbest_x.clone()
    pbest_x[best_i] = new_x
    pbest_f = state.pbest_f.clone()
    pbest_f[best_i] = new_f
    x = state.x.clone()
    x[best_i] = torch.where(any_improve, new_x, state.x[best_i])
    gbest_f = torch.maximum(state.gbest_f, new_f)
    gbest_x = torch.where(new_f > state.gbest_f, new_x, state.gbest_x)
    return state._replace(x=x, pbest_x=pbest_x, pbest_f=pbest_f,
                          gbest_x=gbest_x, gbest_f=gbest_f,
                          evals=state.evals + 3)


def _restart_swarm(state: PSOState, draws: RestartDraws, cfg: PSOConfig,
                   space: ParameterSpace, fitness_batch) -> PSOState:
    """Stagnation restart keeping the elite particles (:742-814)."""
    S, d = state.x.shape
    dtype = state.x.dtype
    lo, hi = _bounds(space, dtype)
    order = torch.argsort(-state.pbest_f, stable=True)
    elite_idx = order[:cfg.elite_count]
    is_elite = torch.zeros(S, dtype=torch.bool, device=state.x.device)
    is_elite[elite_idx] = True

    # re-seed non-elites: 70% around a random elite, 30% uniform (:778-795)
    anchor = state.pbest_x[elite_idx][draws.assign]            # (S, d)
    sigma = 0.3 * (hi - lo) * (1.0 + 0.5 * draws.u_sigma)
    x_near = anchor + sigma * draws.z
    x_unif = lo + draws.u_unif * (hi - lo)
    pick_near = draws.u_pick < 0.7
    x_new = torch.clamp(torch.where(pick_near, x_near, x_unif), lo, hi)
    vmax = 0.2 * (hi - lo)
    v_new = -vmax + 2 * vmax * draws.u_v

    x = torch.where(is_elite[:, None], state.x, x_new)
    v = torch.where(is_elite[:, None], state.v, v_new)
    f = fitness_batch(x)
    f = torch.where(is_elite, state.fitness, f)
    pbest_x = torch.where(is_elite[:, None], state.pbest_x, x)
    pbest_f = torch.where(is_elite, state.pbest_f, f)
    zero = torch.zeros_like(state.success_count)
    return state._replace(
        x=x, v=v, fitness=f, pbest_x=pbest_x, pbest_f=pbest_f,
        success_count=torch.where(is_elite, state.success_count, zero),
        total_updates=torch.where(is_elite, state.total_updates, zero),
        stagnation=0, evals=state.evals + S)


def init_pso_state(space: ParameterSpace, cfg: PSOConfig, fitness_batch,
                   u_x: torch.Tensor, u_v: torch.Tensor,
                   theta0: Optional[torch.Tensor] = None) -> PSOState:
    """Uniform swarm (``u_x``, ``u_v`` are ``(S, d)`` uniforms); particle 0
    sits at ``theta0`` when given; opposition-based selection (:527-574)."""
    S = cfg.swarm_size
    dtype, dev = u_x.dtype, u_x.device
    lo, hi = _bounds(space, dtype)
    x = lo + u_x * (hi - lo)
    if theta0 is not None:
        x[0] = torch.clamp(theta0.to(dtype), lo, hi)
    if cfg.use_opposition_learning:
        # evaluate each particle and its opposite, keep the better
        x_opp = lo + hi - x
        f = fitness_batch(x)
        f_opp = fitness_batch(x_opp)
        take_opp = f_opp > f
        if theta0 is not None:
            take_opp[0] = False
        x = torch.where(take_opp[:, None], x_opp, x)
        f = torch.where(take_opp, f_opp, f)
        evals = 2 * S
    else:
        f = fitness_batch(x)
        evals = S
    vmax = 0.2 * (hi - lo)
    v = -vmax + 2 * vmax * u_v
    best_i = torch.argmax(f)
    zeros = torch.zeros(S, dtype=torch.int32, device=dev)
    return PSOState(
        x=x, v=v, fitness=f, pbest_x=x, pbest_f=f,
        success_count=zeros, total_updates=zeros,
        gbest_x=x[best_i], gbest_f=f[best_i],
        prev_gbest_f=torch.tensor(-math.inf, dtype=dtype, device=dev),
        stagnation=0, evals=evals)


def run_pso(loglik_batch: Callable, space: ParameterSpace, cfg: PSOConfig, *,
            generator: torch.Generator, theta0: Optional[torch.Tensor] = None,
            dtype: Optional[torch.dtype] = None,
            initial_state: Optional[PSOState] = None) -> PSOResult:
    """Run PSO; the objective ``loglik_batch((S, d)) -> (S,)`` is maximized.
    Every draw comes from ``generator`` (on the space's device).
    ``initial_state`` skips swarm initialization (resume)."""
    _check_variant(cfg)
    dtype = dtype or space.dtype
    dev = space.device
    S, d = cfg.swarm_size, space.dim
    neighbor_tab = _neighbor_table(cfg)
    rand = lambda *shape: torch.rand(shape, generator=generator, dtype=dtype,
                                     device=dev)
    randn = lambda *shape: torch.randn(shape, generator=generator, dtype=dtype,
                                       device=dev)
    if initial_state is not None:
        state = initial_state
    else:
        state = init_pso_state(space, cfg, loglik_batch, rand(S, d), rand(S, d),
                               theta0)

    hist = []
    for it in range(cfg.iterations):
        # stagnation bookkeeping + restart (:254-268); one host read per
        # iteration decides the branch
        stagnant = bool(torch.abs(state.gbest_f - state.prev_gbest_f)
                        < cfg.restart_threshold)
        state = state._replace(
            stagnation=state.stagnation + 1 if stagnant else 0,
            prev_gbest_f=state.gbest_f)
        if state.stagnation > cfg.max_stagnation:
            rd = RestartDraws(
                assign=torch.randint(0, cfg.elite_count, (S,),
                                     generator=generator, device=dev),
                u_sigma=rand(S, d), z=randn(S, d), u_unif=rand(S, d),
                u_pick=rand(S, d), u_v=rand(S, d))
            state = _restart_swarm(state, rd, cfg, space, loglik_batch)

        draws = PSODraws(
            u=rand(3), r1=rand(S, d), r2=rand(S, d),
            neighbours=(torch.randint(0, S, (S, 4), generator=generator,
                                      device=dev)
                        if cfg.topology == Topology.RANDOM_DYNAMIC else None))
        state = pso_step(state, draws, it, cfg, space, loglik_batch,
                         neighbor_tab)
        if cfg.variant == PSOVariant.ADAPTIVE and it % 5 == 0:
            state = _elitist_learning(state, randn(3, d), cfg, space,
                                      loglik_batch)
        hist.append(state.gbest_f)

    centered = state.pbest_x - torch.mean(state.pbest_x, dim=0)
    cov = (centered.T @ centered) / max(cfg.swarm_size - 1, 1)
    return PSOResult(best_x=state.gbest_x, best_f=state.gbest_f, final_cov=cov,
                     history_best_f=torch.stack(hist) if hist else
                     state.gbest_f.new_zeros(0),
                     final_state=state)
