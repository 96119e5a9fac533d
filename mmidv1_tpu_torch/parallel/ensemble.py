"""Ensemble MCMC and PSO with the chain axis split over ranks.

Port of ``mmidv1_tpu/parallel/ensemble.py``. The JAX package runs its
samplers on a device mesh in two styles, ``shard_map`` with hand-placed
collectives (``run_mh_sharded``) and GSPMD (the ``*_gspmd`` runners and
``run_pso_sharded``). Here both are one implementation: each rank of a
``torch.distributed`` process group (:mod:`.mesh`) runs the sampler on its
block of chains, through its own objective calls (K1, or K2 + K3 for the
gradient samplers), and the samplers' own ``mesh`` / ``chain_sharding``
hooks put a collective where the JAX package reduces across the mesh:

- AM-MH / DE-MC (:mod:`..calibration.mh`): the covariance moments, DE's
  walker table, the global MAP;
- parallel tempering (:mod:`..calibration.tempering`): the swap rates'
  chain mean and counters, the per-rung covariance, the MAP;
- MALA: the preconditioner's moments and the MAP; NUTS: the MAP alone.

Every draw comes from a table made for the GLOBAL ensemble, of which each
rank takes its rows (:class:`..calibration.draws.ShardDraws`), so a sharded
run gives the unsharded run's samples up to the order of those sums, and on
one rank the same bits.

``n_chains`` is the global chain count (a rung's, for PT) and must divide
over the ranks. Results carry the global ``samples``, ``sample_logps``,
acceptance and step sizes, gathered on every rank, as the JAX runners'
``out_specs`` give them; a ``final_state`` stays this rank's, to pass back
as ``initial_state``. These runners write no file: where a caller writes
one, rank 0 alone should (:func:`.multihost.is_primary`).

The calibration modules import :mod:`.mesh`, so this module imports them
where it uses them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh import check_divisible, ensemble_mesh

# Chain-batched fields of each sampler state (every other field -- the
# covariance factors, the counters -- is whole on every rank). By NAME, not
# by shape: a shape rule splits the (d, d) covariance whenever d equals the
# chain count. PT's are split along dim 1 (its (K, N, ...) chain axis).
_MH_BATCH_FIELDS = ("x", "logp", "log_scale", "best_x", "best_logp",
                    "accept_count")
_PSO_BATCH_FIELDS = ("x", "v", "fitness", "pbest_x", "pbest_f",
                     "success_count", "total_updates")
_MALA_BATCH_FIELDS = ("x", "logp", "grad", "log_eps", "best_x", "best_logp",
                      "accept_count")
_PT_BATCH_FIELDS = ("x", "logp", "log_scale", "best_x", "best_logp",
                    "accept_count")


def _mesh_for(mesh, n: int, what: str, device):
    mesh = ensemble_mesh(device=device) if mesh is None else mesh
    check_divisible(n, mesh, what)
    return mesh


def run_mh_sharded(loglik_batch: Callable, space, theta0: torch.Tensor, cfg,
                   *, n_chains: int, mesh=None,
                   generator: Optional[torch.Generator] = None, draws=None,
                   initial_cov: Optional[torch.Tensor] = None,
                   initial_state=None, jitter: float = 1.0,
                   progress_fn: Optional[Callable] = None):
    """Ensemble adaptive Metropolis (or DE-MC, ``cfg.proposal="de"``) over
    the ranks of ``mesh`` (default: :func:`.mesh.ensemble_mesh`).

    Every rank passes the same arguments: ``generator`` seeded alike (or
    the same ``draws`` source, made for ``n_chains`` chains). Each rank
    evaluates ``loglik_batch`` (e.g. :func:`mmidv1_tpu_torch.ops.
    build_objective_fused`) on its ``n_chains / W`` chains.
    ``initial_state`` resumes from this rank's ``final_state`` of an
    earlier sharded run. ``progress_fn``, if given, must be given on every
    rank (its numbers are reduced over ranks)."""
    from ..calibration.mh import run_mh

    mesh = _mesh_for(mesh, n_chains, "n_chains", theta0.device)
    return run_mh(loglik_batch, space, theta0, cfg, generator=generator,
                  n_chains=n_chains, initial_cov=initial_cov,
                  initial_state=initial_state, jitter=jitter,
                  progress_fn=progress_fn, draws=draws, mesh=mesh)


def run_mh_gspmd(loglik_batch: Callable, space, theta0: torch.Tensor, cfg, *,
                 n_chains: int, mesh=None,
                 generator: Optional[torch.Generator] = None, draws=None,
                 initial_cov: Optional[torch.Tensor] = None,
                 jitter: float = 1.0):
    """The JAX package's GSPMD entry: here the same run as
    :func:`run_mh_sharded` (one implementation serves both styles)."""
    return run_mh_sharded(loglik_batch, space, theta0, cfg,
                          n_chains=n_chains, mesh=mesh, generator=generator,
                          draws=draws, initial_cov=initial_cov, jitter=jitter)


def shard_batch(fn: Callable, mesh) -> Callable:
    """``fn`` over a ``(n, d)`` batch with each rank evaluating its
    ``n / W`` rows and the values all-gathered, the same on every rank; a
    batch that does not divide over the ranks (PSO's 3-point elitist probe)
    is evaluated whole on every rank."""

    def sharded(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if mesh.world_size == 1 or n % mesh.world_size:
            return fn(x)
        n_local = n // mesh.world_size
        return mesh.all_gather(fn(x[mesh.rank * n_local:
                                    (mesh.rank + 1) * n_local]))

    return sharded


def run_pso_sharded(loglik_batch: Callable, space, cfg, *,
                    generator: torch.Generator,
                    theta0: Optional[torch.Tensor] = None, mesh=None,
                    dtype: Optional[torch.dtype] = None):
    """PSO with the swarm's fitness evaluations split over the ranks of
    ``mesh``: each rank evaluates its ``swarm_size / W`` particles and the
    values are all-gathered; the swarm update (the evolutionary factor over
    every pairwise distance, the ring and Von Neumann neighbours across the
    blocks, elitist learning and restarts) then runs whole and identically
    on every rank, from ``generator`` seeded alike on each. That is the
    exact counterpart of the JAX package's GSPMD swarm, in which XLA gathers
    for those same swarm-wide parts."""
    from ..calibration.pso import run_pso

    mesh = _mesh_for(mesh, cfg.swarm_size, "swarm_size", space.device)
    return run_pso(shard_batch(loglik_batch, mesh), space, cfg,
                   generator=generator, theta0=theta0, dtype=dtype)


def run_pt_gspmd(loglik_batch: Callable, space, theta0: torch.Tensor, cfg, *,
                 n_chains: int, mesh=None,
                 generator: Optional[torch.Generator] = None,
                 initial_cov: Optional[torch.Tensor] = None,
                 jitter: float = 1.0):
    """Replica exchange with each rung's ``n_chains`` chains split over the
    ranks of ``mesh``; every rank holds all ``cfg.n_rungs`` rungs of its
    chains (one objective call over ``K * n_chains / W`` rows a step)."""
    from ..calibration.tempering import run_pt

    mesh = _mesh_for(mesh, n_chains, "n_chains", theta0.device)
    return run_pt(loglik_batch, space, theta0, cfg, generator=generator,
                  n_chains=n_chains, initial_cov=initial_cov, jitter=jitter,
                  mesh=mesh)


def run_nuts_gspmd(loglik_batch: Optional[Callable], space,
                   theta0: torch.Tensor, cfg, *, n_chains: int, mesh=None,
                   seed: int = 0, jitter: float = 0.1,
                   value_and_grad_batch: Optional[Callable] = None):
    """Batch-native NUTS with the chains split over the ranks of ``mesh``
    (``run_nuts(chain_sharding=mesh)``): each rank runs the K2 / K3 engine
    (``value_and_grad_batch``) on its chains; only the best-chain argmax
    crosses ranks."""
    from ..calibration.nuts import run_nuts

    mesh = _mesh_for(mesh, n_chains, "n_chains", theta0.device)
    return run_nuts(loglik_batch, space, theta0, cfg, seed=seed,
                    n_chains=n_chains, jitter=jitter,
                    value_and_grad_batch=value_and_grad_batch,
                    chain_sharding=mesh)


def run_nuts_logit_gspmd(loglik_batch: Optional[Callable], space, cfg, *,
                         mu: torch.Tensor, scale: torch.Tensor,
                         n_chains: int, mesh=None, seed: int = 0,
                         jitter: float = 1.0,
                         value_and_grad_batch: Optional[Callable] = None,
                         init: Optional[torch.Tensor] = None):
    """Logit-space dense-mass NUTS (the Spain-2020 production sampler,
    :func:`mmidv1_tpu_torch.calibration.nuts.run_nuts_logit`) with the
    chains split over the ranks of ``mesh``: the transform, its Jacobian
    and the mass products are chain by chain, so as for
    :func:`run_nuts_gspmd` only the best-chain argmax crosses ranks.
    ``init`` is the whole warm ensemble (``n_chains`` rows)."""
    from ..calibration.nuts import run_nuts_logit

    mesh = _mesh_for(mesh, n_chains, "n_chains", mu.device)
    return run_nuts_logit(loglik_batch, space, cfg, mu=mu, scale=scale,
                          seed=seed, n_chains=n_chains, jitter=jitter,
                          value_and_grad_batch=value_and_grad_batch,
                          init=init, chain_sharding=mesh)


def run_mala_gspmd(loglik_batch: Optional[Callable], space,
                   theta0: torch.Tensor, cfg, *, n_chains: int, mesh=None,
                   generator: Optional[torch.Generator] = None,
                   initial_cov: Optional[torch.Tensor] = None,
                   jitter: float = 1.0,
                   value_and_grad_batch: Optional[Callable] = None):
    """Ensemble preconditioned MALA with the chains split over the ranks of
    ``mesh``: the drift, proposal densities and accept/reject are chain by
    chain; the preconditioner's moments are summed over ranks."""
    from ..calibration.mala import run_mala

    mesh = _mesh_for(mesh, n_chains, "n_chains", theta0.device)
    return run_mala(loglik_batch, space, theta0, cfg, generator=generator,
                    n_chains=n_chains, initial_cov=initial_cov, jitter=jitter,
                    value_and_grad_batch=value_and_grad_batch, mesh=mesh)
