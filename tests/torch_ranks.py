"""Rank-side code of the port's multi-process tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_multihost.py`` spawn
``gloo`` ranks on the CPU with :func:`spawn`; each rank runs a list of tasks
(module-level functions, so that the spawn method can pickle them) on its
:class:`~mmidv1_tpu_torch.parallel.EnsembleMesh` and writes what they return
to a file the parent reads. The parent runs the same task with ``mesh=None``
for the unsharded reference. This module imports no JAX: a rank starts from
a fresh interpreter and needs only the port.

The ranks rendezvous through a ``file://`` store in the test's ``tmp_path``
(no TCP port, so parallel test workers cannot collide), every collective has
the process group's 60 s timeout, and the parent joins with its own timeout
and terminates what is left.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch

F64 = torch.float64


# ---------------------------------------------------------------- spawning

def spawn(world, tasks, workdir, timeout=45.0, init="gloo"):
    """Run ``tasks`` (a list of ``(fn, kwargs)``) on ``world`` spawned
    ranks; returns, for each rank, the list of ``fn(mesh, **kwargs)``
    results. ``init="multihost"`` starts the group with
    ``parallel.multihost.initialize`` instead, and each rank's list then
    starts with what ``initialize`` returned."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store_{time.monotonic_ns()}")
    outs = [os.path.join(workdir, f"rank{r}_{os.path.basename(store)}.pkl")
            for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, tasks, outs[r], init))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)
    results, errors = [], []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit code "
                          f"{procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            status, payload = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r}:\n{payload}")
        results.append(payload)
    if hung:
        errors.insert(0, f"ranks {hung} still running after {timeout} s")
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def _rank_main(rank, world, store, tasks, out, init):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from mmidv1_tpu_torch.parallel import ensemble_mesh, multihost

    status, payload = "error", "not started"
    try:
        timeout = datetime.timedelta(seconds=60)
        head = []
        if init == "multihost":
            head = [multihost.initialize(
                f"file://{store}", world, rank, backend="gloo", device="cpu",
                timeout=timeout)]
        else:
            dist.init_process_group(init, init_method=f"file://{store}",
                                    rank=rank, world_size=world,
                                    timeout=timeout)
        mesh = ensemble_mesh(device="cpu")
        status, payload = "ok", head + [fn(mesh, **kw) for fn, kw in tasks]
    except BaseException:          # reported to the parent, which fails
        payload = traceback.format_exc()
    finally:
        with open(out + ".tmp", "wb") as f:
            pickle.dump((status, payload), f)
        os.replace(out + ".tmp", out)
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(0 if status == "ok" else 1)


# ---------------------------------------------------------------- problems

class GaussianLoglik:
    """A batched Gaussian log-density ``(B, d) -> (B,)``."""

    def __init__(self, mu, sd):
        self.mu = torch.as_tensor(mu, dtype=F64)
        self.sd = torch.as_tensor(sd, dtype=F64)

    def __call__(self, x):
        return -0.5 * torch.sum(((x - self.mu) / self.sd) ** 2, dim=-1)


def box_space(names, lo, hi, sigma):
    from mmidv1_tpu_torch.calibration.param_space import ParameterSpace

    d = len(names)
    return ParameterSpace(names=tuple(names),
                          lower=torch.full((d,), lo, dtype=F64),
                          upper=torch.full((d,), hi, dtype=F64),
                          sigmas=torch.full((d,), sigma, dtype=F64),
                          _scatter={})


def gaussian_problem(d=3):
    """``tests/test_parallel.py``'s targets: the 3-d Gaussian, or the 8-d
    one whose dimension equals the chain count of its tests."""
    if d == 3:
        ll = GaussianLoglik([0.3, -0.2, 0.5], [0.5, 0.3, 0.8])
    else:
        ll = GaussianLoglik(np.linspace(-0.4, 0.4, d), np.ones(d))
    return ll, box_space([f"x{i}" for i in range(d)], -5.0, 5.0, 0.3)


def _np(res, fields):
    return {f: getattr(res, f).detach().cpu().numpy() for f in fields}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------- tasks
# Each task runs the unsharded runner for mesh=None, the sharded one
# otherwise, from the same global draws.

def task_mh(mesh, proposal="am", iterations=120, seed=7, n_chains=16):
    """Also the progress numbers, every 5 blocks."""
    from mmidv1_tpu_torch.calibration.mh import MHConfig, run_mh
    from mmidv1_tpu_torch.parallel import run_mh_sharded

    ll, space = gaussian_problem()
    cfg = MHConfig(iterations=iterations, burn_in=20, adaptation_period=20,
                   thinning=4, regularization_epsilon=1e-8, proposal=proposal,
                   report_interval=5)
    seen = []
    kw = dict(n_chains=n_chains, generator=_gen(seed),
              progress_fn=lambda *a: seen.append(a))
    theta0 = torch.zeros(3, dtype=F64)
    res = (run_mh(ll, space, theta0, cfg, **kw) if mesh is None else
           run_mh_sharded(ll, space, theta0, cfg, mesh=mesh, **kw))
    return dict(progress=np.array(seen, dtype=np.float64),
                **_np(res, ("samples", "sample_logps", "best_x", "best_logp",
                            "acceptance_rate", "final_cov", "final_scale")))


def task_mh_resume(mesh):
    """40 steps, then 40 more from the final state with fresh draws."""
    from mmidv1_tpu_torch.calibration.mh import MHConfig, run_mh
    from mmidv1_tpu_torch.parallel import run_mh_sharded

    ll, space = gaussian_problem()
    cfg = MHConfig(iterations=40, burn_in=10, adaptation_period=20,
                   thinning=4)
    theta0 = torch.zeros(3, dtype=F64)
    run = run_mh if mesh is None else \
        (lambda *a, **k: run_mh_sharded(*a, mesh=mesh, **k))
    r1 = run(ll, space, theta0, cfg, n_chains=16, generator=_gen(5))
    r2 = run(ll, space, theta0, cfg, n_chains=16, generator=_gen(9),
             initial_state=r1.final_state)
    return dict(step=r2.final_state.step, local_rows=r2.final_state.x.shape[0],
                **_np(r2, ("samples", "final_cov")))


def task_pso(mesh, topology):
    from mmidv1_tpu_torch.calibration.pso import PSOConfig, Topology, run_pso
    from mmidv1_tpu_torch.parallel import run_pso_sharded

    ll, space = gaussian_problem()
    cfg = PSOConfig(swarm_size=32, iterations=30,
                    topology=Topology[topology])
    res = (run_pso(ll, space, cfg, generator=_gen(13)) if mesh is None else
           run_pso_sharded(ll, space, cfg, generator=_gen(13), mesh=mesh))
    return _np(res, ("best_x", "best_f", "history_best_f"))


def task_pt(mesh, d=3, n_chains=16, iterations=60, n_rungs=4, seed=9):
    from mmidv1_tpu_torch.calibration.tempering import PTConfig, run_pt
    from mmidv1_tpu_torch.parallel import run_pt_gspmd

    ll, space = gaussian_problem(d)
    cfg = (PTConfig(iterations=iterations, burn_in=10, adaptation_period=20,
                    thinning=4, n_rungs=n_rungs, beta_min=0.1) if d == 3 else
           PTConfig(iterations=iterations, burn_in=10, adaptation_period=10,
                    thinning=4, n_rungs=n_rungs, beta_min=0.2))
    kw = dict(n_chains=n_chains, generator=_gen(seed))
    theta0 = torch.zeros(d, dtype=F64)
    res = (run_pt(ll, space, theta0, cfg, **kw) if mesh is None else
           run_pt_gspmd(ll, space, theta0, cfg, mesh=mesh, **kw))
    return _np(res, ("samples", "sample_logps", "best_x", "best_logp",
                     "acceptance_rate", "swap_rate"))


def task_pt_graph(mesh):
    """The counter ``pt.graph`` of a short PT run, as this process saw
    it."""
    from mmidv1_tpu_torch.utils import trace

    trace.reset()
    task_pt(mesh, iterations=8)
    return dict(graph=trace.counts("pt.graph"))


def task_nuts(mesh):
    from mmidv1_tpu_torch.calibration.nuts import NUTSConfig, run_nuts
    from mmidv1_tpu_torch.parallel import run_nuts_gspmd

    ll, space = gaussian_problem()
    cfg = NUTSConfig(iterations=20, adaptation_window=8, max_tree_depth=3)
    theta0 = torch.zeros(3, dtype=F64)
    res = (run_nuts(ll, space, theta0, cfg, seed=27, n_chains=16)
           if mesh is None else
           run_nuts_gspmd(ll, space, theta0, cfg, seed=27, n_chains=16,
                          mesh=mesh))
    return _np(res, ("samples", "sample_logps", "best_x", "best_logp",
                     "step_sizes", "mean_accept", "mean_depth"))


class WallLoglik:
    """``tests/test_parallel.py``'s logit target: the mode at the wall."""

    def __call__(self, x):
        return -torch.sum(x, dim=-1) / 0.1


def task_nuts_logit(mesh):
    from mmidv1_tpu_torch.calibration.nuts import NUTSConfig, run_nuts_logit
    from mmidv1_tpu_torch.parallel import run_nuts_logit_gspmd

    space = box_space(("a", "b"), 0.0, 1.0, 0.1)
    cfg = NUTSConfig(iterations=20, adaptation_window=8, max_tree_depth=3)
    kw = dict(mu=torch.full((2,), float(np.log(0.1)), dtype=F64),
              scale=torch.eye(2, dtype=F64), seed=5, n_chains=16)
    res = (run_nuts_logit(WallLoglik(), space, cfg, **kw) if mesh is None
           else run_nuts_logit_gspmd(WallLoglik(), space, cfg, mesh=mesh,
                                     **kw))
    return _np(res, ("samples", "sample_logps", "best_x", "best_logp",
                     "step_sizes"))


def task_mala(mesh, d=3, n_chains=16, iterations=60, seed=21):
    from mmidv1_tpu_torch.calibration.mala import MALAConfig, run_mala
    from mmidv1_tpu_torch.parallel import run_mala_gspmd

    ll, space = gaussian_problem(d)
    cfg = MALAConfig(iterations=iterations, burn_in=10, adaptation_period=20,
                     thinning=4, initial_step_size=0.3, report_interval=5)
    kw = dict(n_chains=n_chains, generator=_gen(seed))
    theta0 = torch.zeros(d, dtype=F64)
    seen = []
    if mesh is not None and d != 3:
        res = run_mala_gspmd(ll, space, theta0, cfg, mesh=mesh, **kw)
    else:       # the sampler's own hook, which also reports progress
        if mesh is not None:
            kw["mesh"] = mesh
        res = run_mala(ll, space, theta0, cfg,
                       progress_fn=lambda *a: seen.append(a), **kw)
    return dict(progress=np.array(seen, dtype=np.float64),
                **_np(res, ("samples", "sample_logps", "best_x", "best_logp",
                            "acceptance_rate", "final_cov", "final_eps")))


def mh_state_8(d=8, n=8):
    """An MH state whose dimension equals its chain count."""
    from mmidv1_tpu_torch.calibration.mh import MHState

    g = _gen(3)
    x = torch.randn((n, d), generator=g, dtype=F64)
    cov = torch.eye(d, dtype=F64) + 0.1
    return MHState(x=x, logp=x.sum(1), log_scale=x[:, 0], chol=cov.clone(),
                   cov=cov, best_x=x.flip(0), best_logp=x[:, 1],
                   accept_count=torch.arange(n, dtype=torch.int32), step=3)


def task_fields(mesh):
    """This rank's rows of the named fields, then all of them back."""
    from mmidv1_tpu_torch.parallel import gather_fields, shard_state_fields
    from mmidv1_tpu_torch.parallel.ensemble import _MH_BATCH_FIELDS

    state = mh_state_8()
    local = shard_state_fields(state, mesh, _MH_BATCH_FIELDS)
    back = gather_fields(local, mesh, _MH_BATCH_FIELDS)
    return dict(local_x=local.x.numpy(), local_cov=local.cov.numpy(),
                equal=all(torch.equal(getattr(back, f), getattr(state, f))
                          for f in state._fields if f != "step"))


class TableDraws:
    """A draw source from saved global tables (``init``; per step ``z``,
    ``u`` and DE's ``j``, ``k``, ``g``)."""

    def __init__(self, path):
        with np.load(path) as f:
            self.t = {k: torch.as_tensor(f[k]) for k in f.files}

    def init(self):
        return self.t["init"]

    def step(self, i):
        return self.t["z"][i], self.t["u"][i]

    def partners(self, i):
        return self.t["j"][i], self.t["k"][i], self.t["g"][i]


def task_mh_tables(mesh, tables, proposal, cfg):
    """AM or DE on the Gaussian target, fed saved draw tables."""
    from mmidv1_tpu_torch.calibration.mh import MHConfig
    from mmidv1_tpu_torch.parallel import run_mh_sharded

    ll, space = gaussian_problem()
    res = run_mh_sharded(ll, space, torch.zeros(3, dtype=F64),
                         MHConfig(proposal=proposal, **cfg), n_chains=16,
                         mesh=mesh, draws=TableDraws(tables))
    return _np(res, ("samples", "best_logp", "acceptance_rate", "final_cov"))


def task_spain_tables(mesh, tables, problem, cfg):
    """AM-MH on the shortened Spain objective through the fused objective's
    plain version, fed saved draw tables; ``problem`` is a ``torch.save``
    of ``(space, params, data, ts, theta0)``."""
    from mmidv1_tpu_torch.calibration.mh import MHConfig
    from mmidv1_tpu_torch.calibration.param_space import REFLECT
    from mmidv1_tpu_torch.ops import build_objective_fused
    from mmidv1_tpu_torch.parallel import run_mh_sharded

    space, params, data, ts, theta0 = torch.load(problem, weights_only=False)
    ll = build_objective_fused(space, params, data, ts, substeps=2,
                               constraint_mode=REFLECT, device="cpu")
    res = run_mh_sharded(ll, space, theta0, MHConfig(**cfg), n_chains=16,
                         mesh=mesh, draws=TableDraws(tables))
    return _np(res, ("samples", "best_logp"))


def task_multihost(mesh):
    """The rank's view of the group ``multihost.initialize`` made, and a
    tiny sharded AM run's MAP over it."""
    import torch.distributed as dist
    from mmidv1_tpu_torch.parallel import multihost

    out = task_mh(mesh, iterations=20, n_chains=8)
    return dict(primary=multihost.is_primary(), rank=dist.get_rank(),
                world=dist.get_world_size(), backend=dist.get_backend(),
                mesh_world=mesh.world_size, best_logp=out["best_logp"])
