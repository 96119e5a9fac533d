"""The port's multi-device layer (``mmidv1_tpu_torch/parallel``) on the CPU.

The counterpart of ``tests/test_parallel.py``: the same ensemble run must
give the same samples on one rank and with its chain axis split over
several. Ranks are ``gloo`` processes spawned on the host
(``tests/torch_ranks.py``), float64, through the kernels' plain versions.

- The port sharded (2 ranks) against the port unsharded, from the same
  global draws, at the JAX tests' bars: AM and DE-MC, a resumed run, PSO
  (GLOBAL_BEST and VON_NEUMANN), PT, NUTS, logit-NUTS, MALA, and the
  d == n_chains case for MALA and PT.
- The port sharded (4 ranks) against the JAX package's ``run_mh_sharded`` on
  the 8-device CPU mesh ``tests/conftest.py`` sets up, fed JAX's global draw
  tables: AM and DE-MC on the Gaussian target, and AM on the shortened
  Spain objective of ``tests/test_parallel.py:159-204``.
- The mesh helpers on one process.
- PT on a mesh of two ranks steps eagerly, past the step graphs.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import mh as jmh
from mmidv1_tpu.calibration.objective import build_objective, make_time_grid
from mmidv1_tpu.calibration.param_space import REFLECT, ParameterSpace
from mmidv1_tpu.data import CalibrationData
from mmidv1_tpu.parallel import ensemble_mesh as jax_mesh
from mmidv1_tpu.parallel import run_mh_sharded as jax_run_mh_sharded

from mmidv1_tpu_torch.calibration.draws import GeneratorDraws, ShardDraws
from mmidv1_tpu_torch.calibration.nuts import SeededDraws
from mmidv1_tpu_torch.data import CalibrationData as TCalibrationData
from mmidv1_tpu_torch.parallel import (CHAINS_AXIS, EnsembleMesh,
                                       check_divisible, ensemble_mesh,
                                       shard_ensemble_pytree,
                                       shard_state_fields)
from mmidv1_tpu_torch.parallel.ensemble import (_MH_BATCH_FIELDS,
                                                _PT_BATCH_FIELDS)

sys.path.insert(0, os.path.dirname(__file__))
import torch_ranks as R  # noqa: E402
from test_torch_mh_demc import JaxRunDraws  # noqa: E402
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402

CPU = torch.device("cpu")
# name -> (task, kwargs): each runs sharded on the ranks and unsharded here
TWO_RANK_TASKS = {
    "am": (R.task_mh, dict(proposal="am")),
    "de": (R.task_mh, dict(proposal="de", seed=13)),
    "resume": (R.task_mh_resume, {}),
    "pso_GLOBAL_BEST": (R.task_pso, dict(topology="GLOBAL_BEST")),
    "pso_VON_NEUMANN": (R.task_pso, dict(topology="VON_NEUMANN")),
    "pt": (R.task_pt, {}),
    "nuts": (R.task_nuts, {}),
    "nuts_logit": (R.task_nuts_logit, {}),
    "mala": (R.task_mala, {}),
    "mala_8d": (R.task_mala, dict(d=8, n_chains=8, iterations=40, seed=29)),
    "pt_8d": (R.task_pt, dict(d=8, n_chains=8, iterations=30, n_rungs=2,
                              seed=31)),
    "fields": (R.task_fields, {}),
    "pt_graph": (R.task_pt_graph, {}),
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every task on 2 ranks (one spawn), and unsharded here."""
    names = list(TWO_RANK_TASKS)
    ranks = R.spawn(2, [TWO_RANK_TASKS[n] for n in names],
                    str(tmp_path_factory.mktemp("two_ranks")))
    sharded = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    ref = {n: fn(None, **kw) for n, (fn, kw) in TWO_RANK_TASKS.items()
           if n != "fields"}
    return sharded, ref


def close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def check(two_ranks, name, bars):
    """Each rank's (global) result against the unsharded run, field by
    field at ``bars[field] = (rtol, atol)``; both ranks agree to the bit."""
    sharded, ref = two_ranks
    r0, r1 = sharded[name]
    for field, (rtol, atol) in bars.items():
        close(r0[field], ref[name][field], rtol, atol, f"{name}.{field}")
        np.testing.assert_array_equal(r0[field], r1[field],
                                      err_msg=f"{name}.{field} across ranks")
    return r0, ref[name]


@pytest.mark.parametrize("proposal", ["am", "de"])
def test_mh_sharded_matches_unsharded(two_ranks, proposal):
    got, _ = check(two_ranks, proposal, dict(
        samples=(1e-9, 1e-9), sample_logps=(1e-9, 1e-9),
        best_logp=(1e-9, 0.0), acceptance_rate=(1e-12, 0.0),
        final_cov=(1e-8, 1e-12), final_scale=(1e-9, 0.0)))
    assert got["samples"].shape == (30, 16, 3)
    acc = got["acceptance_rate"]
    assert (acc > 0).all() and (acc <= 1.0).all()


@pytest.mark.parametrize("name", ["am", "de", "mala"])
def test_progress_numbers_are_reduced_over_ranks(two_ranks, name):
    """The progress callback sees the whole ensemble's numbers on every
    rank (step, mean acceptance, best, mean scale), not its own chains'.
    MH's mean acceptance is float32 (int32 counts divided, as in the JAX
    package): a sum in another order moves it by float32 rounding."""
    sharded, ref = two_ranks
    want = ref[name]["progress"]
    assert want.shape == (6 if name != "mala" else 3, 4)
    acc_rtol = 1e-12 if name == "mala" else 2e-7
    for got in (r["progress"] for r in sharded[name]):
        close(got[:, [0, 2, 3]], want[:, [0, 2, 3]], 1e-12, 0.0, name)
        close(got[:, 1], want[:, 1], acc_rtol, 0.0, f"{name} acceptance")


def test_pt_steps_on_a_mesh_stay_eager(two_ranks):
    """On a mesh of two ranks PT steps eagerly without the step graphs
    (``tempering._StepGraphs``), as AM's sharded step does: ``pt.graph``
    counts nothing there, while the unsharded run on the host goes through
    them and counts every step eager."""
    sharded, ref = two_ranks
    for r in sharded["pt_graph"]:
        assert r["graph"] == {}
    assert ref["pt_graph"]["graph"] == {("eager", 64): 8}


def test_mh_sharded_resume(two_ranks):
    """A sharded run resumed from each rank's final state reaches step 80
    on every rank, with the unsharded resumed run's samples."""
    got, want = check(two_ranks, "resume", dict(samples=(1e-9, 1e-9),
                                                final_cov=(1e-8, 1e-12)))
    for r in two_ranks[0]["resume"]:
        assert r["step"] == 80 and r["local_rows"] == 8
    assert want["step"] == 80
    assert np.isfinite(got["samples"]).all()


@pytest.mark.parametrize("topology", ["GLOBAL_BEST", "VON_NEUMANN"])
def test_pso_sharded_matches_unsharded(two_ranks, topology):
    got, _ = check(two_ranks, f"pso_{topology}", dict(
        best_x=(1e-8, 1e-10), best_f=(1e-8, 0.0),
        history_best_f=(1e-8, 0.0)))
    # and it optimizes
    close(got["best_x"], [0.3, -0.2, 0.5], 0.0, 0.05)


def test_pt_gspmd_matches_unsharded(two_ranks):
    got, _ = check(two_ranks, "pt", dict(
        samples=(1e-9, 1e-9), sample_logps=(1e-9, 1e-9),
        best_logp=(1e-9, 0.0), swap_rate=(1e-12, 0.0),
        acceptance_rate=(1e-12, 0.0)))
    assert got["samples"].shape == (15, 16, 3)
    assert got["acceptance_rate"].shape == (4, 16)


def test_nuts_gspmd_matches_unsharded(two_ranks):
    check(two_ranks, "nuts", dict(
        samples=(1e-9, 1e-9), best_logp=(1e-9, 0.0),
        step_sizes=(1e-9, 0.0), mean_accept=(1e-9, 1e-12),
        mean_depth=(1e-12, 0.0)))


def test_nuts_logit_gspmd_matches_unsharded(two_ranks):
    check(two_ranks, "nuts_logit", dict(
        samples=(1e-9, 1e-9), sample_logps=(1e-9, 1e-7),
        step_sizes=(1e-9, 0.0)))


def test_mala_gspmd_matches_unsharded(two_ranks):
    check(two_ranks, "mala", dict(
        samples=(1e-9, 1e-9), best_logp=(1e-9, 0.0),
        acceptance_rate=(1e-12, 0.0), final_cov=(1e-8, 1e-12),
        final_eps=(1e-9, 0.0)))


@pytest.mark.parametrize("name", ["mala_8d", "pt_8d"])
def test_gspmd_dim_equals_chains(two_ranks, name):
    """d == n_chains (8): the (d, d) covariance state stays whole."""
    got, _ = check(two_ranks, name, dict(samples=(1e-9, 1e-9)))
    assert got["samples"].shape[-2:] == (8, 8)


def test_gather_fields_round_trip(two_ranks):
    """shard_state_fields keeps a rank's rows of the named fields and the
    (d, d) factors whole; gather_fields gives the whole state back."""
    state = R.mh_state_8()
    for rank, r in enumerate(two_ranks[0]["fields"]):
        np.testing.assert_array_equal(r["local_x"],
                                      state.x[4 * rank:4 * rank + 4].numpy())
        np.testing.assert_array_equal(r["local_cov"], state.cov.numpy())
        assert r["equal"]


# ------------------------------------------------ against the JAX package

def _jax_gaussian():
    mu = jnp.asarray([0.3, -0.2, 0.5])
    sd = jnp.asarray([0.5, 0.3, 0.8])
    space = ParameterSpace(names=("x0", "x1", "x2"), lower=jnp.full((3,), -5.0),
                           upper=jnp.full((3,), 5.0),
                           sigmas=jnp.full((3,), 0.3), _scatter={})
    return (lambda th: -0.5 * jnp.sum(((th - mu) / sd) ** 2)), space


def _save_tables(path, key, n_blocks, thin, n, d, de):
    """JAX's global draw tables of a run from ``key``."""
    draws = JaxRunDraws(key, n_blocks, thin, n, d)
    steps = [draws.step(i) for i in range(n_blocks * thin)]
    tables = dict(init=draws.init().numpy(),
                  z=np.stack([z.numpy() for z, _ in steps]),
                  u=np.stack([u.numpy() for _, u in steps]))
    if de:
        parts = [draws.partners(i) for i in range(n_blocks * thin)]
        for name, i in (("j", 0), ("k", 1), ("g", 2)):
            tables[name] = np.stack([p[i].numpy() for p in parts])
    np.savez(path, **tables)
    return path


def _spain(spain_params):
    """tests/test_parallel.py:159-204's problem, in both packages."""
    prm, params = spain_params
    n_days = 40
    rng = np.random.default_rng(23)
    obs = rng.poisson(5.0, size=(n_days, 4)).astype(float)
    kw = dict(new_confirmed=obs, new_hospitalizations=obs, new_icu=obs * 0.2,
              new_deaths=obs * 0.1, population_by_age=prm["N"],
              initial_cumulative_confirmed=[1200.0, 2500.0, 900.0, 300.0],
              initial_cumulative_deaths=[2.0, 10.0, 40.0, 60.0],
              initial_cumulative_hospitalizations=[30.0, 120.0, 180.0, 90.0],
              initial_cumulative_icu=[4.0, 18.0, 25.0, 6.0])
    ts = make_time_grid(prm["runup_days"], n_days)
    names = ["beta_1", "theta", "seed_exposed"]
    bounds = {"beta_1": (0.1, 2.0), "theta": (0.01, 1.0),
              "seed_exposed": (1.0, 500.0)}
    sigmas = {"beta_1": 0.05, "theta": 0.05, "seed_exposed": 10.0}
    space = ParameterSpace.create(names, bounds, sigmas, params)
    loglik = build_objective(space, params, CalibrationData.from_arrays(**kw),
                             ts, substeps=2, constraint_mode=REFLECT)
    tparams = to_torch_params(params)
    port = (to_torch_space(space, tparams), tparams,
            TCalibrationData.from_arrays(**kw), np.asarray(ts),
            torch.as_tensor(np.array(space.extract(params))))
    return loglik, space, space.extract(params), port


@pytest.fixture(scope="module")
def four_ranks_vs_jax(tmp_path_factory, spain_params):
    """JAX's run_mh_sharded on the 8-device mesh and the port on 4 ranks,
    both from JAX's global draw tables."""
    work = tmp_path_factory.mktemp("four_ranks")
    mesh = jax_mesh()
    assert mesh.devices.size == 8
    jll, jspace = _jax_gaussian()
    gauss = dict(iterations=120, burn_in=20, adaptation_period=20, thinning=4,
                 regularization_epsilon=1e-8)
    want, tasks = {}, []
    for proposal, seed in (("am", 7), ("de", 13)):
        key = jax.random.PRNGKey(seed)
        res = jax_run_mh_sharded(jll, jspace, jnp.zeros(3), key,
                                 jmh.MHConfig(proposal=proposal, **gauss),
                                 n_chains=16, mesh=mesh)
        want[proposal] = np.asarray(res.samples)
        tables = _save_tables(str(work / f"{proposal}.npz"), key, 30, 4, 16,
                              3, proposal == "de")
        tasks.append((R.task_mh_tables, dict(tables=tables, proposal=proposal,
                                             cfg=gauss)))
    sloglik, sspace, stheta0, port = _spain(spain_params)
    spain_cfg = dict(iterations=8, burn_in=2, adaptation_period=4, thinning=2)
    key = jax.random.PRNGKey(17)
    res = jax_run_mh_sharded(sloglik, sspace, stheta0, key,
                             jmh.MHConfig(**spain_cfg), n_chains=16, mesh=mesh)
    want["spain"] = np.asarray(res.samples)
    problem = str(work / "spain.pt")
    torch.save(port, problem)
    tasks.append((R.task_spain_tables, dict(
        tables=_save_tables(str(work / "spain.npz"), key, 4, 2, 16, 3, False),
        problem=problem, cfg=spain_cfg)))
    ranks = R.spawn(4, tasks, str(work))
    return {n: ([r[i] for r in ranks], want[n])
            for i, n in enumerate(("am", "de", "spain"))}


@pytest.mark.parametrize("proposal", ["am", "de"])
def test_mh_sharded_matches_jax_sharded(four_ranks_vs_jax, proposal):
    """AM / DE-MC on 4 port ranks equal JAX's run_mh_sharded on 8 devices:
    the same global tables, sliced per rank and per device."""
    ranks, want = four_ranks_vs_jax[proposal]
    for r in ranks:
        close(r["samples"], want, 1e-9, 1e-9, proposal)
    assert ranks[0]["samples"].shape == (30, 16, 3)


def test_mh_sharded_on_sepaihrd_objective_matches_jax(four_ranks_vs_jax):
    """The shortened Spain objective (40 days, substeps 2, REFLECT) through
    the fused objective's plain version on each of 4 ranks, against JAX's
    sharded run at tests/test_parallel.py's bar."""
    ranks, want = four_ranks_vs_jax["spain"]
    for r in ranks:
        close(r["samples"], want, 1e-7, 1e-9, "spain")
        assert np.isfinite(r["best_logp"])


# ------------------------------------------------------- the mesh helpers

def test_mesh_construction():
    mesh = ensemble_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.distributed) == (1, 0, False)
    assert mesh.axis_name == CHAINS_AXIS == "chains"
    assert mesh.device == CPU
    assert ensemble_mesh(1, device="cpu").world_size == 1
    with pytest.raises(ValueError, match="only 1 available"):
        ensemble_mesh(n_devices=99, device="cpu")


def test_check_divisible():
    mesh = EnsembleMesh(world_size=4, rank=2, device=CPU)
    assert check_divisible(16, mesh) == 4
    assert (mesh.n_local(16), mesh.offset(16)) == (4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        check_divisible(18, mesh, "n_chains")


def test_shard_state_fields_by_name():
    """Named fields split, the (d, d) factors whole though d == n_chains;
    PT's chain axis is dim 1."""
    state = R.mh_state_8()
    local = shard_state_fields(state, EnsembleMesh(2, 1, CPU),
                               _MH_BATCH_FIELDS)
    assert torch.equal(local.x, state.x[4:])
    assert torch.equal(local.accept_count, state.accept_count[4:])
    assert torch.equal(local.cov, state.cov) and local.step == 3
    with pytest.raises(ValueError, match="unknown state fields"):
        shard_state_fields(state, EnsembleMesh(2, 1, CPU), ("x", "nope"))
    pt_state = state._replace(x=torch.zeros(3, 8, 8), logp=torch.zeros(3, 8),
                              log_scale=torch.zeros(3, 8),
                              best_x=torch.zeros(3, 8, 8),
                              best_logp=torch.zeros(3, 8),
                              accept_count=torch.zeros(3, 8))
    local = shard_state_fields(pt_state, EnsembleMesh(4, 3, CPU),
                               _PT_BATCH_FIELDS, batch_dim=1)
    assert local.x.shape == (3, 2, 8) and local.logp.shape == (3, 2)
    assert local.cov.shape == (8, 8)


def test_shard_ensemble_pytree():
    tree = {"x": torch.arange(48.0).reshape(16, 3), "cov": torch.eye(3),
            "n": torch.zeros(()), "pair": (torch.ones(16), 2)}
    got = shard_ensemble_pytree(tree, EnsembleMesh(2, 1, CPU), 16)
    assert torch.equal(got["x"], tree["x"][8:])
    assert torch.equal(got["cov"], tree["cov"]) and got["n"].shape == ()
    assert got["pair"][0].shape == (8,) and got["pair"][1] == 2


def test_shard_draws_are_rows_of_the_global_tables():
    """A rank's draws are its rows of the tables made for the whole
    ensemble: MH / MALA rows, PT's rung-major (K, N) rows, NUTS's chain
    columns; DE's partner indices stay global."""
    n, d, K = 8, 3, 2

    def source(rows):
        return GeneratorDraws(torch.Generator().manual_seed(4), rows, d,
                              torch.float64, "cpu")

    whole = source(n)
    part = ShardDraws(source(n), n, 4, 4)
    assert torch.equal(part.init(), whole.init()[4:])
    for a, b in zip(part.step(0), whole.step(0)):
        assert torch.equal(a, b[4:])
    for a, b in zip(part.partners(1), whole.partners(1)):
        assert torch.equal(a, b[4:])
    whole, part = source(K * n), ShardDraws(source(K * n), n, 2, 2, rungs=K)
    z = whole.init().reshape(K, n, d)[:, 2:4].reshape(K * 2, d)
    assert torch.equal(part.init(), z)
    assert torch.equal(part.swap(0, (K - 1, 2)), whole.swap(0, (K - 1, n))[:, 2:4])
    nuts = SeededDraws(3, n, d, 2, torch.float64, "cpu")
    pn = ShardDraws(SeededDraws(3, n, d, 2, torch.float64, "cpu"), n, 6, 2)
    a, b = pn.iteration(5), nuts.iteration(5)
    assert torch.equal(a.r0, b.r0[6:]) and torch.equal(a.u, b.u[6:])
    assert torch.equal(a.v, b.v[:, 6:])
    assert all(torch.equal(x, y[:, 6:]) for x, y in zip(a.leaf_u, b.leaf_u))
    assert torch.equal(a.accept_u, b.accept_u[:, 6:])
    assert torch.equal(pn.jitter(), nuts.jitter()[6:])
