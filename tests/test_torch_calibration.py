"""The PyTorch port's samplers and optimizer against the JAX package, in
float64 on the CPU.

JAX's threefry stream cannot be reproduced in PyTorch, so each step is fed
the draws the JAX step makes from its key (``_shard_invariant_draws`` for MH,
the ``split(key, 8)`` uniforms for PSO). Given the same draws and the same
starting state, one step runs the same float64 arithmetic on both sides; the
objectives agree at rtol 1e-12 (test_torch_objective.py), so the bar is
rtol 1e-12.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import calibrator as jcal
from mmidv1_tpu.calibration import mh as jmh
from mmidv1_tpu.calibration import pso as jpso
from mmidv1_tpu.calibration.objective import build_objective, make_time_grid
from mmidv1_tpu.calibration.param_space import CLAMP, REFLECT, ParameterSpace

from mmidv1_tpu_torch.calibration import calibrator as tcal
from mmidv1_tpu_torch.calibration import mh as tmh
from mmidv1_tpu_torch.calibration import pso as tpso
from mmidv1_tpu_torch.ops import build_objective_fused

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402
from test_torch_objective import _data_pair  # noqa: E402

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def problem(spain_params):
    prm, params = spain_params
    n_days = 35
    data, tdata = _data_pair(prm, n_days)
    ts = make_time_grid(prm["runup_days"], n_days)
    names = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2",
             "kappa_2", "sigma"]
    bounds = {n: (0.01, 2.0) for n in names}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(names, bounds, {n: 0.05 for n in names},
                                  params)
    tparams = to_torch_params(params)
    tspace = to_torch_space(space, tparams)

    def pair(mode):
        return (jax.jit(jax.vmap(build_objective(space, params, data, ts,
                                                 substeps=2,
                                                 constraint_mode=mode))),
                build_objective_fused(tspace, tparams, tdata, ts, substeps=2,
                                      constraint_mode=mode, device="cpu"))

    return dict(params=params, space=space, tparams=tparams, tspace=tspace,
                reflect=pair(REFLECT), clamp=pair(CLAMP))


def _mh_to_torch(s):
    return tmh.MHState(x=T(s.x), logp=T(s.logp), log_scale=T(s.log_scale),
                       chol=T(s.chol), cov=T(s.cov), best_x=T(s.best_x),
                       best_logp=T(s.best_logp), accept_count=T(s.accept_count),
                       step=int(s.step))


def _assert_mh_equal(ts_, js):
    for f in ("x", "logp", "log_scale", "chol", "cov", "best_x", "best_logp"):
        np.testing.assert_allclose(getattr(ts_, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-12,
                                   err_msg=f)
    np.testing.assert_array_equal(ts_.accept_count.numpy(),
                                  np.asarray(js.accept_count))
    assert ts_.step == int(js.step)


def test_mh_step_matches_jax_given_draws(problem):
    space, tspace = problem["space"], problem["tspace"]
    jll, tll = problem["reflect"]
    cfg = jmh.MHConfig()
    tcfg = tmh.MHConfig()
    theta0 = space.extract(problem["params"])
    B, d = 16, space.dim
    js = jmh.init_mh_state(space, theta0, jll, jax.random.PRNGKey(0), B,
                           jitter=2.0)
    # far enough along that the Robbins-Monro gain is below its 0.1 cap
    js = js._replace(step=jnp.asarray(150, jnp.int32))
    ts_ = _mh_to_torch(js)
    for k in range(3):
        key = jax.random.PRNGKey(10 + k)
        z, u = jmh._shard_invariant_draws(key, B, 0, B, d, jnp.float64)
        js = jmh.mh_step(js, key, space, jll, cfg)
        ts_ = tmh.mh_step(ts_, T(z), T(u), tspace, tll, tcfg)
        _assert_mh_equal(ts_, js)
    acc = ts_.accept_count.numpy()
    assert 0 < acc.sum() < 3 * B          # both branches exercised


def test_adapt_covariance_matches_jax(problem):
    space = problem["space"]
    rng = np.random.default_rng(3)
    B, d = 24, space.dim
    x = rng.normal(size=(B, d)) * np.linspace(0.1, 2.0, d)
    chol0 = np.eye(d)
    js = jmh.MHState(x=jnp.asarray(x), logp=jnp.zeros(B), log_scale=jnp.zeros(B),
                     chol=jnp.asarray(chol0), cov=jnp.eye(d),
                     best_x=jnp.asarray(x), best_logp=jnp.zeros(B),
                     accept_count=jnp.zeros(B, jnp.int32),
                     step=jnp.asarray(0, jnp.int32))
    cfg = jmh.MHConfig()
    a = jmh.adapt_covariance(js, cfg)
    b = tmh.adapt_covariance(_mh_to_torch(js), tmh.MHConfig())
    np.testing.assert_allclose(b.cov.numpy(), np.asarray(a.cov), rtol=1e-12)
    np.testing.assert_allclose(b.chol.numpy(), np.asarray(a.chol), rtol=1e-12,
                               atol=1e-15)


def test_condition_covariance_matches_jax():
    rng = np.random.default_rng(4)
    d = 10
    A = rng.normal(size=(d, 4))
    cov = A @ A.T + 1e-3 * rng.normal(size=(d, d))     # rank-deficient, asymmetric
    sig = rng.uniform(0.05, 0.5, d)
    a = np.asarray(jcal.condition_covariance(jnp.asarray(cov), jnp.asarray(sig)))
    b = tcal.condition_covariance(T(cov), T(sig)).numpy()
    # the floored eigenvalues are degenerate, so the two eigensolvers may pick
    # different bases of that subspace; the reconstruction agrees to rounding
    # of the largest entries
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-14 * np.abs(a).max())


def _pso_to_torch(s):
    return tpso.PSOState(
        x=T(s.x), v=T(s.v), fitness=T(s.fitness), pbest_x=T(s.pbest_x),
        pbest_f=T(s.pbest_f), success_count=T(s.success_count),
        total_updates=T(s.total_updates), gbest_x=T(s.gbest_x),
        gbest_f=T(s.gbest_f), prev_gbest_f=T(s.prev_gbest_f),
        stagnation=int(s.stagnation), evals=int(s.evals))


@pytest.mark.parametrize("topology", list(jpso.Topology))
def test_pso_step_matches_jax_given_draws(problem, topology):
    space, tspace = problem["space"], problem["tspace"]
    jll, tll = problem["clamp"]
    S, d = 12, space.dim
    cfg = jpso.PSOConfig(swarm_size=S, iterations=10, topology=topology)
    tcfg = tpso.PSOConfig(swarm_size=S, iterations=10,
                          topology=tpso.Topology(int(topology)))
    theta0 = space.extract(problem["params"])
    js = jpso.init_pso_state(space, jax.random.PRNGKey(1), cfg, jll, theta0,
                             dtype=jnp.float64)
    ts_ = _pso_to_torch(js)
    tab = jpso._neighbor_table(cfg)
    for it in range(2):
        key = jax.random.PRNGKey(20 + it)
        keys = jax.random.split(key, 8)
        u = jax.random.uniform(keys[0], (3,), dtype=jnp.float64)
        r1, r2 = jax.random.uniform(keys[2], (2, S, d), dtype=jnp.float64)
        js = jpso.pso_step(js, key, it, cfg, space, jll, tab)
        nb = jax.random.randint(keys[1], (S, 4), 0, S)
        ts_ = tpso.pso_step(ts_, tpso.PSODraws(u=T(u), r1=T(r1), r2=T(r2),
                                               neighbours=T(nb).long()),
                            it, tcfg, tspace, tll, tpso._neighbor_table(tcfg))
        for f in ("x", "v", "fitness", "pbest_x", "pbest_f", "gbest_x",
                  "gbest_f"):
            np.testing.assert_allclose(getattr(ts_, f).numpy(),
                                       np.asarray(getattr(js, f)), rtol=1e-12,
                                       err_msg=f)
        for f in ("success_count", "total_updates"):
            np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                          np.asarray(getattr(js, f)))
        assert ts_.evals == int(js.evals)


def test_restart_and_elitist_match_jax_given_draws(problem):
    space, tspace = problem["space"], problem["tspace"]
    jll, tll = problem["clamp"]
    S, d = 12, space.dim
    cfg = jpso.PSOConfig(swarm_size=S, iterations=10,
                         variant=jpso.PSOVariant.ADAPTIVE)
    tcfg = tpso.PSOConfig(swarm_size=S, iterations=10,
                          variant=tpso.PSOVariant.ADAPTIVE)
    js = jpso.init_pso_state(space, jax.random.PRNGKey(2), cfg, jll,
                             space.extract(problem["params"]), dtype=jnp.float64)
    js = jpso.pso_step(js, jax.random.PRNGKey(3), 0, cfg, space, jll, None)
    ts_ = _pso_to_torch(js)

    key = jax.random.PRNGKey(4)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    rd = tpso.RestartDraws(
        assign=T(jax.random.randint(k1, (S,), 0, cfg.elite_count)).long(),
        u_sigma=T(jax.random.uniform(k2, (S, d), dtype=jnp.float64)),
        z=T(jax.random.normal(k3, (S, d), dtype=jnp.float64)),
        u_unif=T(jax.random.uniform(k4, (S, d), dtype=jnp.float64)),
        u_pick=T(jax.random.uniform(k5, (S, d), dtype=jnp.float64)),
        u_v=T(jax.random.uniform(jax.random.fold_in(k5, 1), (S, d),
                                 dtype=jnp.float64)))
    js = jpso._restart_swarm(js, key, cfg, space, jll)
    ts_ = tpso._restart_swarm(ts_, rd, tcfg, tspace, tll)

    key = jax.random.PRNGKey(5)
    noise = jax.random.normal(key, (3, d), dtype=jnp.float64)
    js = jpso._elitist_learning(js, key, cfg, space, jll)
    ts_ = tpso._elitist_learning(ts_, T(noise), tcfg, tspace, tll)
    for f in ("x", "v", "fitness", "pbest_x", "pbest_f", "gbest_x", "gbest_f"):
        np.testing.assert_allclose(getattr(ts_, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-12,
                                   err_msg=f)
    for f in ("success_count", "total_updates"):
        np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert ts_.evals == int(js.evals) and ts_.stagnation == int(js.stagnation)


def test_calibrate_rejects_unknown_algorithms(problem):
    tspace = problem["tspace"]
    gen = torch.Generator().manual_seed(0)
    # the menu refuses what the reference's does not offer
    with pytest.raises(ValueError):
        tcal.calibrate(None, None, tspace, None, generator=gen,
                       algorithm="annealing")
    with pytest.raises(ValueError):
        tcal.calibrate(None, None, tspace, None, generator=gen,
                       algorithm="hillmcmc", phase1="annealing")


@pytest.mark.parametrize("variant", list(tpso.PSOVariant))
def test_calibrate_psomcmc_end_to_end_cpu(problem, variant):
    """A small CPU psomcmc run through the fused objective's plain version:
    finite output that beats the starting log-likelihood."""
    tspace = problem["tspace"]
    tll_reflect, tll_clamp = problem["reflect"][1], problem["clamp"][1]
    theta0 = tspace.extract(problem["tparams"])
    ll0 = float(tll_clamp(theta0[None, :])[0])
    gen = torch.Generator().manual_seed(7)
    res = tcal.calibrate(
        tll_clamp, tll_reflect, tspace, theta0, generator=gen,
        algorithm="psomcmc",
        phase1_config=tpso.PSOConfig(swarm_size=16, iterations=6,
                                     variant=variant,
                                     topology=tpso.Topology.VON_NEUMANN),
        mh_config=tmh.MHConfig(iterations=6, burn_in=2, thinning=2,
                               adaptation_period=2),
        n_chains=8)
    assert np.isfinite(float(res.best_logl))
    assert float(res.best_logl) > ll0
    assert res.samples.shape == (3, 8, tspace.dim)
    assert torch.isfinite(res.samples).all()
    assert bool(tspace.in_bounds(res.best_theta))
    # the reported best is what the objective gives at the reported theta
    np.testing.assert_allclose(float(tll_reflect(res.best_theta[None, :])[0]),
                               float(res.best_logl), rtol=1e-12)


def test_calibrate_spain_cli_runs_on_cpu(tmp_path):
    """The port's calibrate_spain entry point end to end on the host, at a
    tiny depth and a 40-day window: finite results, the float64 re-selection,
    and a re-loadable calibrated_parameters.txt."""
    from mmidv1_tpu_torch.cli.calibrate_spain import run_calibration
    from mmidv1_tpu_torch.data import read_sepaihrd_parameters

    s = run_calibration(pso_particles=8, pso_iters=2, chains=4, mcmc_iters=2,
                        thinning=1, burn_in=1, device="cpu", num_days=40,
                        out=str(tmp_path), log=lambda m: None)
    assert np.isfinite(s["best_logl"]) and np.isfinite(s["best_logl_float64"])
    assert s["best_logl"] >= s["initial_logl"]
    assert abs(s["best_logl_float64"] - s["best_logl"]) < 1e-3 * abs(s["best_logl"])
    p = read_sepaihrd_parameters(str(tmp_path / "calibrated_parameters.txt"), 4,
                                 device="cpu")
    assert torch.isfinite(p.beta_values).all()
    assert (tmp_path / "run_metadata.json").exists()


def test_calibrate_spain_float64_reselection_matches_the_script(tmp_path,
                                                                monkeypatch):
    """The float32 run's float64 re-selection computes what
    ``scripts/calibrate_spain.py:166-199`` computes: the run's float32
    parameters cast up to float64, through the run's float32 space, on the
    run's grid (40 days on both sides). At the run's own candidate thetas
    the port's float64 log-likelihoods, and ``best_logl_float64``, equal
    that expression's (``build_objective`` of the JAX package, rtol 1e-12:
    the two objectives run the same float64 arithmetic), and
    ``calibrated_parameters.txt`` is, byte for byte, what the JAX package's
    ``save_calibration_results`` writes from the up-cast parameters."""
    import dataclasses
    import re

    from mmidv1_tpu.cli.common import load_spain_pipeline as j_load
    from mmidv1_tpu.data import save_calibration_results as j_save

    from mmidv1_tpu_torch.cli import calibrate_spain as tcs

    seen = {}
    reselect = tcs.reselect_float64

    def spy(*args, **kw):
        lls64, params64 = reselect(*args, **kw)
        seen.update(cands=args[4].numpy(), lls64=lls64.numpy())
        return lls64, params64

    monkeypatch.setattr(tcs, "reselect_float64", spy)
    s = tcs.run_calibration(pso_particles=8, pso_iters=2, chains=4,
                            mcmc_iters=2, thinning=1, burn_in=1, device="cpu",
                            num_days=40, out=str(tmp_path), log=lambda m: None)
    cands = seen["cands"]
    assert s["dtype"] == "float32" and cands.dtype == np.float64
    assert len(cands) >= 2

    pipe = j_load(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  num_days=40, dtype=jnp.float32)
    # the script loads its float32 run with x64 off, so its space's bounds
    # are float32 (the tests run with x64 on)
    space = dataclasses.replace(pipe.space, **{
        f: np.asarray(getattr(pipe.space, f), np.float32)
        for f in ("lower", "upper", "sigmas")})
    params64 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x), jnp.float64), pipe.params)
    ll64 = build_objective(space, params64, pipe.data, pipe.ts,
                           substeps=4, constraint_mode=REFLECT,
                           dtype=jnp.float64)
    lls = np.asarray(jax.jit(jax.vmap(ll64))(jnp.asarray(cands, jnp.float64)))
    np.testing.assert_allclose(seen["lls64"], lls, rtol=1e-12)
    k = int(np.argmax(lls))
    np.testing.assert_allclose(s["best_logl_float64"], lls[k], rtol=1e-12)

    got = tmp_path / "calibrated_parameters.txt"
    stamp = re.search(r"# Calibration completed: (.*)", got.read_text()).group(1)
    want = tmp_path / "jax_calibrated_parameters.txt"
    j_save(str(want), space.apply(params64, jnp.asarray(cands[k], jnp.float64)),
           list(space.names), float(lls[k]), timestamp=stamp)
    assert got.read_bytes() == want.read_bytes()
