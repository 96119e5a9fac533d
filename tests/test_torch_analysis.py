"""The PyTorch port's analysis layer against the JAX package, in float64 on
the CPU.

- reproduction numbers: the same float64 products and 64 power iterations on
  both sides (the port batched, JAX one matrix at a time or vmapped), so
  rtol 1e-12;
- EssentialMetrics over a batch of B = 8 trajectories (the port's batched
  solve against JAX's per-draw solve): the metrics sum hundreds of terms in
  orders that differ, so rtol 1e-10; one draw has every H and ICU total
  exactly 0 (a peak tied over the whole grid) and must pick the same day;
- the NumPy copies (aggregate, diagnostics, writers): identical values and
  identical bytes;
- ``build_incidence_fn`` batched against ``jax.vmap`` of JAX's: rtol 1e-12.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.analysis import aggregate as jagg
from mmidv1_tpu.analysis import diagnostics as jdiag
from mmidv1_tpu.analysis import metrics as jmet
from mmidv1_tpu.analysis import reproduction as jrep
from mmidv1_tpu.analysis import writers as jwr
from mmidv1_tpu.calibration.objective import (build_incidence_fn,
                                              make_time_grid)
from mmidv1_tpu.calibration.param_space import REFLECT, ParameterSpace
from mmidv1_tpu.models import sepaihrd as jsep

from mmidv1_tpu_torch.analysis import aggregate as tagg
from mmidv1_tpu_torch.analysis import diagnostics as tdiag
from mmidv1_tpu_torch.analysis import metrics as tmet
from mmidv1_tpu_torch.analysis import reproduction as trep
from mmidv1_tpu_torch.analysis import writers as twr
from mmidv1_tpu_torch.calibration.objective import \
    build_incidence_fn as t_build_incidence_fn
from mmidv1_tpu_torch.models import sepaihrd as tsep

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402
from test_torch_objective import _data_pair  # noqa: E402

torch.set_num_threads(1)
T = lambda a: torch.as_tensor(np.asarray(a))

NAMES = ["beta_1", "beta_2", "theta", "kappa_2", "seed_exposed", "p_1",
         "h_0", "h_1", "h_2", "h_3"]


@pytest.fixture(scope="module")
def batch(spain_params):
    """B = 8 draws of a 10-name space around the Spain-2020 parameters, the
    last with h = 0 in every age (no one is ever hospitalized: the H and ICU
    totals are 0 on the whole grid), solved on both sides over 100 days."""
    prm, params = spain_params
    bounds = {n: (0.0, 2.0) for n in NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(NAMES, bounds, {n: 0.05 for n in NAMES},
                                  params)
    tparams = to_torch_params(params)
    tspace = to_torch_space(space, tparams)
    rng = np.random.default_rng(11)
    theta0 = np.asarray(space.extract(params))
    thetas = theta0[None, :] * rng.uniform(0.8, 1.2, (8, len(NAMES)))
    thetas[-1, 6:] = 0.0
    ts = np.arange(-20.0, 100.0)
    data, tdata = _data_pair(prm, 100)
    base = data.initial_sepaihrd_state(
        sigma=params.sigma, gamma_p=params.gamma_p, gamma_A=params.gamma_A,
        gamma_I=params.gamma_I, p=params.p, h=params.h)
    base = np.asarray(base)

    def jax_draw(th):
        """One draw through JAX (vmapped below: each draw is its own
        solve, as under the JAX report's ``jax.vmap``)."""
        p = space.apply(params, space.constrain(th, REFLECT))
        y0, _ = jsep.initial_state_for_params(p, jnp.asarray(base))
        tsj = jnp.asarray(ts)
        traj = jsep.solve(p, y0, tsj, method="fixed", substeps=2)
        return dict(
            rt=jrep.rt_trajectory(p, traj, tsj), r0=jrep.calculate_r0(p),
            sero=jmet.seroprevalence_trajectory(p, traj),
            metrics={flag: jmet.essential_metrics(p, traj, tsj, y0,
                                                  use_scalar_beta=flag)
                     for flag in (False, True)})

    tp = tspace.apply(tparams, tspace.constrain(T(thetas), REFLECT))
    ty0, _ = tsep.initial_state_for_params(tp, T(base))
    ty0 = ty0.expand(8, 11, 4)
    ttraj = tsep.solve(tp, ty0, T(ts), method="fixed", substeps=2)
    jout = jax.jit(jax.vmap(jax_draw))(jnp.asarray(thetas))
    return dict(space=space, tspace=tspace, params=params, tparams=tparams,
                thetas=thetas, ts=ts, jax=jout, tp=tp, ty0=ty0,
                ttraj=ttraj, data=data, tdata=tdata, base=base)


# ----------------------------------------------------------- reproduction

@pytest.mark.parametrize("scale,t", [(1.0, 0.0), (0.7, 50.0), (0.3, 200.0)])
def test_reduced_ngm_and_spectral_radius_match_jax(spain_params, scale, t):
    """K, its spectral radius and the literal 16 x 16 F and V equal JAX's;
    the reduced radius is the full one's (as ``test_analysis.py:28``)."""
    _prm, params = spain_params
    tp = to_torch_params(params)
    w = np.asarray(params.N) * scale
    K_j = np.asarray(jrep.reduced_ngm(params, jnp.asarray(w), t))
    K_t = trep.reduced_ngm(tp, T(w), t)
    np.testing.assert_allclose(K_t.numpy(), K_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        float(trep.spectral_radius(K_t)),
        float(jrep.spectral_radius(jnp.asarray(K_j))), rtol=1e-12)
    F_j, V_j = jrep.full_ngm_matrices(params, w, t)
    F_t, V_t = trep.full_ngm_matrices(tp, w, t)
    np.testing.assert_array_equal(F_t, F_j)
    np.testing.assert_array_equal(V_t, V_j)
    rho_full = np.max(np.abs(np.linalg.eigvals(F_t @ np.linalg.inv(V_t))))
    np.testing.assert_allclose(float(trep.spectral_radius(K_t, iters=200)),
                               rho_full, rtol=1e-8)


def test_r0_and_rt_match_jax(spain_params):
    _prm, params = spain_params
    tp = to_torch_params(params)
    np.testing.assert_allclose(float(trep.calculate_r0(tp)),
                               float(jrep.calculate_r0(params)), rtol=1e-12)
    for s, t in ((1.0, 0.0), (0.5, 70.0), (0.9, 300.0)):
        S = np.asarray(params.N) * s
        np.testing.assert_allclose(
            float(trep.calculate_rt(tp, T(S), t)),
            float(jrep.calculate_rt(params, jnp.asarray(S), t)), rtol=1e-12)
    for flag in (False, True):
        np.testing.assert_allclose(
            trep.infection_duration_weights(tp, flag).numpy(),
            np.asarray(jrep.infection_duration_weights(params, flag)),
            rtol=1e-12)


def test_batched_r0_and_rt_trajectory_match_jax(batch):
    """(T, B) Rt and (B,) R0 of batched parameters against JAX per draw."""
    b = batch
    rt_t = trep.rt_trajectory(b["tp"], b["ttraj"], b["ts"]).numpy()
    r0_t = trep.calculate_r0(b["tp"]).numpy()
    assert rt_t.shape == (len(b["ts"]), 8) and r0_t.shape == (8,)
    np.testing.assert_allclose(rt_t.T, np.asarray(b["jax"]["rt"]), rtol=1e-12)
    np.testing.assert_allclose(r0_t, np.asarray(b["jax"]["r0"]), rtol=1e-12)


# ----------------------------------------------------------- metrics

@pytest.mark.parametrize("use_scalar_beta", [False, True])
def test_essential_metrics_batched_match_jax(batch, use_scalar_beta):
    b = batch
    m_t = tmet.essential_metrics(b["tp"], b["ttraj"], b["ts"], b["ty0"],
                                 use_scalar_beta=use_scalar_beta)
    sero_t = tmet.seroprevalence_trajectory(b["tp"], b["ttraj"]).numpy()
    m_j = b["jax"]["metrics"][use_scalar_beta]
    assert set(m_t) == set(m_j)
    for k, v in m_j.items():
        assert m_t[k].shape == v.shape, k
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(v),
                                   rtol=1e-10, atol=1e-300, err_msg=k)
    np.testing.assert_allclose(sero_t.T, np.asarray(b["jax"]["sero"]),
                               rtol=1e-12)
    # the last draw's H and ICU totals are tied at 0 on the whole grid: the
    # first maximum is the grid's first point on both sides
    assert float(b["ttraj"][:, -1, 5:7].abs().max()) == 0.0
    for k in ("time_to_peak_hospital", "time_to_peak_ICU"):
        assert float(m_t[k][-1]) == b["ts"][0]


def test_essential_metrics_tied_interior_peak():
    """A plateau inside the grid: the peak is its first day, as in JAX."""
    from mmidv1_tpu import make_params as jmake
    from mmidv1_tpu_torch import make_params as tmake

    kw = dict(N=[1e6, 2e6], M_baseline=np.eye(2), beta=0.3, h=[0.1, 0.1])
    jp, tp = jmake(**kw), tmake(**kw, device="cpu")
    ts = np.arange(0.0, 10.0)
    traj = np.zeros((10, 11, 2))
    traj[:, 0] = [1e6, 2e6]
    traj[:, 5, 0] = [0, 1, 3, 5, 5, 5, 2, 1, 0, 0]        # H plateau: days 3-5
    traj[:, 6, 1] = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0]        # ICU all tied
    m_j = jmet.essential_metrics(jp, jnp.asarray(traj), jnp.asarray(ts),
                                 jnp.asarray(traj[0]))
    m_t = tmet.essential_metrics(tp, T(traj), ts, T(traj[0]))
    for k in ("time_to_peak_hospital", "peak_hospital", "time_to_peak_ICU",
              "peak_ICU"):
        assert float(m_t[k]) == float(m_j[k]), k
    assert float(m_t["time_to_peak_hospital"]) == 3.0
    assert float(m_t["time_to_peak_ICU"]) == 0.0


def test_incidence_fn_batched_matches_jax(batch):
    b = batch
    ts = make_time_grid(20.0, 100)
    kw = dict(base_initial_state=b["base"], substeps=2,
              constraint_mode=REFLECT)
    jinc = jax.vmap(build_incidence_fn(b["space"], b["params"], b["data"], ts,
                                       **kw))
    tinc = t_build_incidence_fn(b["tspace"], b["tparams"], b["tdata"], ts,
                                **kw, device="cpu")
    traj_j, daily_j = jinc(jnp.asarray(b["thetas"]))
    traj_t, daily_t = tinc(T(b["thetas"]))
    assert daily_t.shape == (8, 3, 100, 4) and traj_t.shape == (120, 8, 11, 4)
    np.testing.assert_allclose(daily_t.numpy(), np.asarray(daily_j),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(traj_t.numpy(),
                               np.moveaxis(np.asarray(traj_j), 0, 1),
                               rtol=1e-12, atol=1e-9)


# ----------------------------------------------------------- NumPy copies

def _equal(a, b):
    """Nested dicts / tuples / lists of arrays and floats, equal exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _agg_inputs(b):
    rng = np.random.default_rng(5)
    daily = rng.gamma(2.0, 3.0, (50, 3, 100, 4))
    metrics = {k: rng.normal(size=(64,)) for k in
               ("R0", "overall_IFR", "overall_attack_rate", "peak_hospital",
                "peak_ICU", "time_to_peak_hospital", "time_to_peak_ICU",
                "total_deaths", "max_Rt", "min_Rt", "final_Rt",
                "seroprevalence_day64")}
    for k in ("IFR_age", "IHR_age", "IICUR_age", "AttackRate_age"):
        metrics[k] = rng.uniform(size=(64, 4))
    metrics["kappa_values"] = rng.uniform(size=(64, 7))
    return daily, metrics, rng.normal(size=(300, 40))


def test_aggregate_copy_matches_jax(batch):
    daily, metrics, traj = _agg_inputs(batch)
    ts_obs = np.arange(100.0)
    for mod in (jagg, tagg):
        assert (mod.ENE_COVID_MEAN, mod.ENE_COVID_LOWER, mod.ENE_COVID_UPPER,
                mod.ENE_COVID_TARGET_DAY) == (0.048, 0.043, 0.054, 64.0)
    _equal(tagg.quantile_bands(daily), jagg.quantile_bands(daily))
    _equal(tagg.posterior_predictive(daily, batch["tdata"], ts_obs),
           jagg.posterior_predictive(daily, batch["data"], ts_obs))
    for n, k, s in ((1000, 100, 0), (50, 100, 3), (1000, 0, 1)):
        _equal(tagg.select_ppc_draws(n, k, s), jagg.select_ppc_draws(n, k, s))
    cols_t, cols_j = tagg.metric_table(metrics, 4), jagg.metric_table(metrics, 4)
    _equal(cols_t, cols_j)
    stats = [jagg.aggregate_batch_metrics({k: v[i::3] for k, v in cols_j.items()})
             for i in range(3)]
    _equal([tagg.aggregate_batch_metrics({k: v[i::3] for k, v in cols_t.items()})
            for i in range(3)], stats)
    summ = jagg.aggregate_all_batches(stats)
    _equal(tagg.aggregate_all_batches(stats), summ)
    _equal(tagg.ene_covid_validation(summ), jagg.ene_covid_validation(summ))
    _equal(tagg.trajectory_bands(traj, np.arange(40.0)),
           jagg.trajectory_bands(traj, np.arange(40.0)))


def test_diagnostics_copy_matches_jax():
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.normal(size=(200, 4, 3)), axis=0) * 0.1 + \
        rng.normal(size=(200, 4, 3))
    x[:, :, 2] = 1.5                                    # a frozen parameter
    for fn in ("split_rhat", "effective_sample_size", "rank_normalized_rhat"):
        _equal(getattr(tdiag, fn)(x), getattr(jdiag, fn)(x))
    _equal(tdiag.summarize(x, ["a", "b", "c"]), jdiag.summarize(x, ["a", "b", "c"]))


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_writers_copy_writes_the_same_bytes(batch, tmp_path):
    daily, metrics, traj = _agg_inputs(batch)
    ppc = jagg.posterior_predictive(daily, batch["data"], np.arange(100.0))
    cols = jagg.metric_table(metrics, 4)
    summ = jagg.aggregate_all_batches([jagg.aggregate_batch_metrics(cols)])
    bands = jagg.trajectory_bands(traj, np.arange(-20.0, 20.0))
    scen = [(n, {k: float(v[i]) for k, v in cols.items()})
            for i, n in enumerate(("baseline", "stricter", "weaker"))]
    samples = np.random.default_rng(4).normal(size=(6, 5, 3))
    for mod, out in ((jwr, tmp_path / "jax"), (twr, tmp_path / "port")):
        o = str(out)
        mod.write_posterior_predictive(os.path.join(o, "ppc"), ppc)
        mod.write_parameter_posteriors(os.path.join(o, "post"), samples,
                                       ["x", "y", "z"], burn_in=1, thinning=2)
        mod.write_batch_metrics(os.path.join(o, "b", "batch_0.csv"), cols, 4)
        mod.write_aggregated_summary(os.path.join(o, "summary.csv"), summ)
        mod.write_scenario_comparison(os.path.join(o, "scen.csv"), scen)
        mod.write_ene_covid_validation(os.path.join(o, "ene.csv"),
                                       jagg.ene_covid_validation(summ))
        mod.write_aggregated_trajectory(os.path.join(o, "rt.csv"), bands)
        mod.write_matrix_csv(os.path.join(o, "m.csv"), np.arange(3.0),
                             np.arange(12.0).reshape(3, 4) / 7)
    jt, tt = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(jt) == 36 + 2 + 6 and set(tt) == set(jt)
    for k in jt:
        assert tt[k] == jt[k], k


def test_async_writer_copy_surfaces_errors(tmp_path):
    """A failed task is recorded, later tasks still run (as
    ``test_analysis.py:225``)."""
    w = twr.AsyncWriter()
    w.submit(lambda: (_ for _ in ()).throw(OSError("disk on fire")))
    ok = tmp_path / "ok.csv"
    w.submit(twr.write_aggregated_summary, str(ok),
             {"R0": {"mean": 1.0, "median": 1.0, "std_dev": 0.0,
                     "q025": 1.0, "q975": 1.0}})
    w.wait_for_completion()
    assert ok.exists()
    assert len(w.errors) == 1 and isinstance(w.errors[0], OSError)
    w.close()
