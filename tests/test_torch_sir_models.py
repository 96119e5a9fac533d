"""The PyTorch port's SIR family against the JAX package, on the CPU.

Deterministic parts (the right-hand sides, equilibria, interventions, the
scheduled split simulation, incidence) run the same float64 operations on
both sides: rtol 1e-12. The random runs take their draws from outside; fed
the JAX package's own draws (its key splits reproduced here), the binomial
chain and the Gillespie run give JAX's trajectories exactly. On the port's
own generator they are held statistically: the mean final R within 5
standard errors of the JAX runs', the population conserved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.models import interventions as jint
from mmidv1_tpu.models import sir as jsir

from mmidv1_tpu_torch.models import interventions as tint
from mmidv1_tpu_torch.models import sir as tsir
from mmidv1_tpu_torch.utils.exceptions import InterventionException

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
AGE = dict(N=[1000.0, 2000.0], C=[[2.0, 1.0], [0.5, 1.5]], q=0.1,
           gamma=[0.2, 0.1])
Y_AGE = [[900.0, 1800.0], [50.0, 100.0], [50.0, 100.0]]


def _age_pair(**kw):
    kw = dict(AGE, **kw)
    return (jsir.make_age_sir_params(**kw),
            tsir.make_age_sir_params(**kw, device="cpu"))


@pytest.mark.parametrize("which", ["sir", "vital"])
def test_scalar_rhs_matches_jax(which):
    rng = np.random.default_rng(0)
    p = dict(N=1000.0, beta=0.4, gamma=0.04, B=20.0, mu=0.01)
    jf = {"sir": jsir.sir_rhs, "vital": jsir.sir_vital_rhs}[which]
    tf = {"sir": tsir.sir_rhs, "vital": tsir.sir_vital_rhs}[which]
    ys = rng.uniform(0.0, 1000.0, (6, 3))
    for y in ys:
        a = np.asarray(jf(0.0, jnp.asarray(y), jsir.SIRParams(**p)))
        b = tf(0.0, T(y), tsir.SIRParams(**p)).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12)
    # a batch of states with a batch of betas: each row as alone
    betas = rng.uniform(0.1, 1.0, 6)
    b = tf(0.0, T(ys), tsir.SIRParams(**dict(p, beta=T(betas)))).numpy()
    for i in range(6):
        a = np.asarray(jf(0.0, jnp.asarray(ys[i]),
                          jsir.SIRParams(**dict(p, beta=betas[i]))))
        np.testing.assert_allclose(b[i], a, rtol=1e-12)
    # the zero-population guard
    z = tf(0.0, T([0.0, 0.0, 0.0]), tsir.SIRParams(**dict(p, N=0.0))).numpy()
    assert np.isfinite(z).all()


def test_equilibria_match_jax():
    for p in (dict(N=1000.0, beta=0.4, gamma=0.04, B=20.0, mu=0.01),
              dict(N=1000.0, beta=0.01, gamma=0.04, B=20.0, mu=0.01),
              dict(N=1000.0, beta=0.4, gamma=0.04)):
        a, b = jsir.equilibria(jsir.SIRParams(**p)), \
            tsir.equilibria(tsir.SIRParams(**p))
        assert a == b
    eq = tsir.equilibria(tsir.SIRParams(N=1000.0, beta=0.4, gamma=0.04,
                                        B=20.0, mu=0.01))
    d = tsir.sir_vital_rhs(0.0, T(eq["endemic"]), tsir.SIRParams(
        N=1000.0, beta=0.4, gamma=0.04, B=20.0, mu=0.01)).numpy()
    np.testing.assert_allclose(d, 0.0, atol=1e-9)


def test_age_sir_hand_computed_derivatives():
    """``tests/test_sir_models.py:84`` (AgeSIRModelTest.cpp:109) on the
    port, and the JAX RHS on the same state."""
    jp, tp = _age_pair()
    d = tsir.age_sir_rhs(0.0, T(Y_AGE), tp).numpy()
    I_over_N = np.array([50.0 / 1000.0, 100.0 / 2000.0])
    lam = 0.1 * (np.array(AGE["C"]) @ I_over_N)
    S, I = np.array([900.0, 1800.0]), np.array([50.0, 100.0])
    g = np.array(AGE["gamma"])
    np.testing.assert_allclose(d[0], -lam * S, rtol=1e-12)
    np.testing.assert_allclose(d[1], lam * S - g * I, rtol=1e-12)
    np.testing.assert_allclose(d[2], g * I, rtol=1e-12)
    np.testing.assert_allclose(
        d, np.asarray(jsir.age_sir_rhs(0.0, jnp.asarray(Y_AGE), jp)),
        rtol=1e-12)


def test_age_sir_batched_params_match_vmap():
    """q / scale_C ``(B,)`` and gamma ``(B, A)`` as ``ParameterSpace.apply``
    makes them: each lane equals the JAX RHS and incidence of that lane."""
    rng = np.random.default_rng(1)
    B = 5
    jp, tp = _age_pair()
    q, sc = rng.uniform(0.05, 0.2, B), rng.uniform(0.5, 2.0, B)
    g = rng.uniform(0.05, 0.3, (B, 2))
    ys = rng.uniform(1.0, 900.0, (B, 3, 2))
    tb = tp.replace(q=T(q), scale_C=T(sc), gamma=T(g))
    d = tsir.age_sir_rhs(0.0, T(ys), tb).numpy()
    traj = T(ys)[None].expand(3, B, 3, 2)              # (T, B, 3, A)
    inc = tsir.sir_incidence(tb, traj).numpy()          # (T, B, A)
    for i in range(B):
        pi = jp.replace(q=jnp.asarray(q[i]), scale_C=jnp.asarray(sc[i]),
                        gamma=jnp.asarray(g[i]))
        np.testing.assert_allclose(
            d[i], np.asarray(jsir.age_sir_rhs(0.0, jnp.asarray(ys[i]), pi)),
            rtol=1e-12)
        ji = np.asarray(jsir.sir_incidence(pi, jnp.asarray(ys[i])[None]))
        np.testing.assert_allclose(inc[:, i], np.repeat(ji, 3, axis=0),
                                   rtol=1e-12)


def test_age_sir_zero_population_guard():
    jp, tp = _age_pair(N=[0.0, 2000.0], C=np.eye(2), gamma=[0.1, 0.1])
    y = [[0.0, 1800.0], [0.0, 100.0], [0.0, 100.0]]
    d = tsir.age_sir_rhs(0.0, T(y), tp).numpy()
    assert np.isfinite(d).all()
    np.testing.assert_allclose(d[:, 0], 0.0)
    np.testing.assert_array_equal(
        d, np.asarray(jsir.age_sir_rhs(0.0, jnp.asarray(y), jp)))


def test_interventions_and_exception_texts():
    jp, tp = _age_pair(N=[1000.0], C=[[1.0]], q=0.2, gamma=[0.1])
    for name, value in (("lockdown", 0.5), ("mask_mandate", 0.3),
                        ("social_distancing", 2.0),
                        ("transmission_reduction", 1.0)):
        a = jsir.apply_age_sir_intervention(jp, name, value)
        b = tsir.apply_age_sir_intervention(tp, name, value)
        assert float(b.q) == float(a.q)
        assert float(b.scale_C) == float(a.scale_C)
    assert float(tp.q) == 0.2     # the original parameters are untouched
    for name, value in (("teleportation", 0.5), ("mask_mandate", 1.5),
                        ("lockdown", -0.1)):
        with pytest.raises(Exception) as ja:
            jsir.apply_age_sir_intervention(jp, name, value)
        with pytest.raises(InterventionException) as ta:
            tsir.apply_age_sir_intervention(tp, name, value)
        assert str(ta.value) == str(ja.value)
    with pytest.raises(ValueError, match="contact matrix shape"):
        tsir.make_age_sir_params(N=[100.0, 200.0], C=[[1.0]], q=0.1,
                                 gamma=[0.1, 0.1], device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        tsir.make_age_sir_params(N=[100.0], C=[[1.0]], q=-0.1, gamma=[0.1],
                                 device="cpu")


def test_scheduled_split_simulation_matches_jax():
    kw = dict(N=[1e6, 1e6], C=[[3.0, 1.0], [1.0, 2.0]], q=0.05,
              gamma=[0.1, 0.1])
    jp, tp = _age_pair(**kw)
    y0 = [[1e6 - 10, 1e6], [10.0, 0.0], [0.0, 0.0]]
    ts = np.arange(0.0, 61.0)
    sched = [(45.0, "mask_mandate", 0.2), (20.0, "contact_reduction", 0.3),
             (-1.0, "lockdown", 0.9), (30.0, "nonsense", 1.0),
             (100.0, "lockdown", 0.1)]
    a, pa = jint.solve_age_sir_scheduled(jp, jnp.asarray(y0), ts,
                                         [jint.Intervention(*s) for s in sched],
                                         substeps=2)
    b, pb = tint.solve_age_sir_scheduled(tp, T(y0), ts,
                                         [tint.Intervention(*s) for s in sched],
                                         substeps=2)
    assert b.shape == (61, 3, 2)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)
    assert float(pb.scale_C) == float(pa.scale_C) == pytest.approx(0.27)
    assert float(pb.q) == float(pa.q)
    with pytest.raises(InterventionException):
        tint.solve_age_sir_scheduled(tp, T(y0), ts,
                                     [tint.Intervention(10.0, "nonsense", 1.0)],
                                     strict=True)
    with pytest.raises(InterventionException, match="Non-finite"):
        tint.validate_schedule([(float("nan"), "lockdown", 0.5)])


def test_sir_incidence_is_minus_dS():
    jp, tp = _age_pair()
    inc = tsir.sir_incidence(tp, T(Y_AGE)[None]).numpy()
    d = tsir.age_sir_rhs(0.0, T(Y_AGE), tp).numpy()
    np.testing.assert_allclose(inc[0], -d[0], rtol=1e-12)
    np.testing.assert_allclose(
        inc, np.asarray(jsir.sir_incidence(jp, jnp.asarray(Y_AGE)[None])),
        rtol=1e-12)


# --------------------------------------------------------------------------
# The random runs, fed the JAX package's draws
# --------------------------------------------------------------------------

def _jax_binomial(key, sims, steps):
    """``binomial(count, prob)`` giving the draws of
    ``mmidv1_tpu.models.sir.run_stochastic_sir``: ``split(key, sims)``, then
    ``split(k, steps)`` a simulation, then ``split(kk)`` -> k1, k2 a step."""
    step_keys = jax.vmap(lambda k: jax.random.split(k, steps))(
        jax.random.split(key, sims))
    pairs = jax.vmap(jax.vmap(jax.random.split))(step_keys)   # (sims, steps, 2, 2)
    draw = jax.jit(jax.vmap(jax.random.binomial))
    calls = [0]

    def binomial(count, prob):
        i, which = divmod(calls[0], 2)
        calls[0] += 1
        return T(draw(pairs[:, i, which], jnp.asarray(count.numpy()),
                      jnp.asarray(prob.numpy())))
    return binomial


def _jax_events(key, sims):
    """``event_draws(e)`` giving the draws of
    ``mmidv1_tpu.models.sir.run_gillespie_sir``: every event of a simulation
    splits its key in three, (exponential, uniform, next key)."""
    keys = [jax.random.split(key, sims)]
    split3 = jax.jit(jax.vmap(lambda k: jax.random.split(k, 3)))
    exp = jax.jit(jax.vmap(lambda k: jax.random.exponential(k)))
    unif = jax.jit(jax.vmap(lambda k: jax.random.uniform(k)))

    def event_draws(e):
        ks = split3(keys[0])
        keys[0] = ks[:, 2]
        return T(exp(ks[:, 0])), T(unif(ks[:, 1]))
    return event_draws


def test_binomial_chain_equals_jax_given_its_draws():
    p = dict(N=1000.0, beta=0.4, gamma=0.1)
    y0, sims = [990.0, 10.0, 0.0], 16
    key = jax.random.PRNGKey(3)
    a = np.asarray(jsir.run_stochastic_sir(jsir.SIRParams(**p), y0, 0.0, 40.0,
                                           0.5, sims, key))
    b = tsir.run_stochastic_sir(tsir.SIRParams(**p), y0, 0.0, 40.0, 0.5, sims,
                                binomial=_jax_binomial(key, sims, 80),
                                device="cpu").numpy()
    assert b.shape == a.shape == (sims, 81, 3)
    np.testing.assert_array_equal(b, a)
    # the run goes somewhere, and some chains freeze (S or I empty)
    assert a[:, -1, 2].max() > 500.0


def test_gillespie_equals_jax_given_its_draws():
    p = dict(N=300.0, beta=0.5, gamma=0.1)
    y0, sims = [290.0, 10.0, 0.0], 12
    key = jax.random.PRNGKey(1)
    a = np.asarray(jsir.run_gillespie_sir(jsir.SIRParams(**p), y0, 0.0, 30.0,
                                          31, sims, key))
    b = tsir.run_gillespie_sir(tsir.SIRParams(**p), y0, 0.0, 30.0, 31, sims,
                               event_draws=_jax_events(key, sims),
                               device="cpu").numpy()
    assert b.shape == a.shape == (sims, 31, 3)
    np.testing.assert_array_equal(b, a)


def _mean_final_R_close(a, b, n_se=5.0):
    ra, rb = a[:, -1, 2], b[:, -1, 2]
    se = np.sqrt(ra.var(ddof=1) / len(ra) + rb.var(ddof=1) / len(rb))
    assert abs(ra.mean() - rb.mean()) < n_se * se, (ra.mean(), rb.mean(), se)


def test_binomial_chain_statistics_on_own_generator():
    p = dict(N=1000.0, beta=0.4, gamma=0.1)
    y0, sims = [990.0, 10.0, 0.0], 128
    a = np.asarray(jsir.run_stochastic_sir(jsir.SIRParams(**p), y0, 0.0, 40.0,
                                           0.5, sims, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    b = tsir.run_stochastic_sir(tsir.SIRParams(**p), y0, 0.0, 40.0, 0.5, sims,
                                generator=gen, device="cpu").numpy()
    assert b.shape == (sims, 81, 3) and (b >= 0).all()
    np.testing.assert_allclose(b.sum(axis=2), 1000.0, rtol=1e-12)
    _mean_final_R_close(a, b)
    stats = tsir.stochastic_statistics(b)
    assert stats["p05"].shape == (81, 3)
    assert (stats["p05"] <= stats["median"] + 1e-9).all()
    assert (stats["median"] <= stats["p95"] + 1e-9).all()
    # NumPy only: the same numbers as the JAX package's summary
    js = jsir.stochastic_statistics(b)
    for k in js:
        np.testing.assert_array_equal(stats[k], js[k])


def test_gillespie_statistics_on_own_generator():
    p = dict(N=300.0, beta=0.5, gamma=0.1)
    y0, sims = [290.0, 10.0, 0.0], 64
    a = np.asarray(jsir.run_gillespie_sir(jsir.SIRParams(**p), y0, 0.0, 30.0,
                                          31, sims, jax.random.PRNGKey(1)))
    gen = torch.Generator().manual_seed(1)
    b = tsir.run_gillespie_sir(tsir.SIRParams(**p), y0, 0.0, 30.0, 31, sims,
                               generator=gen, device="cpu").numpy()
    np.testing.assert_allclose(b.sum(axis=2), 300.0, rtol=1e-12)
    assert (np.diff(b[:, :, 0], axis=1) <= 1e-9).all()
    assert (np.diff(b[:, :, 2], axis=1) >= -1e-9).all()
    _mean_final_R_close(a, b)
