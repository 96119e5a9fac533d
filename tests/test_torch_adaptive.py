"""The PyTorch port's adaptive integrators against the JAX package, on the CPU.

Both sides run the same controller (odeint ``integrate_times`` semantics) on
the same inputs in float64; unless an accept/reject decision flips on a
rounding difference, the trajectories agree to the last few ulps, so the bar
is rtol 1e-10. The float32 case (the ``sir_model`` main's settings) is held
at rtol 1e-5. ``batch_dims=1`` is held lane by lane against ``jax.vmap``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu import ode as jode
from mmidv1_tpu.models import sepaihrd as jsep
from mmidv1_tpu.models import sir as jsir

from mmidv1_tpu_torch import ode as tode
from mmidv1_tpu_torch.models import sepaihrd as tsep
from mmidv1_tpu_torch.models import sir as tsir

sys.path.insert(0, os.path.dirname(__file__))
from reference_impl import seeded_initial_state, solve_golden, spain_like_prm  # noqa: E402
from test_torch_model import to_torch_params  # noqa: E402

torch.set_num_threads(1)

T = lambda a, dtype=torch.float64: torch.as_tensor(np.asarray(a), dtype=dtype)
RTOL = 1e-10


def _sir_pair(N=1000.0, beta=0.4, gamma=0.04):
    jp = jsir.SIRParams(N=N, beta=beta, gamma=gamma)
    tp = tsir.SIRParams(N=N, beta=beta, gamma=gamma)
    return (lambda t, y: jsir.sir_rhs(t, y, jp),
            lambda t, y: tsir.sir_rhs(t, y, tp))


def test_scalar_sir_rkf45_matches_jax():
    """The ``sir_model`` solve: rkf45, atol 1e-6, rtol 0, dt0 0.01, daily
    grid over a year; the same 455 attempts on both sides."""
    jf, tf = _sir_pair()
    ts = np.arange(0.0, 366.0)
    y0 = np.array([999.0, 1.0, 0.0])
    kw = dict(atol=1e-6, rtol=0.0, dt0=0.01, method="rkf45")
    a = np.asarray(jode.integrate_times(jf, jnp.asarray(y0), jnp.asarray(ts), **kw))
    stats = {}
    b = tode.integrate_times(tf, T(y0), ts, stats=stats, **kw).numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-300)
    assert stats["attempts"] == 455


def test_scalar_sir_float32_matches_jax():
    """The same solve in float32, as the mains compute from the shell: the
    JAX main's 456 attempts (a float64 ``t`` would land elsewhere)."""
    jf, tf = _sir_pair()
    ts = np.arange(0.0, 366.0)
    y0 = np.array([999.0, 1.0, 0.0], np.float32)
    kw = dict(atol=1e-6, rtol=0.0, dt0=0.01, method="rkf45")
    a = np.asarray(jode.integrate_times(jf, jnp.asarray(y0),
                                        jnp.asarray(ts, jnp.float32), **kw))
    stats = {}
    b = tode.integrate_times(tf, T(y0, torch.float32), ts, stats=stats, **kw)
    assert b.dtype == torch.float32
    assert stats["attempts"] == 456
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5)


def test_fold_times_matches_jax():
    jf, tf = _sir_pair(beta=0.3, gamma=0.1)
    ts = np.arange(0.0, 120.0, 3.0)
    y0 = np.array([990.0, 10.0, 0.0])
    jfold = lambda acc, i, y: acc + (i + 1.0) * y[1]
    tfold = lambda acc, i, y: acc + (i + 1.0) * y[..., 1]
    kw = dict(atol=1e-8, rtol=1e-8, dt0=0.5, method="dopri5")
    acc_j, yf_j = jode.fold_times(jf, jnp.asarray(y0), jnp.asarray(ts), jfold,
                                  jnp.asarray(0.0), **kw)
    acc_t, yf_t = tode.fold_times(tf, T(y0), ts, tfold, T(0.0), **kw)
    np.testing.assert_allclose(float(acc_t), float(acc_j), rtol=RTOL)
    np.testing.assert_allclose(yf_t.numpy(), np.asarray(yf_j), rtol=RTOL)
    # the fold sees exactly the stacked trajectory's points
    traj = tode.integrate_times(tf, T(y0), ts, **kw)
    want = sum((i + 1.0) * float(traj[i, 1]) for i in range(len(ts)))
    np.testing.assert_allclose(float(acc_t), want, rtol=1e-14)


@pytest.mark.parametrize("tol", [1e-6, 1e-9])
def test_adaptive_tolerance_scaling(tol):
    """``tests/test_integrators.py:48``: the error scales with the tolerance,
    and the port equals the JAX solve."""
    jf = lambda t, y: -y + jnp.sin(t)
    tf = lambda t, y: -y + torch.sin(t)
    ts = np.array([0.0, 4.0])
    t = 4.0
    exact = (np.sin(t) - np.cos(t)) / 2 + 1.5 * np.exp(-t)
    a = np.asarray(jode.integrate_times(jf, jnp.ones((1,)), jnp.asarray(ts),
                                        atol=tol, rtol=tol))
    b = tode.integrate_times(tf, torch.ones(1, dtype=torch.float64), ts,
                             atol=tol, rtol=tol).numpy()
    assert abs(b[-1, 0] - exact) < 50 * tol
    np.testing.assert_allclose(b, a, rtol=RTOL)


def test_fehlberg78_matches_jax():
    """``tests/test_integrators.py:59`` (fehlberg78 on y' = -y), fixed and
    adaptive (its 8th-order controller exponents)."""
    jf = lambda t, y: -y
    tf = lambda t, y: -y
    y0 = np.ones(1)
    ts = np.array([0.0, 1.0])
    fixed = tode.integrate_times_fixed(tf, T(y0), ts, substeps=4,
                                       method="fehlberg78")
    np.testing.assert_allclose(float(fixed[-1, 0]), np.exp(-1.0), rtol=1e-10)
    ts = np.linspace(0.0, 5.0, 6)
    a = np.asarray(jode.integrate_times(jf, jnp.asarray(y0), jnp.asarray(ts),
                                        atol=1e-12, rtol=1e-12,
                                        method="fehlberg78"))
    b = tode.integrate_times(tf, T(y0), ts, atol=1e-12, rtol=1e-12,
                             method="fehlberg78").numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL)
    np.testing.assert_allclose(b[:, 0], np.exp(-ts), rtol=1e-10)


@pytest.fixture(scope="module")
def spain_setup():
    prm = spain_like_prm()
    y0 = seeded_initial_state(prm)
    ts = np.arange(-20.0, 71.0)
    return prm, y0, ts, solve_golden(prm, y0, ts)


def test_spain_adaptive_matches_golden_and_jax(spain_setup, spain_params):
    """``tests/test_integrators.py:113``: SEPAIHRD ``solve(method="adaptive",
    atol=rtol=1e-9)`` against the independent golden at rtol 1e-6, and
    against the JAX solve."""
    prm, y0, ts, gold = spain_setup
    _prm, params = spain_params
    a = np.asarray(jsep.solve(params, jnp.asarray(y0), ts, method="adaptive",
                              atol=1e-9, rtol=1e-9))
    b = tsep.solve(to_torch_params(params), T(y0), ts, method="adaptive",
                   atol=1e-9, rtol=1e-9).numpy()
    relerr = np.max(np.abs(b - gold) / (np.abs(gold) + 1e-8 * np.max(gold)))
    assert relerr < 1e-6, relerr
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-12 * np.abs(a).max())


def test_batch_dims_matches_vmap():
    """Each lane gets its own controller: ``batch_dims=1`` equals
    ``jax.vmap(integrate_times)`` lane by lane, and each lane solved
    alone."""
    betas = np.array([0.15, 0.3, 0.5, 0.9, 1.6])
    y0 = np.array([990.0, 10.0, 0.0])
    ts = np.arange(0.0, 60.0, 2.0)
    kw = dict(atol=1e-8, rtol=1e-8, dt0=1.0, method="dopri5")

    def jsolve(beta):
        f = lambda t, y: jsir.sir_rhs(t, y, jsir.SIRParams(N=1000.0, beta=beta,
                                                           gamma=0.1))
        return jode.integrate_times(f, jnp.asarray(y0), jnp.asarray(ts), **kw)

    a = np.asarray(jax.vmap(jsolve)(jnp.asarray(betas)))        # (B, T, 3)
    tp = tsir.SIRParams(N=1000.0, beta=T(betas), gamma=0.1)
    stats = {}
    b = tode.integrate_times(lambda t, y: tsir.sir_rhs(t, y, tp),
                             T(y0).expand(len(betas), 3), ts, batch_dims=1,
                             stats=stats, **kw)
    np.testing.assert_allclose(b.numpy().transpose(1, 0, 2), a, rtol=RTOL)
    attempts = []
    for i, beta in enumerate(betas):
        one = {}
        lone = tode.integrate_times(
            lambda t, y: tsir.sir_rhs(t, y, tsir.SIRParams(1000.0, beta, 0.1)),
            T(y0), ts, stats=one, **kw)
        np.testing.assert_allclose(b[:, i].numpy(), lone.numpy(), rtol=1e-12)
        attempts.append(one["attempts"])
    # the batch loops as long as its slowest lane, interval by interval
    assert max(attempts) <= stats["attempts"] <= sum(attempts)


def test_max_steps_exhaustion_poisons_with_nan():
    """A lane that cannot land within ``max_steps`` attempts comes out NaN
    from the interval on, in both packages; the other lanes are untouched."""
    jf = lambda t, y: -50.0 * y
    tf = lambda t, y: -50.0 * y
    ts = np.array([0.0, 1.0, 2.0])
    kw = dict(atol=1e-10, rtol=1e-10, dt0=0.01, method="dopri5", max_steps=5)
    a = np.asarray(jode.integrate_times(jf, jnp.ones((2,)), jnp.asarray(ts),
                                        **kw))
    b = tode.integrate_times(tf, torch.ones(2, dtype=torch.float64), ts,
                             **kw).numpy()
    assert np.isnan(a[1:]).all() and np.isnan(b[1:]).all()
    np.testing.assert_array_equal(b[0], a[0])
    # per lane: only the stiff lane fails
    rates = T([[1.0], [5000.0]])
    y = tode.integrate_times(lambda t, y: -rates * y,
                             torch.ones(2, 1, dtype=torch.float64), ts,
                             batch_dims=1, atol=1e-6, rtol=1e-6, dt0=0.5,
                             max_steps=40).numpy()
    assert np.isfinite(y[:, 0]).all() and np.isnan(y[1:, 1]).all()


def test_tableau_without_error_estimate_raises():
    with pytest.raises(ValueError, match="no embedded error estimate"):
        jode.integrate_times(lambda t, y: -y, jnp.ones((1,)),
                             jnp.asarray([0.0, 1.0]), method="rk4")
    for fn in (tode.integrate_times, tode.fold_times):
        args = (lambda acc, i, y: acc, 0.0) if fn is tode.fold_times else ()
        with pytest.raises(ValueError, match="no embedded error estimate"):
            fn(lambda t, y: -y, torch.ones(1, dtype=torch.float64),
               [0.0, 1.0], *args, method="rk4")
