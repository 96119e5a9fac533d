"""Exact gradients through the port's eager solve, and NUTS on the real
SEPAIHRD objective: ``tests/test_gradients.py`` on the PyTorch port.

The 30-day, 5-parameter problem is built by ``tests/torch_recovery.py``; a
fast test holds it against the JAX package's (float64: the objective and
its gradient). The NUTS run draws from torch's Philox where the JAX test
draws from threefry, so it is statistical: same settings, same bars.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.objective import build_objective as jbuild
from mmidv1_tpu.calibration.objective import make_time_grid as jgrid
from mmidv1_tpu.calibration.param_space import ParameterSpace as JSpace
from mmidv1_tpu.data import CalibrationData as JData

from mmidv1_tpu_torch.calibration import CLAMP, build_objective
from mmidv1_tpu_torch.calibration.nuts import value_and_grad_of

sys.path.insert(0, os.path.dirname(__file__))
import torch_recovery as rec  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grad_setup():
    problem = rec.r3_problem()
    loglik = build_objective(problem["space"], problem["params"],
                             problem["data"], problem["ts"],
                             substeps=rec.SUBSTEPS, constraint_mode=CLAMP)
    return problem, loglik


def _jax_objective(spain_params):
    """``tests/test_gradients.py:16-35``'s objective and start."""
    prm, params = spain_params
    obs = np.random.default_rng(rec.R3_DATA_SEED).poisson(
        8.0, size=(rec.R3_DAYS, 4)).astype(float)
    data = JData.from_arrays(new_confirmed=obs, new_hospitalizations=obs,
                             new_icu=obs * 0.2, new_deaths=obs * 0.1,
                             population_by_age=prm["N"])
    bounds = {n: (0.001, 3.0) for n in rec.R3_NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = JSpace.create(rec.R3_NAMES, bounds,
                          {n: 0.05 for n in rec.R3_NAMES}, params)
    ts = jgrid(prm["runup_days"], rec.R3_DAYS)
    loglik = jbuild(space, params, data, ts, substeps=rec.SUBSTEPS,
                    constraint_mode=CLAMP)
    return loglik, space, space.extract(params), obs, ts


def test_gradient_inputs_match_jax(spain_params, grad_setup):
    """R3's observations, space and start equal the JAX test's; the
    objective at the start and at two points near it agrees at rtol 1e-10,
    its gradient at the start at rtol 1e-9."""
    problem, loglik = grad_setup
    jll, jspace, jtheta0, obs, ts = _jax_objective(spain_params)
    np.testing.assert_array_equal(problem["obs"], obs)
    np.testing.assert_array_equal(problem["ts"], ts)
    for f in ("lower", "upper", "sigmas"):
        np.testing.assert_array_equal(getattr(problem["space"], f).numpy(),
                                      np.asarray(getattr(jspace, f)))
    np.testing.assert_array_equal(problem["theta0"].numpy(),
                                  np.asarray(jtheta0))
    rng = np.random.default_rng(1)
    thetas = np.asarray(jtheta0)[None, :] * (
        1.0 + np.concatenate([np.zeros((1, 5)),
                              rng.uniform(-0.05, 0.05, (2, 5))]))
    want = [float(jll(jnp.asarray(th))) for th in thetas]
    np.testing.assert_allclose(loglik(torch.as_tensor(thetas)).numpy(), want,
                               rtol=1e-10)
    g_want = np.asarray(jax.grad(jll)(jtheta0))
    _v, g = value_and_grad_of(loglik)(problem["theta0"][None, :])
    np.testing.assert_allclose(g[0].numpy(), g_want, rtol=1e-9, atol=1e-9)


def test_exact_gradient_matches_finite_differences(grad_setup):
    """``tests/test_gradients.py:38-53`` on the port: autograd through the
    eager solve and fold equals central finite differences."""
    problem, loglik = grad_setup
    theta0 = problem["theta0"]
    _v, g = value_and_grad_of(loglik)(theta0[None, :])
    g = g[0].numpy()
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    th0 = theta0.numpy()
    for j in range(len(th0)):
        h = 1e-5 * max(abs(th0[j]), 1e-3)
        e = np.zeros_like(th0)
        e[j] = h
        pair = loglik(torch.as_tensor(np.stack([th0 + e, th0 - e]))).numpy()
        fd = (pair[0] - pair[1]) / (2 * h)
        np.testing.assert_allclose(g[j], fd, rtol=5e-4, atol=1e-3,
                                   err_msg=rec.R3_NAMES[j])


def test_value_and_grad_batched(grad_setup):
    """``tests/test_gradients.py:56-67`` on the port: batched gradients are
    finite, and a chain's equals its gradient alone (rtol 1e-10)."""
    problem, loglik = grad_setup
    theta0 = problem["theta0"]
    noise = torch.randn((4, theta0.numel()), dtype=theta0.dtype,
                        generator=torch.Generator().manual_seed(0))
    thetas = theta0[None, :] + 0.01 * noise
    vag = value_and_grad_of(loglik)
    vals, grads = vag(thetas)
    assert torch.isfinite(vals).all() and torch.isfinite(grads).all()
    _v0, g0 = vag(thetas[:1])
    np.testing.assert_allclose(grads[0].numpy(), g0[0].numpy(), rtol=1e-10)


@pytest.mark.slow
def test_nuts_on_real_objective(grad_setup):
    """``tests/test_gradients.py:70-84`` on the port: NUTS (25 iterations,
    adaptation 10, depth 3, 4 chains) samples the real SEPAIHRD posterior
    through autograd of the eager objective."""
    problem, loglik = grad_setup
    res = rec.r3_nuts(loglik, problem)
    ll0 = float(loglik(problem["theta0"][None, :])[0])
    missed = rec.r3_missed(res.best_logp, res.samples.numpy(),
                           problem["space"].lower.numpy(),
                           problem["space"].upper.numpy(), ll0)
    assert not missed, (missed, float(res.best_logp))
