"""The port's MALA against the JAX package's, in float64 on the CPU.

Each step is fed the draws the JAX step makes from its key
(``_shard_invariant_draws``): given the same draws and state, both sides run
the same float64 arithmetic, so the bar is rtol 1e-12. The target is a
Gaussian with its analytic gradient over a real ``ParameterSpace``, centred
near a wall so that some proposals leave the box and are rejected.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import mala as jmala
from mmidv1_tpu.calibration import mh as jmh
from mmidv1_tpu.calibration.param_space import ParameterSpace

from mmidv1_tpu_torch.calibration import mala as tmala

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402
from test_torch_nuts import NAMES, T  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def target(spain_params):
    _prm, params = spain_params
    bounds = {n: (0.01, 2.0) for n in NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    sig = {n: 0.05 for n in NAMES}
    sig["seed_exposed"] = 5.0
    space = ParameterSpace.create(NAMES, bounds, sig, params)
    tparams = to_torch_params(params)
    theta0 = np.asarray(space.extract(params), dtype=np.float64)
    mean = theta0.copy()
    mean[0] = 0.02
    scale = 2.0 * np.asarray(space.sigmas)
    mean_t, scale_t = torch.as_tensor(mean), torch.as_tensor(scale)

    def vag_j(th):
        z = (th - mean) / scale
        return -0.5 * jnp.sum(z * z, axis=-1), -z / scale

    def vag_t(th):
        z = (th - mean_t) / scale_t
        return -0.5 * torch.sum(z * z, dim=-1), -z / scale_t

    return dict(space=space, tspace=to_torch_space(space, tparams),
                theta0=theta0, vag_j=vag_j, vag_t=vag_t)


def _to_torch(s):
    return tmala.MALAState(
        x=T(s.x), logp=T(s.logp), grad=T(s.grad), log_eps=T(s.log_eps),
        chol=T(s.chol), cov=T(s.cov), best_x=T(s.best_x),
        best_logp=T(s.best_logp), accept_count=T(s.accept_count),
        step=int(s.step))


def _assert_equal(ts_, js):
    for f in ("x", "logp", "grad", "log_eps", "chol", "cov", "best_x",
              "best_logp"):
        np.testing.assert_allclose(getattr(ts_, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-12,
                                   atol=1e-300, err_msg=f)
    np.testing.assert_array_equal(ts_.accept_count.numpy(),
                                  np.asarray(js.accept_count))
    assert ts_.step == int(js.step)


def test_mala_steps_match_jax_given_draws(target):
    """Init (jitter, reflection, initial preconditioner), four steps and a
    preconditioner re-estimate, each given JAX's draws."""
    space, tspace = target["space"], target["tspace"]
    B, d = 12, space.dim
    cfg = jmala.MALAConfig(initial_step_size=3.0)
    tcfg = tmala.MALAConfig(initial_step_size=3.0)
    jeval = jmala._bounded_value_and_grad(space, target["vag_j"],
                                          cfg.grad_clip_norm)
    teval = tmala._bounded_value_and_grad(tspace, target["vag_t"],
                                          tcfg.grad_clip_norm)
    key = jax.random.PRNGKey(0)
    js = jmala.init_mala_state(space, jnp.asarray(target["theta0"]), jeval,
                               key, B, jitter=2.0, cfg=cfg)
    noise, _u = jmh._shard_invariant_draws(key, B, 0, B, d, jnp.float64)
    ts_ = tmala.init_mala_state(tspace, T(target["theta0"]), teval, T(noise),
                                jitter=2.0, cfg=tcfg)
    _assert_equal(ts_, js)
    for k in range(4):
        sk = jax.random.PRNGKey(10 + k)
        z, u = jmh._shard_invariant_draws(sk, B, 0, B, d, jnp.float64)
        js = jmala.mala_step(js, sk, space, jeval, cfg)
        ts_ = tmala.mala_step(ts_, T(z), T(u), tspace, teval, tcfg)
        _assert_equal(ts_, js)
    acc = ts_.accept_count.numpy()
    assert 0 < acc.sum() < 4 * B          # both branches exercised
    _assert_equal(tmala.adapt_preconditioner(ts_, tcfg),
                  jmala.adapt_preconditioner(js, cfg))


def test_mala_clip_and_bounds_match_jax(target):
    space, tspace = target["space"], target["tspace"]
    rng = np.random.default_rng(1)
    g = rng.standard_normal((5, space.dim)) * np.array([1, 1e4, 1, 1, 1, 1, 1, 1])
    g[2, 3] = np.nan
    np.testing.assert_allclose(tmala._clip_grad(T(g), 1000.0).numpy(),
                               np.asarray(jmala._clip_grad(jnp.asarray(g),
                                                           1000.0)),
                               rtol=1e-12)
    x = np.tile(target["theta0"], (3, 1))
    x[1, 0] = -1.0                        # outside the box: hard reject
    lj, gj = jmala._bounded_value_and_grad(space, target["vag_j"], 1000.0)(
        jnp.asarray(x))
    lt, gt = tmala._bounded_value_and_grad(tspace, target["vag_t"], 1000.0)(
        T(x))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-12)
    assert float(lt[1]) == -1e18 and (gt[1] == 0).all()


def test_run_mala_runs(target):
    """run_mala end to end with its own generator: thinned shapes, finite
    samples inside the box, adaptation after burn-in, progress reports."""
    tspace = target["tspace"]
    seen = []
    cfg = tmala.MALAConfig(iterations=12, burn_in=4, adaptation_period=4,
                           thinning=2, initial_step_size=0.5,
                           report_interval=2)
    res = tmala.run_mala(None, tspace, T(target["theta0"]), cfg,
                         generator=torch.Generator().manual_seed(0),
                         n_chains=6, value_and_grad_batch=target["vag_t"],
                         progress_fn=lambda *a: seen.append(a))
    assert res.samples.shape == (6, 6, tspace.dim)
    assert torch.isfinite(res.samples).all()
    assert bool(tspace.in_bounds(res.samples.reshape(-1, tspace.dim)).all())
    assert res.final_state.step == 12 and len(seen) == 3
    assert not torch.equal(res.final_cov, torch.diag(tspace.sigmas ** 2 + 1e-6))
    assert float(res.best_logp) == float(res.final_state.best_logp.max())
