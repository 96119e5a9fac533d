"""The port's NUTS against the JAX package's, in float64 on the CPU.

JAX's threefry stream cannot be reproduced in PyTorch, so the port is fed
the draws the JAX sampler makes from its key (``nuts.py:382, 414, 430-434``
and ``_build_tree``'s leaf keys). Given the same draws, both sides run the
same float64 arithmetic on a cheap smooth target: a Gaussian with its
analytic gradient over a real ``ParameterSpace`` (so the leapfrog's clamp
binds), and the bar is rtol 1e-12.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import nuts as jnuts
from mmidv1_tpu.calibration.objective import make_time_grid
from mmidv1_tpu.calibration.param_space import CLAMP, ParameterSpace

from mmidv1_tpu_torch.calibration import calibrator as tcal
from mmidv1_tpu_torch.calibration import nuts as tnuts
from mmidv1_tpu_torch.ops import build_objective_fused, build_objective_fused_grad

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402
from test_torch_objective import _data_pair  # noqa: E402

torch.set_num_threads(1)
T = lambda a: torch.as_tensor(np.array(a))

NAMES = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2", "kappa_2",
         "sigma"]


@pytest.fixture(scope="module")
def target(spain_params):
    """A Gaussian log-density over the 8-name space, centred near a wall of
    beta_1 so that trajectories hit the clamp."""
    _prm, params = spain_params
    bounds = {n: (0.01, 2.0) for n in NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    sig = {n: 0.05 for n in NAMES}
    sig["seed_exposed"] = 5.0
    space = ParameterSpace.create(NAMES, bounds, sig, params)
    tparams = to_torch_params(params)
    tspace = to_torch_space(space, tparams)
    theta0 = np.asarray(space.extract(params), dtype=np.float64)
    mean = theta0.copy()
    mean[0] = 0.02
    scale = 2.0 * np.asarray(space.sigmas)

    def vag_j(th):
        z = (th - mean) / scale
        return -0.5 * jnp.sum(z * z, axis=-1), -z / scale

    mean_t, scale_t = torch.as_tensor(mean), torch.as_tensor(scale)

    def vag_t(th):
        z = (th - mean_t) / scale_t
        return -0.5 * torch.sum(z * z, dim=-1), -z / scale_t

    return dict(space=space, tspace=tspace, theta0=theta0, vag_j=vag_j,
                vag_t=vag_t, params=params, tparams=tparams)


class JaxDraws:
    """The draws ``mmidv1_tpu.calibration.nuts.run_nuts`` makes from ``key``,
    as the port's draw source."""

    def __init__(self, key, B, d, cfg):
        self.B, self.d, self.cfg = B, d, cfg
        self.k_init, self.k_eps, k_run = jax.random.split(key, 3)
        self.keys = jax.random.split(k_run, cfg.iterations)

    def jitter(self):
        return T(jax.random.normal(self.k_init, (self.B, self.d), jnp.float64))

    def eps_momentum(self):
        return T(jax.random.normal(self.k_eps, (self.B, self.d), jnp.float64))

    def iteration(self, it):
        B, dt = self.B, jnp.float64
        k_r, k_u, k_tree = jax.random.split(self.keys[it], 3)
        v, leaf, acc = [], [], []
        for j, kj in enumerate(jax.random.split(k_tree,
                                                self.cfg.max_tree_depth)):
            kv, kt, ks = jax.random.split(kj, 3)
            v.append(jax.random.uniform(kv, (B,), dt))
            leaf.append(T(jnp.stack([jax.random.uniform(k, (B,), dt)
                                     for k in jax.random.split(kt, 1 << j)])))
            acc.append(jax.random.uniform(ks, (B,), dt))
        return tnuts.NUTSDraws(
            r0=T(jax.random.normal(k_r, (B, self.d), dt)),
            u=T(jax.random.uniform(k_u, (B,), dt, minval=1e-12)),
            v=T(jnp.stack(v)), leaf_u=tuple(leaf), accept_u=T(jnp.stack(acc)))


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=1e-12,
                               atol=1e-300, err_msg=what)


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_build_tree_matches_jax_given_draws(target, j):
    space, tspace = target["space"], target["tspace"]
    B, d = 8, space.dim
    rng = np.random.default_rng(j)
    theta = np.clip(target["theta0"] + 0.1 * rng.standard_normal((B, d)),
                    np.asarray(space.lower), np.asarray(space.upper))
    r = rng.standard_normal((B, d))
    lp, g = target["vag_j"](jnp.asarray(theta))
    joint0 = np.asarray(lp) - 0.5 * np.sum(r * r, axis=-1)
    log_u = joint0 + np.log(rng.uniform(0.05, 1.0, B))
    v = np.where(rng.uniform(size=B) < 0.5, -1.0, 1.0)
    eps = rng.uniform(0.01, 0.2, B)
    key = jax.random.PRNGKey(10 + j)
    jt = jnuts._build_tree(target["vag_j"], space, jnp.asarray(theta),
                           jnp.asarray(r), g, jnp.asarray(log_u),
                           jnp.asarray(v), j, jnp.asarray(eps),
                           jnp.asarray(joint0), key)
    leaf_u = T(jnp.stack([jax.random.uniform(k, (B,), jnp.float64)
                          for k in jax.random.split(key, 1 << j)]))
    tt = tnuts._build_tree(target["vag_t"], tspace, T(theta), T(r), T(g),
                           T(log_u), T(v), j, T(eps), T(joint0), leaf_u)
    for f in tt._fields:
        _close(getattr(tt, f).numpy(), getattr(jt, f), f)
    assert (tt.n_prime > 0).any()


def _run_pair(target, cfg_kw, variant="plain", B=8, key=1):
    space, tspace = target["space"], target["tspace"]
    jcfg = jnuts.NUTSConfig(**cfg_kw)
    tcfg = tnuts.NUTSConfig(**cfg_kw)
    k = jax.random.PRNGKey(key)
    draws = JaxDraws(k, B, space.dim, tcfg)
    theta0 = target["theta0"]
    ll_j = lambda th: target["vag_j"](th)[0]
    if variant == "plain":
        j = jnuts.run_nuts(ll_j, space, jnp.asarray(theta0), k, jcfg,
                           n_chains=B, value_and_grad_batch=target["vag_j"])
        t = tnuts.run_nuts(None, tspace, T(theta0), tcfg, n_chains=B,
                           value_and_grad_batch=target["vag_t"], draws=draws)
        return j, t
    if variant == "whitened":
        j = jnuts.run_nuts_whitened(ll_j, space, jnp.asarray(theta0), k, jcfg,
                                    n_chains=B,
                                    value_and_grad_batch=target["vag_j"])
        t = tnuts.run_nuts_whitened(None, tspace, T(theta0), tcfg, n_chains=B,
                                    value_and_grad_batch=target["vag_t"],
                                    draws=draws)
        return j, t
    d = space.dim
    rng = np.random.default_rng(5)
    A = rng.standard_normal((d, d)) * 0.1
    S = np.linalg.cholesky(A @ A.T + np.diag(np.asarray(space.sigmas) ** 2))
    if variant == "dense":
        mu = theta0
        fj, ft = jnuts.run_nuts_dense, tnuts.run_nuts_dense
    else:
        lo, hi = np.asarray(space.lower), np.asarray(space.upper)
        mu = jnuts.logit_transform(theta0, lo, hi)
        S = 0.3 * np.eye(d) + 0.05 * np.tril(rng.standard_normal((d, d)))
        fj, ft = jnuts.run_nuts_logit, tnuts.run_nuts_logit
    j = fj(ll_j, space, k, jcfg, mu=jnp.asarray(mu), scale=jnp.asarray(S),
           n_chains=B, jitter=0.5, value_and_grad_batch=target["vag_j"])
    t = ft(None, tspace, tcfg, mu=T(mu), scale=T(S), n_chains=B, jitter=0.5,
           value_and_grad_batch=target["vag_t"], draws=draws)
    return j, t


def _assert_result_equal(t, j):
    assert t.samples.shape == np.asarray(j.samples).shape
    for f in t._fields:
        _close(getattr(t, f).numpy(), getattr(j, f), f)


def test_run_nuts_iterations_match_jax_given_draws(target):
    """Two full iterations at depth 3 (the first inside the adaptation
    window, the second after it), from the epsilon search on."""
    j, t = _run_pair(target, dict(iterations=2, adaptation_window=1,
                                  max_tree_depth=3))
    _assert_result_equal(t, j)
    assert float(t.mean_depth.mean()) > 0


@pytest.mark.parametrize("variant", ["whitened", "dense", "logit"])
def test_nuts_variants_match_jax_given_draws(target, variant):
    j, t = _run_pair(target, dict(iterations=2, adaptation_window=1,
                                  max_tree_depth=2), variant=variant)
    _assert_result_equal(t, j)
    assert torch.isfinite(t.samples).all()


def test_resume_is_bit_identical(target):
    """segments + on_segment + initial_state: a run resumed from its
    checkpointed state continues bit for bit (seeded draws)."""
    tspace, theta0 = target["tspace"], T(target["theta0"])
    cfg = tnuts.NUTSConfig(iterations=4, adaptation_window=2, max_tree_depth=2)
    states = []
    full = tnuts.run_nuts(None, tspace, theta0, cfg, seed=11, n_chains=6,
                          value_and_grad_batch=target["vag_t"], segments=2,
                          on_segment=lambda st, xs, lps: states.append(st))
    assert len(states) == 2 and states[0].it == 2
    rest = tnuts.run_nuts(None, tspace, theta0, cfg, seed=11, n_chains=6,
                          value_and_grad_batch=target["vag_t"],
                          initial_state=states[0])
    assert torch.equal(rest.samples, full.samples[2:])
    assert torch.equal(rest.sample_logps, full.sample_logps[2:])
    assert torch.equal(rest.step_sizes, full.step_sizes)
    assert torch.equal(rest.best_x, full.best_x)
    # stopping early keeps what was gathered
    part = tnuts.run_nuts(None, tspace, theta0, cfg, seed=11, n_chains=6,
                          value_and_grad_batch=target["vag_t"], segments=2,
                          on_segment=lambda st, xs, lps: True)
    assert torch.equal(part.samples, full.samples[:2])
    done = tnuts.run_nuts(None, tspace, theta0, cfg, seed=11, n_chains=6,
                          value_and_grad_batch=target["vag_t"],
                          initial_state=states[1])
    assert done.samples.shape == (0, 6, tspace.dim)
    # chain sharding over a mesh of one is the unsharded run, bit for bit;
    # anything but a mesh is refused
    from mmidv1_tpu_torch.parallel.mesh import LOCAL
    one = tnuts.run_nuts(None, tspace, theta0, cfg, seed=11, n_chains=6,
                         value_and_grad_batch=target["vag_t"],
                         chain_sharding=LOCAL)
    assert torch.equal(one.samples, full.samples)
    assert torch.equal(one.step_sizes, full.step_sizes)
    with pytest.raises(TypeError, match="EnsembleMesh"):
        tnuts.run_nuts(None, tspace, theta0, cfg, n_chains=6,
                       value_and_grad_batch=target["vag_t"],
                       chain_sharding=object())


def test_calibrate_nuts_end_to_end_cpu(spain_params):
    """calibrate(algorithm="nuts") through the K2/K3 engine's plain versions
    on a 35-day problem: finite results, chain 0 starting at theta0, and a
    best that is what the objective gives there."""
    prm, params = spain_params
    _data, tdata = _data_pair(prm, 35)
    ts = make_time_grid(prm["runup_days"], 35)
    bounds = {n: (0.01, 2.0) for n in NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(NAMES, bounds, {n: 0.05 for n in NAMES},
                                  params)
    tparams = to_torch_params(params)
    tspace = to_torch_space(space, tparams)
    kw = dict(substeps=1, tableau="rk4", constraint_mode=CLAMP, device="cpu")
    ll = build_objective_fused(tspace, tparams, tdata, ts, **kw)
    vg = build_objective_fused_grad(tspace, tparams, tdata, ts, **kw)
    theta0 = tspace.extract(tparams)
    res = tcal.calibrate(ll, ll, tspace, theta0,
                         generator=torch.Generator().manual_seed(3),
                         algorithm="nuts", n_chains=4,
                         nuts_config=tnuts.NUTSConfig(iterations=3,
                                                      adaptation_window=2,
                                                      max_tree_depth=2),
                         value_and_grad_batch_clamp=vg)
    assert res.nuts_result is not None and res.mh_result is None
    assert res.phase1_best is None and res.phase2_seconds > 0
    assert res.samples.shape == (3, 4, tspace.dim)
    assert torch.isfinite(res.samples).all()
    assert float(res.best_logl) >= float(ll(theta0[None, :])[0])
    np.testing.assert_allclose(float(ll(res.best_theta[None, :])[0]),
                               float(res.best_logl), rtol=1e-12)
    assert vg.calls == 7 + 1 + 3 * 4          # eps search, init, 3 x (3 + 1)


def test_calibrate_spain_nuts_runs_on_cpu(tmp_path):
    """The calibrate_spain entry point with --algorithm nuts on the host, at
    a 40-day window, 4 chains, 3 iterations of depth 2."""
    from mmidv1_tpu_torch.cli.calibrate_spain import run_calibration

    s = run_calibration(algorithm="nuts", chains=4, device="cpu", num_days=40,
                        tableau="rk4", substeps=1, out=str(tmp_path),
                        nuts_config=tnuts.NUTSConfig(iterations=3,
                                                     adaptation_window=2,
                                                     max_tree_depth=2),
                        log=lambda m: None)
    assert np.isfinite(s["best_logl"]) and np.isfinite(s["best_logl_float64"])
    assert s["best_logl"] >= s["initial_logl"] - 1e-6 * abs(s["initial_logl"])
    assert s["samples_shape"] == [3, 4, 62] and s["samples_finite"]
    assert s["value_and_grad_calls"] == 20 and s["grad_evals_per_s"] > 0
    assert s["phase1_logl"] is None
    assert (tmp_path / "calibrated_parameters.txt").exists()
