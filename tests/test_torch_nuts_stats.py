"""Whole NUTS runs of the port held statistically on analytic targets, at the
settings and bars of ``tests/test_optimizers.py`` (plain, sigma-whitened,
dense and logit-dense NUTS)."""

import os
import sys

import numpy as np
import torch

from mmidv1_tpu_torch.calibration.nuts import (NUTSConfig, run_nuts,
                                               run_nuts_dense, run_nuts_logit,
                                               run_nuts_whitened)
from mmidv1_tpu_torch.calibration.param_space import ParameterSpace

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sampler_stats import F64, gaussian, space_of, zeros  # noqa: E402


def test_nuts_samples_gaussian():
    cov = np.array([[1.0, 0.5], [0.5, 1.5]])
    cfg = NUTSConfig(iterations=300, adaptation_window=100, max_tree_depth=4)
    res = run_nuts(gaussian([0.0, 0.0], cov), space_of(2, -10.0, 10.0, 0.5),
                   zeros(2), cfg, seed=0, n_chains=8)
    s = res.samples[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.3)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.6)
    assert torch.isfinite(res.step_sizes).all()
    acc = float(res.mean_accept.mean())
    assert 0.3 < acc <= 1.0, acc


def test_nuts_uses_gradients():
    """NUTS on a narrow valley moves along it (gradient-guided), where a
    random walk of this few iterations would not."""
    def ll(X):
        return -0.5 * ((X[..., 0] - X[..., 1]) ** 2 / 0.01
                       + ((X[..., 0] + X[..., 1]) / 2 - 20.0) ** 2 / 100.0)

    cfg = NUTSConfig(iterations=150, adaptation_window=50, max_tree_depth=5)
    res = run_nuts(ll, space_of(2, -50.0, 50.0, 0.1), zeros(2), cfg, seed=1,
                   n_chains=4)
    assert float(res.best_logp) > -30.0


def test_nuts_whitened_samples_anisotropic_gaussian():
    """Scales spanning 100x: the whitened sampler recovers both variances at
    a shallow tree depth."""
    scales = np.array([0.01, 1.0])
    space = ParameterSpace(
        names=("a", "b"), lower=torch.tensor([-0.5, -10.0], dtype=F64),
        upper=torch.tensor([0.5, 10.0], dtype=F64),
        sigmas=torch.as_tensor(scales), _scatter={})
    cfg = NUTSConfig(iterations=300, adaptation_window=100, max_tree_depth=4)
    res = run_nuts_whitened(gaussian([0.0, 0.0], np.diag(scales ** 2)), space,
                            zeros(2), cfg, seed=5, n_chains=8)
    s = res.samples[100:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.std(axis=0), scales, rtol=0.35)
    np.testing.assert_allclose(s.mean(axis=0) / scales, 0.0, atol=0.3)
    acc = float(res.mean_accept.mean())
    assert 0.3 < acc <= 1.0, acc


def test_nuts_dense_samples_correlated_stiff_gaussian():
    """Correlation 0.999 between two coordinates: dense whitening by the
    true Cholesky factor makes the target isotropic and recovers the full
    covariance at shallow depth."""
    cov = np.array([[1.0, 0.999, 0.0], [0.999, 1.0, 0.0], [0.0, 0.0, 4.0]])
    mu = np.array([1.0, -1.0, 2.0])
    cfg = NUTSConfig(iterations=300, adaptation_window=100, max_tree_depth=4)
    res = run_nuts_dense(gaussian(mu, cov), space_of(3, -50.0, 50.0, 1.0),
                         cfg, mu=torch.as_tensor(mu),
                         scale=torch.as_tensor(np.linalg.cholesky(cov)),
                         seed=9, n_chains=8)
    s = res.samples[100:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(axis=0), mu, atol=0.3)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.8)
    assert float(res.step_sizes.median()) > 0.05
    acc = float(res.mean_accept.mean())
    assert 0.3 < acc <= 1.0, acc


def test_nuts_logit_wall_pinned_target_law():
    """Truncated exponential on [0, 1] with the mode AT the wall: the logit
    sampler recovers the analytic truncated moments (the Jacobian at work)
    and keeps an O(1) adapted step."""
    tau = 0.1
    ll = lambda X: -torch.sum(X, dim=-1) / tau
    m = tau - np.exp(-1 / tau) / (1 - np.exp(-1 / tau))
    cfg = NUTSConfig(iterations=600, adaptation_window=200, max_tree_depth=5)
    res = run_nuts_logit(ll, space_of(2, 0.0, 1.0, 1.0), cfg,
                         mu=torch.full((2,), float(np.log(tau)), dtype=F64),
                         scale=torch.eye(2, dtype=F64), seed=11, n_chains=8)
    s = res.samples[200:].reshape(-1, 2).numpy()
    assert (s >= 0.0).all() and (s <= 1.0).all()
    np.testing.assert_allclose(s.mean(axis=0), m, rtol=0.15)
    np.testing.assert_allclose(s.std(axis=0), tau, rtol=0.25)
    assert float(res.step_sizes.median()) > 0.05
    acc = float(res.mean_accept.mean())
    assert 0.3 < acc <= 1.0, acc


def test_nuts_logit_pure_loglik_and_warm_init():
    """``sample_logps`` (and ``best_logp``) are the pure log-likelihood, the
    Jacobian stripped; a warm ensemble in theta units round-trips through
    the logit + dense-mass composition."""
    mu_th = torch.tensor([0.5, 1.0, 1.5], dtype=F64)
    ll = lambda X: -0.5 * torch.sum(((X - mu_th) / 0.2) ** 2, dim=-1)
    rng = np.random.default_rng(0)
    init = np.clip(mu_th.numpy() + 0.2 * rng.normal(size=(6, 3)),
                   1e-3, 2.0 - 1e-3)
    cfg = NUTSConfig(iterations=300, adaptation_window=100, max_tree_depth=4)
    res = run_nuts_logit(ll, space_of(3, 0.0, 2.0, 1.0), cfg, mu=zeros(3),
                         scale=torch.eye(3, dtype=F64), seed=8, n_chains=6,
                         init=torch.as_tensor(init))
    s, lps = res.samples[100:], res.sample_logps[100:]
    np.testing.assert_allclose(lps.numpy(), ll(s).numpy(), atol=1e-3)
    flat = s.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), mu_th.numpy(), atol=0.1)
    np.testing.assert_allclose(flat.std(axis=0), 0.2, rtol=0.3)
    assert abs(float(res.best_logp) - float(ll(res.best_x))) < 1e-3
