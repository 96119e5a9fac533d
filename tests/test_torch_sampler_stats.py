"""Whole runs of the port's samplers and optimizers held statistically, on
analytic targets, at the JAX package's own settings and bars: the
analytic-target tests of ``tests/test_mh.py`` (AM-MH and DE-MC),
``tests/test_mala.py``, ``tests/test_tempering.py`` (bimodal mixing) and
``tests/test_optimizers.py`` (PSO, hill climbing) pointed at the port. They
guard the block structure, the adaptation schedules and the thinning, which
the draw-fed parity tests do not. The NUTS ones are in
``test_torch_nuts_stats.py``."""

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch.calibration.hill import HillClimbConfig, run_hill_climb
from mmidv1_tpu_torch.calibration.mala import MALAConfig, run_mala
from mmidv1_tpu_torch.calibration.mh import MHConfig, run_mh
from mmidv1_tpu_torch.calibration.param_space import ParameterSpace
from mmidv1_tpu_torch.calibration.pso import (PSOConfig, PSOVariant, Topology,
                                              run_pso)
from mmidv1_tpu_torch.calibration.tempering import PTConfig, run_pt

F64 = torch.float64


def space_of(d, lo=-20.0, hi=20.0, sigma=0.5):
    full = lambda v: torch.full((d,), float(v), dtype=F64)
    return ParameterSpace(names=tuple(f"x{i}" for i in range(d)),
                          lower=full(lo), upper=full(hi), sigmas=full(sigma),
                          _scatter={})


def gen(seed):
    return torch.Generator().manual_seed(seed)


def zeros(d):
    return torch.zeros(d, dtype=F64)


def gaussian(mu, cov):
    """Batched log-density of N(mu, cov) over any leading dimensions."""
    mu = torch.as_tensor(np.asarray(mu, float))
    prec = torch.as_tensor(np.linalg.inv(np.asarray(cov, float)))
    return lambda X: -0.5 * torch.einsum("...i,ij,...j->...", X - mu, prec,
                                         X - mu)


COV3 = np.array([[1.0, 0.7, 0.0], [0.7, 1.0, 0.3], [0.0, 0.3, 2.0]])
MU3 = np.array([1.0, -2.0, 0.5])


# ------------------------------------------------------ tests/test_mh.py


def test_mh_recovers_correlated_gaussian():
    cfg = MHConfig(iterations=4000, burn_in=500, adaptation_period=100,
                   thinning=4, regularization_epsilon=1e-8)
    res = run_mh(gaussian(MU3, COV3), space_of(3), zeros(3), cfg,
                 generator=gen(0), n_chains=64)
    assert res.samples.shape == (1000, 64, 3)
    pooled = res.samples[250:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(pooled.mean(axis=0), MU3, atol=0.15)
    np.testing.assert_allclose(np.cov(pooled.T), COV3, atol=0.35)
    acc = float(res.acceptance_rate.mean())
    assert 0.1 < acc < 0.5, acc
    assert float(res.final_cov[0, 1]) > 0     # the target's correlation sign
    np.testing.assert_allclose(res.best_x.numpy(), MU3, atol=0.5)


def test_mh_respects_bounds_by_reflection():
    ll = lambda X: -0.5 * torch.sum((X - 0.9) ** 2, dim=-1) / 0.3 ** 2
    res = run_mh(ll, space_of(2, 0.0, 1.0), torch.full((2,), 0.5, dtype=F64),
                 MHConfig(iterations=1000, burn_in=100, thinning=2),
                 generator=gen(1), n_chains=32)
    assert float(res.samples.min()) >= 0.0 and float(res.samples.max()) <= 1.0


def test_mh_reproducible_and_seed_sensitive():
    ll = lambda X: -0.5 * torch.sum(X ** 2, dim=-1)
    cfg = MHConfig(iterations=200, burn_in=50, thinning=1)
    r1, r2, r3 = (run_mh(ll, space_of(2), zeros(2), cfg, generator=gen(s),
                         n_chains=8) for s in (7, 7, 8))
    assert torch.equal(r1.samples, r2.samples)
    assert not torch.equal(r1.samples, r3.samples)


def test_mh_handles_lowest_regions():
    """Chains proposed into a lowest()-likelihood region must reject, and
    the tail of every chain lives in the valid region."""
    def ll(X):
        return torch.where(X[..., 0] > 1.0,
                           torch.full_like(X[..., 0], torch.finfo(F64).min),
                           -0.5 * torch.sum(X ** 2, dim=-1))

    res = run_mh(ll, space_of(2, -5.0, 5.0), zeros(2),
                 MHConfig(iterations=500, burn_in=100, thinning=1),
                 generator=gen(3), n_chains=16)
    assert torch.isfinite(res.sample_logps).all()
    assert bool((res.samples[-100:, :, 0] <= 1.0).all())
    assert float(res.best_x[0]) <= 1.0
    assert float(res.best_logp) > -1e30


def test_demc_recovers_correlated_gaussian():
    """Walker-difference proposals recover the same correlated Gaussian with
    no covariance adaptation."""
    cfg = MHConfig(iterations=4000, burn_in=500, adaptation_period=100,
                   thinning=4, proposal="de")
    res = run_mh(gaussian(MU3, COV3), space_of(3), zeros(3), cfg,
                 generator=gen(3), n_chains=64)
    pooled = res.samples[250:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(pooled.mean(axis=0), MU3, atol=0.15)
    np.testing.assert_allclose(np.cov(pooled.T), COV3, atol=0.4)
    acc = float(res.acceptance_rate.mean())
    assert 0.1 < acc < 0.6, acc


def test_demc_tracks_curved_ridge_better_than_am():
    """On a banana target, DE-MC mixes visibly better than fixed-covariance
    AM for the same 6000 proposals a chain (DE proposes each chain every
    second step)."""
    def ll(X):
        return -0.5 * (X[..., 0] ** 2 / 4.0
                       + (X[..., 1] - X[..., 0] ** 2) ** 2 / 0.01)

    space = space_of(2, -30.0, 30.0)
    res_de = run_mh(ll, space, zeros(2),
                    MHConfig(proposal="de", iterations=12000, burn_in=1200,
                             thinning=10), generator=gen(11), n_chains=128,
                    jitter=4.0)
    res_am = run_mh(ll, space, zeros(2),
                    MHConfig(proposal="am", iterations=6000, burn_in=1200,
                             thinning=10), generator=gen(11), n_chains=128,
                    jitter=4.0)
    # truth: x0 ~ N(0, 4) => E[x1] = E[x0^2] = 4
    de = res_de.samples[120:].reshape(-1, 2).numpy()
    am = res_am.samples[120:].reshape(-1, 2).numpy()
    err_de = abs(de[:, 1].mean() - 4.0) + abs(de[:, 0].std() - 2.0)
    err_am = abs(am[:, 1].mean() - 4.0) + abs(am[:, 0].std() - 2.0)
    assert err_de < 0.7, (err_de, err_am)
    assert err_de < err_am, (err_de, err_am)


# ---------------------------------------------------- tests/test_mala.py


def test_mala_recovers_gaussian():
    mu = np.array([0.4, -0.3, 0.8])
    cov = np.array([[0.04, 0.018, 0.0], [0.018, 0.09, -0.02],
                    [0.0, -0.02, 0.16]])
    cfg = MALAConfig(iterations=600, burn_in=100, adaptation_period=50,
                     thinning=2, initial_step_size=0.3)
    res = run_mala(gaussian(mu, cov), space_of(3, -5.0, 5.0, 0.3), zeros(3),
                   cfg, generator=gen(0), n_chains=64)
    post = res.samples[100:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(post.mean(axis=0), mu, atol=0.05)
    np.testing.assert_allclose(post.std(axis=0), np.sqrt(np.diag(cov)),
                               rtol=0.25)
    acc = float(res.acceptance_rate.mean())
    assert 0.3 < acc < 0.9, acc
    assert np.isfinite(float(res.best_logp))


# ----------------------------------------------- tests/test_tempering.py


def test_pt_mixes_where_plain_mh_cannot():
    """Two equal modes at +/-2 (sd 0.25, an ~8-sigma gap): plain MH started
    in one mode stays there, the tempered ladder finds both weights."""
    sep, sd = 2.0, 0.25

    def ll(X):
        a = -0.5 * torch.sum(((X - sep) / sd) ** 2, dim=-1)
        b = -0.5 * torch.sum(((X + sep) / sd) ** 2, dim=-1)
        return torch.logaddexp(a, b)

    space = space_of(2, -8.0, 8.0, 0.25)
    theta0 = torch.full((2,), sep, dtype=F64)     # start in the positive mode
    weight = lambda s: float((s[s.shape[0] // 2:, :, 0] > 0).double().mean())
    mh = run_mh(ll, space, theta0,
                MHConfig(iterations=2000, burn_in=200, thinning=4,
                         adaptation_period=2000),   # frozen covariance
                generator=gen(0), n_chains=32, jitter=0.5)
    w_mh = weight(mh.samples)
    assert w_mh > 0.95, ("plain MH escaped the starting mode; the fixture "
                         f"is no longer a hardness test (w={w_mh})")
    pt = run_pt(ll, space, theta0,
                PTConfig(iterations=2000, burn_in=200, thinning=4,
                         adaptation_period=2000, n_rungs=8, beta_min=0.01),
                generator=gen(0), n_chains=32, jitter=0.5)
    w_pt = weight(pt.samples)
    assert 0.25 < w_pt < 0.75, f"cold rung mode weight {w_pt} not ~0.5"
    assert float(pt.swap_rate.min()) > 0.05


# ------------------------------------------ tests/test_optimizers.py (PSO)


def _quadratic(mu):
    mu = torch.as_tensor(np.asarray(mu, float))
    return lambda X: -torch.sum((X - mu) ** 2, dim=-1)


@pytest.mark.parametrize("variant", [PSOVariant.STANDARD,
                                     PSOVariant.ADAPTIVE])
def test_pso_variants_converge(variant):
    mu = [1.0, -2.0, 0.5, 3.0]
    cfg = PSOConfig(iterations=60, swarm_size=48, variant=variant,
                    topology=Topology.GLOBAL_BEST)
    res = run_pso(_quadratic(mu), space_of(4, -5.0, 5.0, 0.3), cfg,
                  generator=gen(0))
    assert float(res.best_f) > -0.05, (variant, float(res.best_f))
    np.testing.assert_allclose(res.best_x.numpy(), mu, atol=0.25)


@pytest.mark.parametrize("topology", list(Topology))
def test_pso_topologies_converge(topology):
    cfg = PSOConfig(iterations=60, swarm_size=49, variant=PSOVariant.STANDARD,
                    topology=topology)
    res = run_pso(_quadratic([0.5, -1.0, 2.0]), space_of(3, -5.0, 5.0, 0.3),
                  cfg, generator=gen(1))
    assert float(res.best_f) > -0.05, (topology, float(res.best_f))


# ----------------------------------------- tests/test_optimizers.py (hill)


def test_hill_climb_quadratic():
    mu = [1.0, -2.0, 0.5, 3.0, -4.0]
    res = run_hill_climb(_quadratic(mu), space_of(5, -5.0, 5.0, 0.3),
                         zeros(5), HillClimbConfig(iterations=80,
                                                   cloud_size=24),
                         generator=gen(0))
    assert float(res.best_logl) > -0.01, float(res.best_logl)
    np.testing.assert_allclose(res.best_x.numpy(), mu, atol=0.15)
    assert (np.diff(res.history_best.numpy()) >= -1e-12).all()


def test_hill_climb_rosenbrock_progress():
    def rosen(X):
        return -torch.sum(100.0 * (X[..., 1:] - X[..., :-1] ** 2) ** 2
                          + (1 - X[..., :-1]) ** 2, dim=-1)

    start = torch.full((4,), -1.0, dtype=F64)
    res = run_hill_climb(rosen, space_of(4, -2.0, 2.0, 0.1), start,
                         HillClimbConfig(iterations=150, cloud_size=32),
                         generator=gen(1))
    s0 = float(rosen(start))
    assert float(res.best_logl) > s0 * 0.01, (s0, float(res.best_logl))


def test_hill_climb_line_search_exploits_direction():
    """On a smooth 1-d slope the expansion ladder travels far in one
    iteration."""
    f = lambda X: -torch.sum((X - 50.0) ** 2, dim=-1)
    res = run_hill_climb(f, space_of(1, -100.0, 100.0, 0.5), zeros(1),
                         HillClimbConfig(iterations=10, cloud_size=8),
                         generator=gen(2))
    assert float(res.best_x[0]) > 30.0
