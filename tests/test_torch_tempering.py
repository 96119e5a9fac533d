"""The port's parallel tempering against the JAX package, in float64 on the
CPU: every test of ``tests/test_tempering.py`` pointed at the port (the
bimodal mixing test is in ``test_torch_sampler_stats.py``), and each step
function and a whole 3-block run fed JAX's draws, at rtol 1e-12."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import tempering as jpt
from mmidv1_tpu.calibration.param_space import ParameterSpace

from mmidv1_tpu_torch.calibration import tempering as tpt
from mmidv1_tpu_torch.calibration.param_space import \
    ParameterSpace as TParameterSpace

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mh_demc import (JaxRunDraws, T, assert_close,  # noqa: E402
                                gaussian_target, spain)

F64 = torch.float64


def bimodal(sep=2.0, sd=0.25):
    """``tests/test_tempering.py``'s two equal Gaussian modes at +/-sep in
    both coordinates: the JAX per-theta density, the port's batched one,
    both spaces (box [-8, 8], sigmas 0.25)."""
    names = ("beta", "theta")

    def jll(theta):
        a = -0.5 * jnp.sum(((theta - sep) / sd) ** 2)
        b = -0.5 * jnp.sum(((theta + sep) / sd) ** 2)
        return jnp.logaddexp(a, b)

    def tll(X):
        a = -0.5 * torch.sum(((X - sep) / sd) ** 2, dim=-1)
        b = -0.5 * torch.sum(((X + sep) / sd) ** 2, dim=-1)
        return torch.logaddexp(a, b)

    jspace = ParameterSpace(names=names, lower=jnp.full((2,), -8.0),
                            upper=jnp.full((2,), 8.0),
                            sigmas=jnp.full((2,), 0.25), _scatter={})
    tspace = TParameterSpace(names=names, lower=torch.full((2,), -8.0,
                                                           dtype=F64),
                             upper=torch.full((2,), 8.0, dtype=F64),
                             sigmas=torch.full((2,), 0.25, dtype=F64),
                             _scatter={})
    return jll, tll, jspace, tspace


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _zeros(d=2):
    return torch.zeros(d, dtype=F64)


def _to_torch(js):
    return tpt.PTState(**{f: (int(v) if f == "step" else T(v))
                          for f, v in js._asdict().items()})


# --------------------------------------------- tests/test_tempering.py


def test_pt_single_rung_is_plain_mh_shape():
    """K=1 degenerates to an untempered sampler with the right shapes."""
    _jll, tll, _js, tspace = bimodal()
    cfg = tpt.PTConfig(iterations=12, burn_in=2, thinning=3, n_rungs=1)
    r = tpt.run_pt(tll, tspace, _zeros(), cfg, generator=_gen(1), n_chains=4)
    assert r.samples.shape == (4, 4, 2)
    assert torch.isfinite(r.sample_logps).all()
    assert np.isfinite(float(r.best_logp))


def test_pt_swap_preserves_states_and_pairs_logp():
    """A swap sweep permutes (x, logp) pairs within chain columns: the
    multiset of rows per column is invariant and x stays paired with ITS
    logp."""
    _jll, tll, _js, tspace = bimodal()
    cfg = tpt.PTConfig(n_rungs=6, beta_min=0.05)
    betas = cfg.ladder(F64)
    g = _gen(3)
    state = tpt.init_pt_state(tspace, _zeros(), tll,
                              torch.randn((30, 2), generator=g, dtype=F64),
                              n_rungs=6, n_chains=5, jitter=2.0)
    for parity in (0, 1):
        new = tpt.pt_swap_step(state, torch.rand((5, 5), generator=g,
                                                 dtype=F64), betas, parity)
        for i in range(5):   # per chain column
            old_rows = sorted(map(tuple, state.x[:, i, :].tolist()))
            new_rows = sorted(map(tuple, new.x[:, i, :].tolist()))
            assert old_rows == new_rows
        # logp rows moved WITH their x rows
        np.testing.assert_allclose(new.logp.numpy(), tll(new.x).numpy(),
                                   rtol=1e-12)
        assert int(new.swap_tries.sum()) > 0


def test_pt_ladder_validation():
    cfg = tpt.PTConfig(n_rungs=4, beta_min=0.1)
    lad = cfg.ladder(F64).numpy()
    assert lad[0] == 1.0 and np.isclose(lad[-1], 0.1)
    assert (np.diff(lad) < 0).all()
    np.testing.assert_array_equal(
        lad, np.asarray(jpt.PTConfig(n_rungs=4, beta_min=0.1)
                        .ladder(jnp.float64)))
    with pytest.raises(ValueError):
        tpt.PTConfig(beta_min=0.0).ladder(F64)
    with pytest.raises(ValueError):
        tpt.PTConfig(n_rungs=0).ladder(F64)


def test_pt_accepts_batch_native_objective():
    """The objective sees (K*N, d) batches."""
    _jll, tll, _js, tspace = bimodal()
    seen = []

    def ll_batch(X):
        seen.append(tuple(X.shape))
        return tll(X)

    cfg = tpt.PTConfig(iterations=4, burn_in=0, thinning=2, n_rungs=3)
    r = tpt.run_pt(ll_batch, tspace, _zeros(), cfg, generator=_gen(5),
                   n_chains=4)
    assert seen and all(s == (12, 2) for s in seen)
    assert torch.isfinite(r.sample_logps).all()


def test_pt_ladder_adaptation_equalizes_swap_rates():
    """With adapt_ladder on, a deliberately terrible initial ladder (all the
    spacing at the hot end) converges toward uniform adjacent swap rates,
    with fixed endpoints (Vousden et al. 2016)."""
    _jll, tll, _js, tspace = bimodal()
    cfg = tpt.PTConfig(iterations=1500, burn_in=1200, adaptation_period=300,
                       thinning=5, n_rungs=6, beta_min=0.02,
                       adapt_ladder=True, ladder_kappa=0.5, ladder_t0=200.0)
    bad = torch.tensor([1.0, 0.98, 0.96, 0.94, 0.92, 0.02], dtype=F64)
    g = _gen(0)
    state0 = tpt.init_pt_state(tspace, _zeros(), tll,
                               torch.randn((96, 2), generator=g, dtype=F64),
                               n_rungs=6, n_chains=16, jitter=2.0, betas=bad)
    res = tpt.run_pt(tll, tspace, _zeros(), cfg, generator=_gen(1),
                     n_chains=16, initial_state=state0)
    betas = res.final_state.betas.numpy()
    assert betas[0] == 1.0
    np.testing.assert_allclose(betas[-1], 0.02, rtol=1e-5)
    assert (np.diff(betas) < 0).all()
    probs = res.final_state.swap_prob.numpy()
    assert probs.min() > 0.05, probs
    assert probs.min() / probs.max() > 0.2, probs


def test_pt_ladder_adaptation_off_keeps_ladder_fixed():
    _jll, tll, _js, tspace = bimodal()
    cfg = tpt.PTConfig(iterations=60, burn_in=40, thinning=4, n_rungs=4,
                       beta_min=0.1, adapt_ladder=False)
    res = tpt.run_pt(tll, tspace, _zeros(), cfg, generator=_gen(2),
                     n_chains=8)
    np.testing.assert_allclose(res.final_state.betas.numpy(),
                               cfg.ladder(F64).numpy(), rtol=1e-12)


# ----------------------------------------- step functions against JAX


def test_init_and_mh_step_match_jax_given_draws(spain):
    """init_pt_state and two tempered steps on the Spain objective, K=3
    rungs x N=4 chains (one objective call over 12 rows a step)."""
    space, tspace = spain["space"], spain["tspace"]
    K, N, d = 3, 4, space.dim
    theta0 = space.extract(spain["params"])
    rng = np.random.default_rng(2)
    A = rng.normal(size=(d, d)) * np.asarray(space.sigmas)
    cov0 = A @ A.T / d + np.diag(np.asarray(space.sigmas) ** 2)
    cfg = jpt.PTConfig(n_rungs=K, beta_min=0.1)
    tcfg = tpt.PTConfig(n_rungs=K, beta_min=0.1)
    draws = JaxRunDraws(jax.random.PRNGKey(6), 1, 2, K * N, d, pt=True)
    js = jpt.init_pt_state(space, theta0, spain["jll"], draws.k_init,
                           n_rungs=K, n_chains=N, jitter=2.0,
                           initial_cov=jnp.asarray(cov0),
                           betas=cfg.ladder(jnp.float64))
    ts_ = tpt.init_pt_state(tspace, T(theta0), spain["tll"], draws.init(),
                            n_rungs=K, n_chains=N, jitter=2.0,
                            initial_cov=T(cov0), betas=tcfg.ladder(F64))
    assert_close(ts_, js, what="init")
    for i in range(2):
        k_mh = jax.random.split(draws.keys[i])[0]
        js = jpt.pt_mh_step(js, k_mh, space, spain["jll"], cfg, js.betas)
        z, u = draws.step(i)
        ts_ = tpt.pt_mh_step(ts_, z.reshape(K, N, d), u.reshape(K, N), tspace,
                             spain["tll"], tcfg, ts_.betas)
        assert_close(ts_, js, what=f"step {i}")
    assert 0 < int(ts_.accept_count.sum()) < 2 * K * N


@pytest.fixture(scope="module")
def five_rungs():
    """A K=5, N=3 state of both packages with spread log-densities."""
    jll, _tll, jspace, _ts = gaussian_target(d=3)
    js = jpt.init_pt_state(jspace, jnp.zeros(3), jax.vmap(jll),
                           jax.random.PRNGKey(8), n_rungs=5, n_chains=3,
                           jitter=3.0)
    rng = np.random.default_rng(4)
    js = js._replace(swap_prob=jnp.asarray(rng.uniform(0.1, 0.9, 4)),
                     step=jnp.asarray(7, jnp.int32))
    return js


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_step_matches_jax_given_draws(five_rungs, parity):
    """The exchange algebra at K = 5 (two masks shifting rows up and down),
    N = 3 columns, each parity: states, counters and the swap-probability
    EMA equal JAX's."""
    js = five_rungs
    key = jax.random.PRNGKey(30 + parity)
    u = jax.random.uniform(key, (4, 3), dtype=jnp.float64)
    betas = jnp.asarray([1.0, 0.7, 0.45, 0.2, 0.05])
    j_new = jpt.pt_swap_step(js, key, betas, jnp.asarray(parity), ema=0.2)
    t_new = tpt.pt_swap_step(_to_torch(js), T(u), T(betas), parity, ema=0.2)
    assert_close(t_new, j_new)
    assert int(t_new.swap_accept.sum()) > 0
    assert t_new.swap_tries.tolist() == [3 * ((k % 2) == parity)
                                         for k in range(4)]


@pytest.mark.parametrize("step", [1, 5, 40])
def test_adapt_ladder_matches_jax(five_rungs, step):
    """The ladder's Robbins-Monro update, held below t = 2 sweeps."""
    js = five_rungs._replace(step=jnp.asarray(step, jnp.int32))
    cfg = dict(swap_every=2, ladder_kappa=0.5, ladder_t0=50.0)
    j_new = jpt.pt_adapt_ladder(js, jpt.PTConfig(**cfg))
    t_new = tpt.pt_adapt_ladder(_to_torch(js), tpt.PTConfig(**cfg))
    assert_close(t_new, j_new)
    moved = not np.array_equal(t_new.ladder_s.numpy(), np.asarray(js.ladder_s))
    assert moved == (step // 2 >= 2)
    assert float(t_new.betas[0]) == 1.0


def test_adapt_covariance_matches_jax():
    """Per-rung covariances and factors (5 rungs of 8 chains in 3-d); a rung
    whose factorization fails (a non-finite chain) keeps its previous
    factor, in both packages."""
    jll, _tll, jspace, _ts = gaussian_target(d=3)
    js0 = jpt.init_pt_state(jspace, jnp.zeros(3), jax.vmap(jll),
                            jax.random.PRNGKey(10), n_rungs=5, n_chains=8,
                            jitter=3.0)
    x = np.asarray(js0.x).copy()
    x[2, 1, 0] = np.nan
    js = js0._replace(x=jnp.asarray(x))
    j_new = jpt.pt_adapt_covariance(js, jpt.PTConfig())
    t_new = tpt.pt_adapt_covariance(_to_torch(js), tpt.PTConfig())
    assert_close(t_new, j_new)
    np.testing.assert_array_equal(t_new.chol[2].numpy(),
                                  np.asarray(js0.chol[2]))
    assert not torch.equal(t_new.chol[0], T(js0.chol[0]))


def test_runner_matches_jax_three_blocks():
    """A 3-block ``run_pt`` (4 rungs x 6 chains, thinning 2, a swap sweep
    every step, the ladder adapting through burn-in, the covariances every
    block) equals JAX's given its draws."""
    jll, tll, jspace, tspace = gaussian_target(d=3, seed=3)
    kw = dict(iterations=6, thinning=2, burn_in=4, adaptation_period=2,
              n_rungs=4, beta_min=0.1, ladder_kappa=0.5, ladder_t0=5.0)
    K, N, d = 4, 6, 3
    key = jax.random.PRNGKey(12)
    j = jpt.run_pt(jll, jspace, jnp.zeros(d), key, jpt.PTConfig(**kw),
                   n_chains=N, jitter=2.0)
    t = tpt.run_pt(tll, tspace, _zeros(d), tpt.PTConfig(**kw), n_chains=N,
                   jitter=2.0, draws=JaxRunDraws(key, 3, 2, K * N, d, pt=True))
    assert t.samples.shape == (3, N, d)
    assert_close(t, j)
    assert not np.array_equal(t.final_state.betas.numpy(),
                              tpt.PTConfig(**kw).ladder(F64).numpy())
    assert int(t.final_state.swap_accept.sum()) > 0
