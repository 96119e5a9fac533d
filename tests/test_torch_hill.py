"""The PyTorch port's hill climber against the JAX package, in float64 on the
CPU.

JAX's threefry stream cannot be reproduced in PyTorch, so the port's climber
is fed the draws JAX's makes from its key (``hill.py:140-148``: per iteration
``split(k, 3)`` -> normals of the correlated cloud, axis indices, axis
normals). Given the same draws both run the same float64 arithmetic and the
same decisions: on analytic objectives the bar is rtol 1e-12 over 20
iterations (a Cholesky refresh included); on the Spain objective, whose two
implementations agree at rtol 1e-12, it is 1e-10 over 3 iterations.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import hill as jhill
from mmidv1_tpu.calibration.objective import build_objective
from mmidv1_tpu.calibration.param_space import CLAMP
from mmidv1_tpu.calibration.param_space import ParameterSpace as JSpace

from mmidv1_tpu_torch.calibration import calibrator as tcal
from mmidv1_tpu_torch.calibration import hill as thill
from mmidv1_tpu_torch.calibration import mh as tmh
from mmidv1_tpu_torch.calibration.param_space import ParameterSpace as TSpace
from mmidv1_tpu_torch.ops import build_objective_fused

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_calibration import problem  # noqa: E402,F401
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402

torch.set_num_threads(1)
T = lambda a: torch.as_tensor(np.array(a))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spaces(d, lo, hi, sigma):
    """The same analytic box in both packages (no model fields)."""
    names = tuple(f"x{i}" for i in range(d))
    js = JSpace(names=names, lower=jnp.full((d,), lo), upper=jnp.full((d,), hi),
                sigmas=jnp.full((d,), sigma), _scatter={})
    ts = TSpace(names=names, lower=torch.full((d,), lo, dtype=torch.float64),
                upper=torch.full((d,), hi, dtype=torch.float64),
                sigmas=torch.full((d,), sigma, dtype=torch.float64),
                _scatter={})
    return js, ts


def jax_draws(key, cfg, d, dtype=jnp.float64):
    """The draws ``run_hill_climb`` makes from ``key``, iteration by
    iteration, as the port's ``(z, axis, axis_z)``."""
    half = cfg.cloud_size // 2
    n_ax = cfg.cloud_size - half
    out = []
    for k in jax.random.split(key, cfg.iterations):
        k_corr, k_axis, k_axis_i = jax.random.split(k, 3)
        z = jax.random.normal(k_corr, (half, d), dtype=dtype)
        idx = jax.random.randint(k_axis_i, (n_ax,), 0, d)
        ax = jax.random.normal(k_axis, (n_ax,), dtype=dtype)
        out.append((T(z), torch.as_tensor(np.asarray(idx), dtype=torch.int64),
                    T(ax)))
    return out


def _assert_same(tres, jres, rtol):
    for f in ("best_x", "best_logl", "final_cov", "history_best"):
        np.testing.assert_allclose(getattr(tres, f).numpy(),
                                   np.asarray(getattr(jres, f)), rtol=rtol,
                                   atol=1e-300, err_msg=f)
    for f in ("x", "logl", "cov", "chol", "prev_x"):
        np.testing.assert_allclose(
            getattr(tres.final_state, f).numpy(),
            np.asarray(getattr(jres.final_state, f)), rtol=rtol, atol=1e-300,
            err_msg=f"final_state.{f}")
    assert tres.final_state.evals == int(jres.final_state.evals)


MU = [1.0, -2.0, 0.5, 3.0, -4.0]


def _rosenbrock_terms(x):
    return 100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1 - x[..., :-1]) ** 2


# name: (d, lower, upper, sigma, cloud size, start, JAX objective, port's)
CASES = {
    "quadratic": (5, -5.0, 5.0, 0.3, 24, 0.0,
                  lambda x: -jnp.sum((x - jnp.asarray(MU)) ** 2, axis=-1),
                  lambda x: -torch.sum((x - T(MU)) ** 2, dim=-1)),
    "rosenbrock": (4, -2.0, 2.0, 0.1, 32, -1.0,
                   lambda x: -jnp.sum(_rosenbrock_terms(x), axis=-1),
                   lambda x: -torch.sum(_rosenbrock_terms(x), dim=-1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_hill_climb_matches_jax_given_draws(case):
    d, lo, hi, sigma, cloud, x0, fj, ft = CASES[case]
    js, ts_ = _spaces(d, lo, hi, sigma)
    cfg = jhill.HillClimbConfig(iterations=20, cloud_size=cloud)
    tcfg = thill.HillClimbConfig(iterations=20, cloud_size=cloud)
    key = jax.random.PRNGKey(3)
    jres = jhill.run_hill_climb(fj, js, jnp.full((d,), x0), key, cfg)
    tres = thill.run_hill_climb(ft, ts_,
                                torch.full((d,), x0, dtype=torch.float64),
                                tcfg, draws=jax_draws(key, cfg, d))
    _assert_same(tres, jres, rtol=1e-12)
    hist = tres.history_best.numpy()
    assert hist[-1] > hist[0] and (np.diff(hist) >= 0).all()


def test_run_hill_climb_spain_matches_jax(spain_params):
    """3 iterations on the 62-name Spain-2020 objective (30 observed days):
    JAX's XLA objective against the port's fused objective (its plain
    version on the CPU)."""
    from mmidv1_tpu.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.cli.common import \
        load_spain_pipeline as load_torch_pipeline

    pipe = load_spain_pipeline(REPO, dtype=jnp.float64, num_days=30)
    tparams = to_torch_params(pipe.params)
    tspace = to_torch_space(pipe.space, tparams)
    # the same CSV through the port's reader
    tdata = load_torch_pipeline(REPO, num_days=30, dtype=torch.float64,
                                device="cpu").data
    d = pipe.data
    base = np.asarray(d.initial_sepaihrd_state(
        sigma=pipe.params.sigma, gamma_p=pipe.params.gamma_p,
        gamma_A=pipe.params.gamma_A, gamma_I=pipe.params.gamma_I,
        p=pipe.params.p, h=pipe.params.h))
    jll = build_objective(pipe.space, pipe.params, d, pipe.ts, substeps=2,
                          base_initial_state=base, constraint_mode=CLAMP)
    tll = build_objective_fused(tspace, tparams, tdata, pipe.ts, substeps=2,
                                base_initial_state=base, constraint_mode=CLAMP,
                                device="cpu")
    cfg = jhill.HillClimbConfig(iterations=3, cloud_size=8)
    tcfg = thill.HillClimbConfig(iterations=3, cloud_size=8)
    key = jax.random.PRNGKey(7)
    theta0 = np.asarray(pipe.theta0, np.float64)
    jres = jhill.run_hill_climb(jll, pipe.space, jnp.asarray(theta0), key, cfg)
    tres = thill.run_hill_climb(tll, tspace, T(theta0), tcfg,
                                draws=jax_draws(key, cfg, pipe.space.dim))
    _assert_same(tres, jres, rtol=1e-10)
    assert float(tres.best_logl) > float(tll(T(theta0)[None])[0])


def _jax_refresh(c):
    """JAX's refresh closure (``hill.py:182-188``) on its own."""
    d = c.shape[0]
    lam = 1e-6 * jnp.trace(c) / d
    L = jnp.linalg.cholesky(c + lam * jnp.eye(d))
    ok = jnp.all(jnp.isfinite(L))
    L_diag = jnp.diag(jnp.sqrt(jnp.maximum(jnp.diagonal(c), 1e-12)))
    return jnp.where(ok, L, L_diag)


@pytest.mark.parametrize("kind", ["spd", "zero", "indefinite", "rank1"])
def test_cholesky_refresh_and_its_fallback(kind):
    """``cholesky_ex`` reports the failure that ``jnp.linalg.cholesky``
    signals with NaNs: a singular (all-zero) or indefinite covariance falls
    back to the diagonal square root, exactly as in JAX."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 5))
    c = {"spd": a @ a.T + np.eye(5), "zero": np.zeros((5, 5)),
         "indefinite": np.diag([1.0, 2.0, -3.0, 0.5, 1.0]) + 0.01,
         "rank1": np.outer(a[0], a[0])}[kind]
    got = thill._refresh_cholesky(T(c)).numpy()
    if kind == "rank1":
        # c + lam I has condition ~1e6: two LAPACK factorizations agree to
        # that times eps entry by entry, so hold the product instead
        c_reg = c + 1e-6 * np.trace(c) / 5 * np.eye(5)
        np.testing.assert_allclose(got @ got.T, c_reg, rtol=1e-12, atol=1e-15)
    else:
        np.testing.assert_allclose(got,
                                   np.asarray(_jax_refresh(jnp.asarray(c))),
                                   rtol=1e-12, atol=1e-300)
    fell_back = kind in ("zero", "indefinite")
    diag = np.diag(np.sqrt(np.maximum(np.diag(c), 1e-12)))
    assert np.array_equal(got, diag) == fell_back
    assert np.isfinite(got).all()


def test_line_search_matches_jax(problem):  # noqa: F811
    """One two-phase line search on the 8-name objective, along a direction
    that improves (both ladders take steps) and one that does not."""
    space, tspace = problem["space"], problem["tspace"]
    jll, tll = problem["clamp"]
    cfg = jhill.HillClimbConfig()
    x = np.asarray(space.extract(problem["params"]), np.float64)
    rng = np.random.default_rng(4)
    for direction in (rng.normal(size=x.size) * 0.02, np.zeros(x.size)):
        l0 = float(jll(jnp.asarray(x)[None])[0])
        jx, jl, jm = jhill._line_search(jnp.asarray(x), jnp.asarray(l0),
                                        jnp.asarray(direction), space, jll, cfg)
        tx, tl, tm = thill._line_search(T(x), T(l0), T(direction), tspace, tll,
                                        thill.HillClimbConfig())
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-12)
        assert bool(tm) == bool(jm)


def test_calibrate_hillmcmc_end_to_end_cpu(problem):  # noqa: F811
    """``calibrate(algorithm="hillmcmc")`` at a tiny size through the fused
    objective's plain version: the climber's covariance conditions the
    MH ensemble, the output is finite and beats the start."""
    tspace = problem["tspace"]
    tll_reflect, tll_clamp = problem["reflect"][1], problem["clamp"][1]
    theta0 = tspace.extract(problem["tparams"])
    ll0 = float(tll_clamp(theta0[None, :])[0])
    res = tcal.calibrate(
        tll_clamp, tll_reflect, tspace, theta0,
        generator=torch.Generator().manual_seed(5), algorithm="hillmcmc",
        phase1_config=thill.HillClimbConfig(iterations=4, cloud_size=8),
        mh_config=tmh.MHConfig(iterations=6, burn_in=2, thinning=2,
                               adaptation_period=2),
        n_chains=8)
    assert float(res.phase1_logl) > ll0
    assert float(res.best_logl) >= float(res.phase1_logl)
    assert res.phase1_cov.shape == (tspace.dim, tspace.dim)
    assert res.samples.shape == (3, 8, tspace.dim)
    assert torch.isfinite(res.samples).all()
    assert bool(tspace.in_bounds(res.best_theta))
    # phase1=None skips the climber and samples from theta0
    res0 = tcal.calibrate(
        tll_clamp, tll_reflect, tspace, theta0,
        generator=torch.Generator().manual_seed(5), algorithm="hillmcmc",
        phase1=None, mh_config=tmh.MHConfig(iterations=2, burn_in=0),
        n_chains=4)
    assert res0.phase1_best is None and res0.samples.shape == (2, 4, tspace.dim)
