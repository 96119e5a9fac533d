"""The port's ensemble MH (AM and DE-MC) against the JAX package, in float64 on
the CPU, fed the JAX package's own draws.

JAX's threefry stream cannot be reproduced in PyTorch, so :class:`JaxRunDraws`
makes the draws each JAX runner makes from its key (``run_mh``:
``split(key)`` -> init / run keys, ``split(k_run, n_blocks)`` ->
``split(k_block, thin)`` per step, ``_shard_invariant_draws`` for ``z, u``,
``split(fold_in(step_key, 1), 3)`` for DE's ``j, k, g``; ``make_pt_runner``:
``split(step_key)`` -> MH / swap keys) and hands them to the port's runner as
a draw source. Given the same draws both run the same float64 arithmetic and
the same decisions: one DE step on the Spain objective and whole 3-block runs
on an analytic target match at rtol 1e-12.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import mh as jmh
from mmidv1_tpu.calibration.objective import build_objective, make_time_grid
from mmidv1_tpu.calibration.param_space import REFLECT, ParameterSpace

from mmidv1_tpu_torch.calibration import mh as tmh
from mmidv1_tpu_torch.calibration.param_space import \
    ParameterSpace as TParameterSpace
from mmidv1_tpu_torch.data import read_settings
from mmidv1_tpu_torch.ops import build_objective_fused

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402
from test_torch_objective import _data_pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.as_tensor(np.array(a))


class JaxRunDraws:
    """The draws a JAX MH or PT runner makes from ``key``, as a draw source
    of the port (``init``, ``step``, ``partners``, ``swap``)."""

    def __init__(self, key, n_blocks, thin, n, d, pt=False):
        self.k_init, k_run = jax.random.split(key)
        self.keys = [k for kb in jax.random.split(k_run, n_blocks)
                     for k in jax.random.split(kb, thin)]
        self.n, self.d, self.pt = n, d, pt

    def _table(self, key):
        return jmh._shard_invariant_draws(key, self.n, 0, self.n, self.d,
                                          jnp.float64)

    def init(self):
        return T(self._table(self.k_init)[0])

    def step(self, i):
        key = jax.random.split(self.keys[i])[0] if self.pt else self.keys[i]
        z, u = self._table(key)
        return T(z), T(u)

    def partners(self, i):
        kj, kk, kg = jax.random.split(jax.random.fold_in(self.keys[i], 1), 3)
        half = self.n // 2
        return (T(jax.random.randint(kj, (self.n,), 0, half)),
                T(jax.random.randint(kk, (self.n,), 0, half)),
                T(jax.random.uniform(kg, (self.n,), dtype=jnp.float64)))

    def swap(self, i, shape):
        key = jax.random.split(self.keys[i])[1]
        return T(jax.random.uniform(key, shape, dtype=jnp.float64))


def assert_close(t, j, rtol=1e-12, what=""):
    """A port NamedTuple against the JAX one, field by field (ints exact)."""
    for f in t._fields:
        a, b = getattr(t, f), getattr(j, f)
        name = f"{what}.{f}"
        if isinstance(a, tuple):
            assert_close(a, b, rtol, name)
        elif isinstance(a, int):
            assert a == int(b), name
        elif a.dtype in (torch.int32, torch.int64, torch.bool):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            # JAX divides int32 counts into float32 (acceptance and swap
            # rates): those are held to float32 rounding
            b = np.asarray(b)
            tol = max(rtol, float(np.finfo(b.dtype).eps))
            np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=1e-15,
                                       err_msg=name)


def gaussian_target(d=4, lo=-2.5, hi=2.5, seed=0):
    """A correlated Gaussian in a box narrow enough that reflection acts:
    the JAX per-theta log-density, the port's batched one, both spaces."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    prec = np.linalg.inv(A @ A.T / d + 0.5 * np.eye(d))
    mu = rng.uniform(-1.0, 1.0, d)
    names = tuple(f"x{i}" for i in range(d))
    jspace = ParameterSpace(names=names, lower=jnp.full((d,), lo),
                            upper=jnp.full((d,), hi),
                            sigmas=jnp.full((d,), 0.4), _scatter={})
    tspace = TParameterSpace(names=names, lower=torch.full((d,), lo,
                                                           dtype=torch.float64),
                             upper=torch.full((d,), hi, dtype=torch.float64),
                             sigmas=torch.full((d,), 0.4, dtype=torch.float64),
                             _scatter={})
    jp, tp = jnp.asarray(prec), T(prec)
    jmu, tmu = jnp.asarray(mu), T(mu)

    def jll(x):
        r = x - jmu
        return -0.5 * r @ jp @ r

    def tll(X):
        R = X - tmu
        return -0.5 * torch.einsum("bi,ij,bj->b", R, tp, R)

    return jll, tll, jspace, tspace


@pytest.fixture(scope="module")
def spain(spain_params):
    prm, params = spain_params
    n_days = 35
    data, tdata = _data_pair(prm, n_days)
    ts = make_time_grid(prm["runup_days"], n_days)
    names = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2",
             "kappa_2", "sigma"]
    bounds = {n: (0.01, 2.0) for n in names}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(names, bounds, {n: 0.05 for n in names},
                                  params)
    tparams = to_torch_params(params)
    tspace = to_torch_space(space, tparams)
    jll = jax.jit(jax.vmap(build_objective(space, params, data, ts, substeps=2,
                                           constraint_mode=REFLECT)))
    tll = build_objective_fused(tspace, tparams, tdata, ts, substeps=2,
                                constraint_mode=REFLECT, device="cpu")
    return dict(params=params, space=space, tspace=tspace, jll=jll, tll=tll)


def test_de_mh_step_matches_jax_given_draws(spain):
    """Four red-black DE steps (both parities) on the Spain objective: the
    state after each equals JAX's; the frozen half never accepts."""
    space, tspace = spain["space"], spain["tspace"]
    cfg = jmh.MHConfig(proposal="de", de_gamma1_prob=0.3)
    tcfg = tmh.MHConfig(proposal="de", de_gamma1_prob=0.3)
    theta0 = space.extract(spain["params"])
    B, d = 16, space.dim
    js = jmh.init_mh_state(space, theta0, spain["jll"], jax.random.PRNGKey(0),
                           B, jitter=2.0)
    js = js._replace(step=jnp.asarray(150, jnp.int32))
    ts_ = tmh.MHState(**{f: (int(v) if f == "step" else T(v))
                         for f, v in js._asdict().items()})
    draws = JaxRunDraws(jax.random.PRNGKey(4), 1, 4, B, d)
    for i in range(4):
        before = ts_.accept_count.clone()
        z, u = draws.step(i)
        j, k, g = draws.partners(i)
        js = jmh.mh_step(js, draws.keys[i], space, spain["jll"], cfg)
        ts_ = tmh.mh_step(ts_, z, u, tspace, spain["tll"], tcfg, j=j, k=k,
                          g_u=g)
        assert_close(ts_, js, what=f"step {i}")
        frozen = (torch.arange(B) % 2) != (150 + i) % 2
        assert torch.equal(ts_.accept_count[frozen], before[frozen])
    assert 0 < int(ts_.accept_count.sum()) < 2 * B


def test_de_odd_ensemble_raises():
    _jll, tll, _js, tspace = gaussian_target()
    cfg = tmh.MHConfig(iterations=2, proposal="de")
    with pytest.raises(ValueError, match="even ensemble"):
        tmh.run_mh(tll, tspace, torch.zeros(4, dtype=torch.float64), cfg,
                   generator=torch.Generator().manual_seed(0), n_chains=7)


@pytest.mark.parametrize("proposal", ["am", "de"])
def test_runner_matches_jax_three_blocks(proposal):
    """A 3-block run (thinning 2, the covariance re-estimated every block
    past burn-in for AM, progress every block) equals JAX's ``run_mh`` given
    its draws: samples, MAP, acceptance per proposal, final state and the
    progress calls."""
    jll, tll, jspace, tspace = gaussian_target()
    kw = dict(iterations=6, thinning=2, burn_in=1, adaptation_period=2,
              report_interval=1, proposal=proposal, de_gamma1_prob=0.25)
    B, d = 12, 4
    key = jax.random.PRNGKey(21)
    seen_j, seen_t = [], []
    theta0 = np.asarray([0.3, -0.2, 0.1, 0.0])
    j = jmh.run_mh(jll, jspace, jnp.asarray(theta0), key, jmh.MHConfig(**kw),
                   n_chains=B, jitter=2.0,
                   progress_fn=lambda *a: seen_j.append(a))
    t = tmh.run_mh(tll, tspace, T(theta0), tmh.MHConfig(**kw), n_chains=B,
                   jitter=2.0, draws=JaxRunDraws(key, 3, 2, B, d),
                   progress_fn=lambda *a: seen_t.append(a))
    jax.effects_barrier()
    assert t.samples.shape == (3, B, d)
    assert_close(t, j)
    assert [int(s[0]) for s in seen_j] == [s[0] for s in seen_t] == [2, 4, 6]
    got = np.array([s[1:] for s in seen_t])
    want = np.array([[float(v) for v in s[1:]] for s in seen_j])
    # the acceptance is float32 in JAX (int32 counts divided)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-7)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-12)
    acc = t.acceptance_rate.numpy()
    assert 0 < acc.mean() < 1


@pytest.mark.parametrize("proposal", ["am", "de"])
def test_checkpointed_campaign_matches_jax(tmp_path, proposal):
    """``run_mh_checkpointed`` over 3 segments, each segment's draws made
    from ``fold_in(key, s)`` as JAX does, equals JAX's campaign; so does a
    campaign killed after one segment and resumed from the port's
    checkpoint."""
    jll, tll, jspace, tspace = gaussian_target(seed=1)
    kw = dict(iterations=12, thinning=2, burn_in=2, adaptation_period=2,
              proposal=proposal)
    B, d = 8, 4
    key = jax.random.PRNGKey(9)
    theta0 = np.zeros(4)
    segs = lambda s: JaxRunDraws(jax.random.fold_in(key, s), 2, 2, B, d)
    j = jmh.run_mh_checkpointed(jll, jspace, jnp.asarray(theta0), key,
                                jmh.MHConfig(**kw), n_chains=B, segments=3,
                                checkpoint_path=str(tmp_path / "j.npz"))
    t = tmh.run_mh_checkpointed(tll, tspace, T(theta0), tmh.MHConfig(**kw),
                                n_chains=B, segments=3,
                                checkpoint_path=str(tmp_path / "t.npz"),
                                draws_for_segment=segs)
    assert t.samples.shape == (6, B, d) and t.samples.device.type == "cpu"
    assert_close(t, j)
    part = tmh.run_mh_checkpointed(
        tll, tspace, T(theta0), tmh.MHConfig(**dict(kw, iterations=4)),
        n_chains=B, segments=1, checkpoint_path=str(tmp_path / "k.npz"),
        draws_for_segment=segs)
    assert part.final_state.step == 4
    rest = tmh.run_mh_checkpointed(tll, tspace, T(theta0), tmh.MHConfig(**kw),
                                   n_chains=B, segments=3,
                                   checkpoint_path=str(tmp_path / "k.npz"),
                                   draws_for_segment=segs)
    assert torch.equal(rest.samples, t.samples[2:])
    assert torch.equal(rest.final_state.x, t.final_state.x)


def test_mh_config_from_settings_matches_jax():
    """The committed mcmc_settings.txt (report_interval 10000 included) reads
    into the same configuration in both packages."""
    s = read_settings(os.path.join(REPO, "data", "configuration",
                                   "mcmc_settings.txt"))
    assert s["report_interval"] == 10000
    t = dataclasses.asdict(tmh.MHConfig.from_settings(s))
    assert t == dataclasses.asdict(jmh.MHConfig.from_settings(s))
    assert t["report_interval"] == 10000
