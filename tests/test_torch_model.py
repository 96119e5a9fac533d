"""The PyTorch port's parameters, model and parameter space against the JAX
package, in float64 on the CPU.

Both sides get identical inputs: the JAX objects are converted to NumPy and
handed to the port (``params_from_numpy`` / ``space_from_numpy``). The RHS,
the fixed-grid solve and the initial states run the same float64 operations
in the same order, so the bar is rtol 1e-12; the parameter space only copies,
clips and reflects values, so it must agree exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.models import sepaihrd as jsep

from mmidv1_tpu_torch.calibration.param_space import space_from_numpy
from mmidv1_tpu_torch.models import sepaihrd as tsep
from mmidv1_tpu_torch.params import FIELDS, params_from_numpy

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_torch_params(p, dtype=torch.float64):
    """A JAX ``SEPAIHRDParams`` as the port's, on the CPU."""
    return params_from_numpy({f: np.asarray(getattr(p, f)) for f in FIELDS},
                             device="cpu", dtype=dtype)


def to_torch_space(s, tparams, dtype=torch.float64):
    """A JAX ``ParameterSpace`` as the port's, on the CPU."""
    return space_from_numpy(s.names, np.asarray(s.lower), np.asarray(s.upper),
                            np.asarray(s.sigmas), tparams, dtype=dtype,
                            device="cpu")


@pytest.fixture(scope="module")
def spain_space():
    """The 62-name Spain-2020 space of both packages."""
    from mmidv1_tpu.cli.common import load_spain_pipeline

    pipe = load_spain_pipeline(REPO, dtype=jnp.float64)
    tparams = to_torch_params(pipe.params)
    return pipe.params, pipe.space, tparams, to_torch_space(pipe.space, tparams)


def test_params_from_numpy_roundtrip(spain_params):
    _prm, params = spain_params
    tp = to_torch_params(params)
    back = tp.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(params, f)))
    assert tp.dtype == torch.float64 and tp.device.type == "cpu"
    with pytest.raises(ValueError):
        params_from_numpy({"N": np.ones(4)}, device="cpu")


def test_rhs_frozen_matches_jax(spain_params):
    _prm, params = spain_params
    tp = to_torch_params(params)
    rng = np.random.default_rng(0)
    N = np.asarray(params.N)
    y = rng.uniform(0.0, 1.0, (11, 4)) * N[None, :] * 0.1
    for beta_eff in (0.3, 0.07):
        a = np.asarray(jsep.rhs_frozen(0.0, jnp.asarray(y), params, beta_eff))
        b = tsep.rhs_frozen(0.0, torch.as_tensor(y), tp,
                            torch.tensor(beta_eff, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("tableau,substeps", [("dopri5", 2), ("cash_karp", 3)])
def test_solve_fixed_matches_jax(spain_params, tableau, substeps):
    _prm, params = spain_params
    tp = to_torch_params(params)
    y0 = jsep.runup_seeded_state(params, None)
    ts = np.arange(-5.0, 20.0)
    a = np.asarray(jsep.solve(params, y0, ts, method="fixed", tableau=tableau,
                              substeps=substeps))
    b = tsep.solve(tp, torch.as_tensor(np.array(y0)), ts, method="fixed",
                   tableau=tableau, substeps=substeps).numpy()
    assert b.shape == a.shape == (25, 11, 4)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-9)


def test_initial_state_branches_match_jax(spain_params):
    _prm, params = spain_params
    base = np.abs(np.random.default_rng(1).normal(50.0, 20.0, (11, 4)))
    cases = [params,                                        # run-up seeding
             params.replace(seed_exposed=jnp.zeros(()),     # multipliers
                            E0_multiplier=jnp.asarray(1.7)),
             params.replace(runup_days=jnp.zeros(()),       # infeasible
                            E0_multiplier=jnp.asarray(1e9))]
    for p in cases:
        ya, inf_a = jsep.initial_state_for_params(p, base)
        yb, inf_b = tsep.initial_state_for_params(to_torch_params(p),
                                                  torch.as_tensor(base))
        np.testing.assert_allclose(yb.numpy(), np.asarray(ya), rtol=1e-12)
        assert bool(inf_b) == bool(inf_a)
    assert bool(inf_a)


def test_infer_initial_state_matches_jax(spain_params):
    _prm, params = spain_params
    kw = dict(cumulative_confirmed_day0=np.array([800.0, 900.0, 400.0, 100.0]),
              cumulative_deaths_day0=np.array([4.0, 6.0, 30.0, 80.0]),
              cumulative_hosp_day0=np.array([25.0, 40.0, 90.0, 60.0]),
              cumulative_icu_day0=np.array([5.0, 8.0, 20.0, 4.0]))
    rates = {k: np.asarray(getattr(params, k)) for k in
             ("sigma", "gamma_p", "gamma_A", "gamma_I", "p", "h")}
    a = jsep.infer_initial_state(N=jnp.asarray(np.asarray(params.N)),
                                 **{k: jnp.asarray(v) for k, v in kw.items()},
                                 **{k: jnp.asarray(v) for k, v in rates.items()})
    b = tsep.infer_initial_state(N=torch.as_tensor(np.asarray(params.N)),
                                 **{k: torch.as_tensor(v) for k, v in kw.items()},
                                 **{k: torch.as_tensor(v) for k, v in rates.items()})
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)


def test_param_space_matches_jax_exactly(spain_space):
    params, space, tparams, tspace = spain_space
    assert tspace.names == space.names and tspace.dim == 62
    rng = np.random.default_rng(5)
    lo, hi = np.asarray(space.lower), np.asarray(space.upper)
    # inside, below and above the bounds, several widths out
    thetas = lo + (hi - lo) * rng.uniform(-2.5, 3.5, (9, 62))
    tt = torch.as_tensor(thetas)
    np.testing.assert_array_equal(tspace.reflect(tt).numpy(),
                                  np.asarray(jax.vmap(space.reflect)(thetas)))
    np.testing.assert_array_equal(tspace.clamp(tt).numpy(),
                                  np.asarray(jax.vmap(space.clamp)(thetas)))
    inside = np.asarray(jax.vmap(space.reflect)(thetas))
    applied = tspace.apply(tparams, torch.as_tensor(inside))
    for i in range(inside.shape[0]):
        ja = space.apply(params, jnp.asarray(inside[i]))
        for f in FIELDS:
            want = np.asarray(getattr(ja, f))
            got = getattr(applied, f).numpy()
            got = got[i] if got.ndim > want.ndim else got
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tspace.extract(applied).numpy(), inside)
    np.testing.assert_array_equal(tspace.extract(tparams).numpy(),
                                  np.asarray(space.extract(params)))
    np.testing.assert_array_equal(tspace.in_bounds(tt).numpy(),
                                  np.asarray(jax.vmap(space.in_bounds)(thetas)))


@pytest.mark.parametrize("compensated", [False, True])
def test_fold_times_fixed_matches_jax(compensated):
    """The fixed-grid fold (with the per-interval projection and, optionally,
    the Kahan-compensated state) against the JAX integrator on a linear ODE
    with a per-interval rate."""
    from mmidv1_tpu.ode import fold_times_fixed as jfold
    from mmidv1_tpu_torch.ode import fold_times_fixed as tfold

    A = np.array([[-0.3, 0.1, 0.0], [0.2, -0.5, 0.1], [0.1, 0.4, -0.1]])
    y0 = np.array([1.0, 2.0, 0.5])
    ts = np.arange(0.0, 12.0)
    rates = np.linspace(0.5, 1.5, len(ts) - 1)
    mk = lambda lib, M: (lambda t, y, r: r * (M @ y))
    pre = lambda y: y * np.array([1.0, 1.0, 0.0]) if isinstance(y, np.ndarray) \
        else y * y.new_tensor([1.0, 1.0, 0.0])
    fold = lambda acc, i, y: acc + (i + 1) * y[2]
    kw = dict(substeps=3, method="cash_karp", compensated=compensated)
    a, ya = jfold(mk(jnp, jnp.asarray(A)), jnp.asarray(y0), jnp.asarray(ts),
                  fold, jnp.zeros(()), interval_ctx=jnp.asarray(rates),
                  pre_interval=lambda y: y * jnp.asarray([1.0, 1.0, 0.0]), **kw)
    b, yb = tfold(mk(torch, torch.as_tensor(A)), torch.as_tensor(y0), ts, fold,
                  torch.zeros(()), interval_ctx=torch.as_tensor(rates),
                  pre_interval=pre, **kw)
    np.testing.assert_allclose(float(b), float(a), rtol=1e-12)
    np.testing.assert_allclose(yb.numpy(), np.asarray(ya), rtol=1e-12)
