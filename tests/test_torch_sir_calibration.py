"""The PyTorch port's age-SIR calibration path against the JAX package, on
the CPU: the parameter space (name grammar, default sigmas, error texts,
apply / extract), the batched Poisson incidence objective against
``jax.vmap`` of the JAX scalar objective (float64, rtol 1e-12, ``-inf``
confined to the failing chain), and a small hill + AM-MH run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.param_space import CLAMP, REFLECT
from mmidv1_tpu.calibration.sir_objective import build_sir_objective as jbuild
from mmidv1_tpu.calibration.sir_space import SIRParameterSpace as JSpace
from mmidv1_tpu.models import sir as jsir
from mmidv1_tpu.utils.exceptions import InvalidParameterException as JInvalid

from mmidv1_tpu_torch.calibration import calibrator as tcal
from mmidv1_tpu_torch.calibration.hill import HillClimbConfig
from mmidv1_tpu_torch.calibration.mh import MHConfig
from mmidv1_tpu_torch.calibration.sir_objective import (SIM_FLOOR,
                                                        build_sir_objective)
from mmidv1_tpu_torch.calibration.sir_space import SIRParameterSpace
from mmidv1_tpu_torch.models import sir as tsir
from mmidv1_tpu_torch.utils.exceptions import InvalidParameterException

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
NAMES = ["q", "scale_C_total", "gamma_0", "gamma_1"]


@pytest.fixture(scope="module")
def sir_setup():
    """The synthetic problem of ``tests/test_sir_calibration.py``."""
    kw = dict(N=np.array([5e5, 5e5]), C=np.array([[3.0, 1.0], [1.0, 2.0]]),
              q=0.08, gamma=[0.12, 0.2], scale_C=1.0)
    jtrue = jsir.make_age_sir_params(**kw)
    ttrue = tsir.make_age_sir_params(**kw, device="cpu")
    I0 = np.array([50.0, 20.0])
    y0 = np.stack([kw["N"] - I0, I0, np.zeros(2)])
    ts = np.arange(60.0)
    traj = jsir.solve_age_sir(jtrue, jnp.asarray(y0), jnp.asarray(ts),
                              substeps=2)
    lam_S = np.asarray(jsir.sir_incidence(jtrue, traj))
    observed = np.random.default_rng(5).poisson(np.maximum(lam_S, 0.0)) \
        .astype(float)
    observed[3, 1] = -4.0            # a negative observation is clamped at 0
    return jtrue, ttrue, y0, ts, observed


def test_sir_space_grammar_and_error_texts(sir_setup):
    """``tests/test_sir_calibration.py:38`` on the port, and the same texts
    as the JAX space for every rejected name."""
    jtrue, ttrue, *_ = sir_setup
    bounds = {n: (0.001, 2.0) for n in NAMES}
    bounds["gamma_1"] = (2.0, 0.01)                 # inverted: swapped
    space = SIRParameterSpace.create(NAMES, bounds, None, ttrue, device="cpu")
    jspace = JSpace.create(NAMES, bounds, None, jtrue)
    for f in ("lower", "upper", "sigmas"):
        np.testing.assert_array_equal(getattr(space, f).numpy(),
                                      np.asarray(getattr(jspace, f)))
    np.testing.assert_allclose(space.sigmas.numpy(), [0.05, 0.05, 0.01, 0.01])
    assert space.lower[3] == 0.01 and space.upper[3] == 2.0
    theta = space.extract(ttrue)
    np.testing.assert_allclose(theta.numpy(), [0.08, 1.0, 0.12, 0.2])
    p2 = space.apply(ttrue, T([0.1, 1.2, 0.3, 0.4]))
    assert float(p2.q) == 0.1 and float(p2.scale_C) == 1.2
    np.testing.assert_array_equal(p2.gamma.numpy(), [0.3, 0.4])
    # a batch of thetas gives batched fields, values copied exactly
    pb = space.apply(ttrue, T([[0.1, 1.2, 0.3, 0.4], [0.2, 0.7, 0.5, 0.6]]))
    assert pb.q.shape == (2,) and pb.gamma.shape == (2, 2)
    np.testing.assert_array_equal(space.extract(pb).numpy(),
                                  [[0.1, 1.2, 0.3, 0.4], [0.2, 0.7, 0.5, 0.6]])
    for names, bnds in (([], {}), (["q", "q"], {"q": (0, 1)}),
                        (["beta"], {"beta": (0, 1)}),
                        (["gamma_7"], {"gamma_7": (0, 1)}),
                        (["gamma_x"], {"gamma_x": (0, 1)}),
                        (["q"], {})):
        with pytest.raises(JInvalid) as ja:
            JSpace.create(names, bnds, None, jtrue)
        with pytest.raises(InvalidParameterException) as ta:
            SIRParameterSpace.create(names, bnds, None, ttrue, device="cpu")
        assert str(ta.value) == str(ja.value)


def _spaces(sir_setup, names=NAMES):
    jtrue, ttrue, *_ = sir_setup
    bounds = {"q": (0.005, 0.5), "scale_C_total": (0.25, 4.0),
              "gamma_0": (0.02, 0.6), "gamma_1": (0.02, 0.6)}
    return (JSpace.create(names, bounds, None, jtrue),
            SIRParameterSpace.create(names, bounds, None, ttrue, device="cpu"))


@pytest.mark.parametrize("mode", [CLAMP, REFLECT])
def test_batched_objective_matches_vmap(sir_setup, mode):
    jtrue, ttrue, y0, ts, observed = sir_setup
    jspace, space = _spaces(sir_setup)
    jll = jax.jit(jax.vmap(jbuild(jspace, jtrue, observed, ts, y0, substeps=2,
                                  constraint_mode=mode)))
    tll = build_sir_objective(space, ttrue, observed, ts, y0, substeps=2,
                              constraint_mode=mode)
    rng = np.random.default_rng(3)
    thetas = np.array([[0.08, 1.0, 0.12, 0.2]] * 3
                      + rng.uniform([0.0, 0.1, 0.0, 0.0], [0.6, 5.0, 0.7, 0.7],
                                    (9, 4)).tolist())
    a = np.asarray(jll(jnp.asarray(thetas)))
    b = tll(T(thetas))
    assert b.shape == (12,) and b.dtype == torch.float64
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-12)
    assert np.isfinite(a).all()
    assert SIM_FLOOR == 1e-9


def test_nan_lane_is_minus_inf_alone(sir_setup):
    """A NaN parameter poisons its own chain's trajectory: that chain gets
    ``-inf``, every other chain its finite value (the JAX objective,
    vmapped, does the same)."""
    jtrue, ttrue, y0, ts, observed = sir_setup
    jspace, space = _spaces(sir_setup)
    tll = build_sir_objective(space, ttrue, observed, ts, y0, substeps=2)
    jll = jax.vmap(jbuild(jspace, jtrue, observed, ts, y0, substeps=2))
    thetas = np.array([[0.08, 1.0, 0.12, 0.2], [0.08, 1.0, np.nan, 0.2],
                       [0.1, 0.9, 0.15, 0.25]])
    b = tll(T(thetas)).numpy()
    a = np.asarray(jll(jnp.asarray(thetas)))
    assert b[1] == -np.inf and a[1] == -np.inf
    assert np.isfinite(b[[0, 2]]).all()
    np.testing.assert_allclose(b[[0, 2]], a[[0, 2]], rtol=1e-12)
    # the same chains alone give the same values
    np.testing.assert_array_equal(tll(T(thetas[[0, 2]])).numpy(), b[[0, 2]])


def test_grid_mismatch_raises(sir_setup):
    _jtrue, ttrue, y0, ts, observed = sir_setup
    _jspace, space = _spaces(sir_setup)
    with pytest.raises(ValueError, match="rows but the time grid"):
        build_sir_objective(space, ttrue, observed[:-1], ts, y0)


def test_hillmcmc_run_beats_its_start(sir_setup):
    """A small hill + AM-MH calibration from a wrong start on the port's
    generator: the best chain beats the start, the samples are finite and
    in bounds."""
    _jtrue, ttrue, y0, ts, observed = sir_setup
    _jspace, space = _spaces(sir_setup)
    ll_c, ll_r = (build_sir_objective(space, ttrue, observed, ts, y0,
                                      substeps=2, constraint_mode=m)
                  for m in (CLAMP, REFLECT))
    theta0 = T([0.05, 1.5, 0.1, 0.1])
    ll0 = float(ll_c(theta0[None])[0])
    gen = torch.Generator().manual_seed(2)
    res = tcal.calibrate(ll_c, ll_r, space, theta0, generator=gen,
                         algorithm="hillmcmc",
                         phase1_config=HillClimbConfig(iterations=6),
                         mh_config=MHConfig(iterations=8, burn_in=2,
                                            adaptation_period=4, thinning=1),
                         n_chains=4)
    assert float(res.best_logl) > ll0
    assert res.samples.shape == (8, 4, 4)
    assert torch.isfinite(res.samples).all()
    assert bool(space.in_bounds(res.samples).all())
    np.testing.assert_allclose(float(ll_c(res.best_theta[None])[0]),
                               float(res.best_logl), rtol=1e-12)


@pytest.mark.slow
def test_sir_calibration_demo_recovers_truth(sir_setup):
    """``tests/test_sir_calibration.py:76-100`` on the port: hill (120
    iterations) + AM-MH (400 x 16 chains) from a wrong start recovers the
    identified q * scale_C and both gammas on the JAX test's synthetic data
    (this file's fixture without its deliberately negative observation).
    The port draws from torch's Philox where the JAX test draws from
    threefry: same settings and bars, other random numbers."""
    _jtrue, ttrue, y0, ts, observed_neg = sir_setup
    lam_S = tsir.sir_incidence(ttrue, tsir.solve_age_sir(
        ttrue, T(y0), T(ts), substeps=2)).numpy()
    observed = np.random.default_rng(5).poisson(np.maximum(lam_S, 0.0)) \
        .astype(float)
    differ = observed != observed_neg
    assert differ.sum() == 1 and differ[3, 1]
    _jspace, space = _spaces(sir_setup)
    ll_c, ll_r = (build_sir_objective(space, ttrue, observed, ts, y0,
                                      substeps=2, constraint_mode=m)
                  for m in (CLAMP, REFLECT))
    res = tcal.calibrate(ll_c, ll_r, space, T([0.05, 1.5, 0.1, 0.1]),
                         generator=torch.Generator().manual_seed(2),
                         algorithm="hillmcmc",
                         phase1_config=HillClimbConfig(iterations=120),
                         mh_config=MHConfig(iterations=400, burn_in=100,
                                            adaptation_period=50, thinning=2),
                         n_chains=16)
    best = res.best_theta.numpy()
    np.testing.assert_allclose(best[0] * best[1], 0.08 * 1.0, rtol=0.1)
    np.testing.assert_allclose(best[2], 0.12, rtol=0.25)
    np.testing.assert_allclose(best[3], 0.2, rtol=0.25)
    ll_best = float(ll_c(T(best)[None])[0])
    ll_true = float(ll_c(space.extract(ttrue)[None])[0])
    assert ll_best > ll_true - 10.0   # fits at least ~as well as the truth
