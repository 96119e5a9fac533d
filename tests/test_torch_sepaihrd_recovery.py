"""Posterior recovery on synthetic SEPAIHRD data with the PyTorch port: the
whole-run test of ``tests/test_sepaihrd_recovery.py`` on the port's eager
objective, and a fast check that its inputs are the JAX test's.

The problem and the bars are in ``tests/torch_recovery.py``. The port draws
from torch's Philox where the JAX test draws from threefry, so the recovery
run is statistical: same settings, same bars, other random numbers.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.objective import build_objective as jbuild
from mmidv1_tpu.calibration.objective import make_time_grid as jgrid
from mmidv1_tpu.calibration.param_space import ParameterSpace as JSpace
from mmidv1_tpu.data import CalibrationData as JData
from mmidv1_tpu.models import sepaihrd as jsep

from mmidv1_tpu_torch.calibration import CLAMP, REFLECT, build_objective

sys.path.insert(0, os.path.dirname(__file__))
import torch_recovery as rec  # noqa: E402

torch.set_num_threads(1)


def _objectives(problem):
    return tuple(build_objective(problem["space"], problem["params"],
                                 problem["data"], problem["ts"],
                                 substeps=rec.SUBSTEPS, constraint_mode=mode)
                 for mode in (CLAMP, REFLECT))


def test_recovery_inputs_match_jax(spain_params):
    """R1's daily means, its Poisson draws and the objective at the truth
    and at the start, built by each package (float64, rtol 1e-10; the
    draws equal)."""
    prm, params = spain_params
    problem = rec.r1_problem()
    ts = jgrid(prm["runup_days"], rec.R1_DAYS)
    np.testing.assert_array_equal(problem["ts"], ts)
    names = list(rec.R1_TRUE)
    space = JSpace.create(names, rec.R1_BOUNDS, rec.R1_SIGMAS, params)
    theta_true = jnp.asarray([rec.R1_TRUE[n] for n in names])
    p_true = space.apply(params, theta_true)
    traj = jsep.solve(p_true, jsep.runup_seeded_state(p_true, None),
                      jnp.asarray(ts), method="fixed", substeps=rec.SUBSTEPS)
    cums = np.asarray(traj)[:, [9, 10, 8]]
    daily = np.maximum(np.diff(cums, axis=0), 0.0)
    runup = int(np.searchsorted(ts, 0.0))
    daily = np.concatenate([np.zeros_like(cums[:1]), daily])[runup:]
    np.testing.assert_allclose(problem["daily"], daily, rtol=1e-10, atol=0)
    obs = rec.poisson_observations(daily)
    for got, want in zip(problem["obs"], obs):
        np.testing.assert_array_equal(got, want)

    data = JData.from_arrays(new_confirmed=obs[0] * 0,
                             new_hospitalizations=obs[0], new_icu=obs[1],
                             new_deaths=obs[2], population_by_age=prm["N"])
    thetas = np.stack([np.asarray(theta_true), np.asarray(rec.R1_START)])
    for mode, tll in zip((CLAMP, REFLECT), _objectives(problem)):
        jll = jbuild(space, params, data, ts, substeps=rec.SUBSTEPS,
                     constraint_mode=mode)
        want = [float(jll(jnp.asarray(th))) for th in thetas]
        assert np.isfinite(want).all()
        np.testing.assert_allclose(tll(torch.as_tensor(thetas)).numpy(), want,
                                   rtol=1e-10)


@pytest.mark.slow
@pytest.mark.campaign
def test_two_phase_recovers_synthetic_truth():
    """``tests/test_sepaihrd_recovery.py:19-74`` on the port: generate
    observations at known (beta_1, theta, seed_exposed), start psomcmc from
    wrong values (PSO 128 x 40, then AM-MH 400 steps x 32 chains), and
    require the truth back within the JAX test's bars."""
    problem = rec.r1_problem()
    ll_c, ll_r = _objectives(problem)
    res = rec.r1_calibrate(
        ll_c, ll_r, problem,
        torch.Generator().manual_seed(rec.R1_CALIBRATION_SEED))
    ll_true = float(ll_c(problem["theta_true"][None])[0])
    missed = rec.r1_missed(res.best_theta.numpy(), res.best_logl, ll_true,
                           res.samples.numpy())
    assert not missed, (missed, res.best_theta.tolist(), float(res.best_logl))
