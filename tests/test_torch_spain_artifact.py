"""The committed Spain-2020 calibration through the PyTorch port:
``tests/test_spain_artifact.py``'s checks of
``results/spain2020/calibrated_parameters.txt`` on the port's float64 eager
objective, triangulated against the independent NumPy/SciPy DOP853 golden
(``tests/reference_impl.solve_golden``).

Grid semantics as in the JAX test: the objective grid is fixed from the
initial guess's ``runup_days`` (reference ``main.cpp:241``); the calibrated
file's own ``runup_days`` is a parameter of the seeding, not of the grid.
"""

import os
import sys

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch.calibration import REFLECT, build_objective
from mmidv1_tpu_torch.cli.common import load_spain_pipeline
from mmidv1_tpu_torch.data import read_sepaihrd_parameters
from mmidv1_tpu_torch.models import sepaihrd

sys.path.insert(0, os.path.dirname(__file__))
from reference_impl import solve_golden  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "results", "spain2020", "calibrated_parameters.txt")
REFERENCE_BEST_LL = 1.41969205e+06     # data/configuration/initial_guess.txt:3


@pytest.fixture(scope="module")
def spain_problem():
    """``tests/test_spain_artifact.py:26-52`` on the port, float64 on the
    host: the committed configuration tree, REFLECT, dopri5@4."""
    pipe = load_spain_pipeline(REPO, dtype=torch.float64, device="cpu")
    loglik = build_objective(pipe.space, pipe.params, pipe.data, pipe.ts,
                             substeps=4, constraint_mode=REFLECT)
    calib = read_sepaihrd_parameters(
        ARTIFACT, 4, N=pipe.data.population_by_age,
        M_baseline=pipe.params.M_baseline.numpy(), dtype=torch.float64,
        device="cpu")
    return pipe, loglik, calib


def test_artifact_exists_and_roundtrips(spain_problem):
    pipe, _loglik, calib = spain_problem
    theta = pipe.space.extract(calib).numpy()
    assert theta.shape == (62,)
    assert np.isfinite(theta).all()
    lo, hi = pipe.space.lower.numpy(), pipe.space.upper.numpy()
    assert (theta >= lo - 1e-9).all() and (theta <= hi + 1e-9).all()


def test_calibrated_params_beat_reference_ll(spain_problem):
    """The port's objective, float64: the calibrated theta beats
    1.41969205e6, and improves on the committed initial guess by > 2e5."""
    pipe, loglik, calib = spain_problem
    ll, ll0 = loglik(torch.stack([pipe.space.extract(calib),
                                  pipe.space.extract(pipe.params)])).tolist()
    assert ll > REFERENCE_BEST_LL, ll
    assert ll - ll0 > 2e5


@pytest.mark.slow
def test_calibrated_params_beat_reference_ll_independent_golden(spain_problem):
    """Triangulation (``tests/test_spain_artifact.py:75-106``): the
    independent NumPy/SciPy DOP853 solve agrees that the artifact beats the
    reference, and agrees with the port's objective at rtol 2e-4."""
    pipe, loglik, calib = spain_problem
    theta = pipe.space.extract(calib)
    params = pipe.space.apply(pipe.params, theta)   # on the base (fixed) grid
    prm = params.to_numpy()
    prm["M"] = prm["M_baseline"]
    y0 = sepaihrd.runup_seeded_state(params, None).numpy()
    ts = pipe.ts
    gold = solve_golden(prm, y0, ts)
    runup = int(np.searchsorted(ts, 0.0))
    cums = gold[:, [9, 10, 8]]
    inc = np.maximum(np.diff(cums, axis=0), 0.0)
    inc = np.concatenate([np.zeros_like(cums[:1]), inc])[runup:] + 1e-10
    data = pipe.data
    obs = np.stack([data.new_hospitalizations, data.new_icu, data.new_deaths],
                   axis=1)
    valid = np.isfinite(obs) & (obs >= 0)
    ll_gold = float(np.sum(np.where(valid, obs * np.log(inc) - inc, 0.0)))
    assert ll_gold > REFERENCE_BEST_LL, ll_gold
    ll_port = float(loglik(theta[None, :])[0])
    np.testing.assert_allclose(ll_port, ll_gold, rtol=2e-4)
