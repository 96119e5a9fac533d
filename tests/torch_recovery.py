"""The real-model problems of the port's whole-run recovery checks, built with
the port alone (torch + NumPy; no JAX).

Two problems, each with the settings and bars of a JAX test:

- **R1**, ``tests/test_sepaihrd_recovery.py:19-74``: Poisson observations over
  60 days from known ``beta_1`` / ``theta`` / ``seed_exposed``, calibrated by
  psomcmc from a wrong start;
- **R3**, ``tests/test_gradients.py:16-35,70-84``: a 30-day, 5-parameter
  problem on random observations, sampled by NUTS.

``tests/test_torch_sepaihrd_recovery.py`` and ``tests/test_torch_gradients.py``
run them on the host through the eager objective and hold the inputs built
here against the JAX package's; ``chip_smoke.py`` runs them on the card
through the kernels (its synthetic data made on the host, as here). The
bars live here once, as functions that return the bars a result misses.
Import it with ``tests/`` on ``sys.path`` (it imports ``reference_impl``).
"""

from __future__ import annotations

import numpy as np
import torch

from mmidv1_tpu_torch import make_params
from mmidv1_tpu_torch.calibration import (MHConfig, NUTSConfig, ParameterSpace,
                                          PSOConfig, calibrate, make_time_grid,
                                          run_nuts)
from mmidv1_tpu_torch.data import CalibrationData
from mmidv1_tpu_torch.models import sepaihrd
from reference_impl import spain_like_prm

F64 = torch.float64

# R1: tests/test_sepaihrd_recovery.py:27-57
R1_DAYS = 60
R1_TRUE = {"beta_1": 0.55, "theta": 0.3, "seed_exposed": 80.0}
R1_BOUNDS = {"beta_1": (0.1, 2.0), "theta": (0.05, 1.0),
             "seed_exposed": (1.0, 400.0)}
R1_SIGMAS = {"beta_1": 0.05, "theta": 0.05, "seed_exposed": 10.0}
R1_START = [0.9, 0.6, 20.0]                   # deliberately wrong
R1_DATA_SEED = 31
R1_CALIBRATION_SEED = 6
R1_PSO = PSOConfig(swarm_size=128, iterations=40)
R1_MH = MHConfig(iterations=400, burn_in=100, adaptation_period=50,
                 thinning=2)
R1_CHAINS = 32
R1_RTOL = {"beta_1": 0.10, "theta": 0.30, "seed_exposed": 0.40}

# R3: tests/test_gradients.py:16-35 and :70-84
R3_DAYS = 30
R3_NAMES = ["beta_1", "theta", "sigma", "seed_exposed", "h_1"]
R3_DATA_SEED = 21
R3_NUTS_SEED = 4
R3_NUTS = NUTSConfig(iterations=25, adaptation_window=10, max_tree_depth=3)
R3_CHAINS = 4

SUBSTEPS = 2


def spain_params(device="cpu", dtype=F64):
    """The port's counterpart of ``tests/conftest.py::spain_params``: the
    same ``spain_like_prm()`` values through the port's ``make_params``."""
    prm = spain_like_prm()
    keys = ("beta", "beta_end_times", "beta_values", "kappa_end_times",
            "kappa_values", "a", "p", "h", "icu", "d_H", "d_ICU", "h_infec",
            "theta", "sigma", "gamma_p", "gamma_A", "gamma_I", "gamma_H",
            "gamma_ICU", "d_community", "seed_exposed", "runup_days")
    params = make_params(N=prm["N"], M_baseline=prm["M"],
                         **{k: prm[k] for k in keys}, dtype=dtype,
                         device=device)
    return prm, params


def r1_daily_means(params_true, ts):
    """The daily (CumH, CumICU, D) increments from the observation window's
    first day, ``(n_days, 3, A)``: the run-up seeded fixed-grid solve at
    ``SUBSTEPS``, differenced and floored at 0, as at
    ``tests/test_sepaihrd_recovery.py:37-43``."""
    y0 = sepaihrd.runup_seeded_state(params_true, None)
    traj = sepaihrd.solve(params_true, y0, ts, method="fixed",
                          substeps=SUBSTEPS)
    cums = traj.detach().cpu().numpy()[:, [9, 10, 8]]
    daily = np.maximum(np.diff(cums, axis=0), 0.0)
    runup = int(np.searchsorted(ts, 0.0))
    return np.concatenate([np.zeros_like(cums[:1]), daily])[runup:]


def poisson_observations(daily, seed=R1_DATA_SEED):
    """Hospital, ICU and death counts drawn in that order from one NumPy
    generator (``tests/test_sepaihrd_recovery.py:44-47``)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.poisson(daily[:, k]).astype(float) for k in range(3))


def r1_problem(device="cpu", dtype=F64):
    """R1's problem. The synthetic data are made on the host in float64;
    the parameters, the space and the thetas live on ``device`` in
    ``dtype``."""
    prm, params_cpu = spain_params("cpu", F64)
    ts = make_time_grid(prm["runup_days"], R1_DAYS)
    names = list(R1_TRUE)
    space_cpu = ParameterSpace.create(names, R1_BOUNDS, R1_SIGMAS, params_cpu,
                                      dtype=F64, device="cpu")
    theta_true = torch.tensor([R1_TRUE[n] for n in names], dtype=F64)
    daily = r1_daily_means(space_cpu.apply(params_cpu, theta_true), ts)
    obs_h, obs_i, obs_d = poisson_observations(daily)
    data = CalibrationData.from_arrays(
        new_confirmed=obs_h * 0, new_hospitalizations=obs_h, new_icu=obs_i,
        new_deaths=obs_d, population_by_age=prm["N"])
    _prm, params = spain_params(device, dtype)
    space = ParameterSpace.create(names, R1_BOUNDS, R1_SIGMAS, params,
                                  dtype=dtype, device=device)
    return dict(prm=prm, params=params, space=space, ts=ts, data=data,
                daily=daily, obs=(obs_h, obs_i, obs_d),
                theta_true=theta_true.to(device, dtype),
                theta0=torch.tensor(R1_START, dtype=dtype, device=device))


def r1_calibrate(ll_clamp, ll_reflect, problem, generator):
    """psomcmc at R1's settings from its wrong start
    (``tests/test_sepaihrd_recovery.py:59-64``)."""
    return calibrate(ll_clamp, ll_reflect, problem["space"],
                     problem["theta0"], generator=generator,
                     algorithm="psomcmc", phase1_config=R1_PSO,
                     mh_config=R1_MH, n_chains=R1_CHAINS)


def r1_missed(best, best_logl, ll_true, samples):
    """The bars of ``tests/test_sepaihrd_recovery.py:64-74`` that a psomcmc
    result misses (empty when it passes). ``best`` is the (3,) best theta,
    ``samples`` the (n_stored, B, 3) MH samples."""
    best = np.asarray(best, dtype=np.float64)
    missed = []
    for k, (name, truth) in enumerate(R1_TRUE.items()):
        if not abs(best[k] - truth) <= R1_RTOL[name] * abs(truth):
            missed.append(f"{name} {float(best[k])!r} not within rtol "
                          f"{R1_RTOL[name]} of {truth}")
    if not float(best_logl) >= float(ll_true) - 5.0:
        missed.append(f"best logL {float(best_logl)!r} < logL(truth) "
                      f"{float(ll_true)!r} - 5")
    post = np.asarray(samples)[-100:].reshape(-1, 3)
    med = float(np.median(post[:, 0]))
    if not abs(med - R1_TRUE["beta_1"]) < 0.15:
        missed.append(f"posterior median of beta_1 {med!r} not within 0.15 "
                      f"of {R1_TRUE['beta_1']}")
    return missed


def r3_problem(device="cpu", dtype=F64):
    """R3's problem (``tests/test_gradients.py:16-35``): observations from
    ``default_rng(21)``, five names, ``theta0`` the base parameters'."""
    prm, params = spain_params(device, dtype)
    obs = np.random.default_rng(R3_DATA_SEED).poisson(
        8.0, size=(R3_DAYS, 4)).astype(float)
    data = CalibrationData.from_arrays(
        new_confirmed=obs, new_hospitalizations=obs, new_icu=obs * 0.2,
        new_deaths=obs * 0.1, population_by_age=prm["N"])
    ts = make_time_grid(prm["runup_days"], R3_DAYS)
    bounds = {n: (0.001, 3.0) for n in R3_NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(R3_NAMES, bounds,
                                  {n: 0.05 for n in R3_NAMES}, params,
                                  dtype=dtype, device=device)
    return dict(prm=prm, params=params, space=space, ts=ts, data=data,
                obs=obs, theta0=space.extract(params))


def r3_nuts(loglik, problem, value_and_grad_batch=None):
    """NUTS at R3's settings from the base parameters
    (``tests/test_gradients.py:73-75``); the gradient by autograd through
    ``loglik`` unless ``value_and_grad_batch`` is given."""
    return run_nuts(loglik, problem["space"], problem["theta0"], R3_NUTS,
                    seed=R3_NUTS_SEED, n_chains=R3_CHAINS,
                    value_and_grad_batch=value_and_grad_batch)


def r3_missed(best_logp, samples, lower, upper, ll_theta0):
    """The bars of ``tests/test_gradients.py:76-84`` that a NUTS result
    misses (empty when it passes); ``samples`` is (iterations, chains, d)."""
    samples = np.asarray(samples, dtype=np.float64)
    lo, hi = np.asarray(lower), np.asarray(upper)
    missed = []
    if not np.isfinite(float(best_logp)):
        missed.append(f"best logp {float(best_logp)!r} is not finite")
    if not np.isfinite(samples).all():
        missed.append("a sample is not finite")
    if not np.std(samples[:, :, 0]) > 0:
        missed.append("the chains did not move in beta_1")
    if not ((samples >= lo - 1e-9).all() and (samples <= hi + 1e-9).all()):
        missed.append("a sample left the bounds")
    if not float(best_logp) >= float(ll_theta0) - 5.0:
        missed.append(f"best logp {float(best_logp)!r} < logL(theta0) "
                      f"{float(ll_theta0)!r} - 5")
    return missed
