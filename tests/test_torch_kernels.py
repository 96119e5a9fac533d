"""The fused-objective CUDA kernel against its plain PyTorch version.

This file imports nothing of JAX, so the card (which has no JAX) can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` build the kernel with nvcc and launch it; they skip
where there is no card. ``python3 chip_smoke.py`` runs the same comparison at
full Spain-2020 width. The unmarked tests check, on the CPU, what surrounds
the kernel: input validation, dispatch by device, and the op count.

Tolerances: in float64 the kernel and the plain version differ only by FMA
contraction and summation order, rtol 1e-10 over a 35-day solve; in float32
the day terms are also summed in another order, rtol 2e-5 at these small
sizes (chip_smoke.py uses 2e-4 at full width, where LL ~1.4e6).
"""

import os
import sys

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch import make_params
from mmidv1_tpu_torch.calibration.objective import make_time_grid
from mmidv1_tpu_torch.calibration.param_space import REFLECT, ParameterSpace
from mmidv1_tpu_torch.data import CalibrationData
from mmidv1_tpu_torch.ops import build_objective_fused, sepaihrd_fused as sf

sys.path.insert(0, os.path.dirname(__file__))
from reference_impl import spain_like_prm  # noqa: E402  (NumPy only)

torch.set_num_threads(1)
NAMES = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2", "kappa_2",
         "sigma"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run this file on the card, or python3 chip_smoke.py)")
    return torch.device("cuda")


def _objective(device, dtype, runup=True):
    """The tests/test_pallas.py problem (35 days, substeps=2, 8 names)."""
    prm = spain_like_prm()
    keys = ("beta", "beta_end_times", "beta_values", "kappa_end_times",
            "kappa_values", "a", "p", "h", "icu", "d_H", "d_ICU", "h_infec",
            "theta", "sigma", "gamma_p", "gamma_A", "gamma_I", "gamma_H",
            "gamma_ICU", "d_community", "seed_exposed")
    params = make_params(N=prm["N"], M_baseline=prm["M"],
                         runup_days=prm["runup_days"] if runup else 0.0,
                         **{k: prm[k] for k in keys}, dtype=dtype, device=device)
    n_days = 35
    rng = np.random.default_rng(9)
    obs = rng.poisson(6.0, size=(n_days, 4)).astype(float)
    obs_icu = obs * 0.2
    obs_icu[5, 2] = np.nan
    obs_d = obs * 0.1
    obs_d[7, 0] = -3.0
    data = CalibrationData.from_arrays(
        new_confirmed=obs, new_hospitalizations=obs, new_icu=obs_icu,
        new_deaths=obs_d, population_by_age=prm["N"],
        initial_cumulative_confirmed=[800.0] * 4,
        initial_cumulative_deaths=[4.0] * 4,
        initial_cumulative_hospitalizations=[25.0] * 4,
        initial_cumulative_icu=[5.0] * 4)
    bounds = {n: (0.01, 2.0) for n in NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(NAMES, bounds, {n: 0.05 for n in NAMES},
                                  params, dtype=dtype, device=device)
    ts = make_time_grid(prm["runup_days"] if runup else 0.0, n_days)
    ll = build_objective_fused(space, params, data, ts, substeps=2,
                               constraint_mode=REFLECT, dtype=dtype,
                               device=device)
    return ll, space.extract(params)


def _args(ll, theta0, B, seed):
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(0.05 * rng.standard_normal((B, theta0.numel())),
                            dtype=theta0.dtype, device=theta0.device)
    return ll.prep.kernel_args(theta0[None, :] + noise)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("tableau", ["dopri5", "cash_karp", "rk4", "fehlberg78"])
def test_kernel_matches_plain_version(cuda, dtype, rtol, tableau):
    for runup in (True, False):
        ll, theta0 = _objective(cuda, dtype, runup)
        for B in (1, 5, 37, 300):
            args, kw, _inf = _args(ll, theta0, B, B)
            kw = dict(kw, substeps=2, tableau=tableau)
            before = sf.fused_objective.launches
            k = sf.fused_objective(*args, **kw)
            torch.cuda.synchronize()
            assert sf.fused_objective.launches == before + 1
            r = sf.fused_objective_reference(*args, **kw)
            assert torch.isfinite(k).all()
            np.testing.assert_allclose(k.double().cpu().numpy(),
                                       r.double().cpu().numpy(), rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_mixed_inputs(cuda):
    ll, theta0 = _objective(cuda, torch.float32)
    args, kw, _inf = _args(ll, theta0, 4, 0)
    with pytest.raises(ValueError):
        sf.fused_objective(args[0].cpu(), *args[1:], **kw)
    with pytest.raises(ValueError):
        sf.fused_objective(args[0].double(), *args[1:], **kw)


def test_wrapper_dispatches_by_device_and_validates():
    """CPU tensors run the plain version (no launch is counted); malformed
    inputs raise before anything runs."""
    ll, theta0 = _objective("cpu", torch.float64)
    args, kw, _inf = _args(ll, theta0, 3, 1)
    before = sf.fused_objective.launches
    out = sf.fused_objective(*args, **kw, substeps=2)
    assert sf.fused_objective.launches == before
    np.testing.assert_array_equal(
        out.numpy(), sf.fused_objective_reference(*args, **kw, substeps=2).numpy())
    y0, M = args[0], args[6]
    bad = [((y0.float(),) + args[1:], kw),                  # mixed dtypes
           ((y0[:, :, :2],) + args[1:], kw),               # wrong chain count
           ((y0.transpose(0, 1).contiguous().transpose(0, 1),) + args[1:], kw),
           (args[:6] + (np.eye(3),), kw),                   # contact matrix
           (args, dict(kw, run_count=kw["run_count"][:-1])),
           (args, dict(kw, runup_offset=kw["runup_offset"] + 1))]
    for a, k in bad:
        with pytest.raises((ValueError, TypeError)):
            sf.fused_objective(*a, **k, substeps=2)
    with pytest.raises(TypeError):
        sf.fused_objective(*(t.to(torch.int64) for t in args[:6]), M, **kw)


def test_op_count_tracks_tableau_work():
    n = sf.op_count("dopri5", 4, 325, 306)
    # 4 lanes x 325 intervals x (41 x 25 RHS + 20 x 25 axpys x 4) + folds
    assert n == 4 * (325 * (41 * 25 + 20 * 25 * 4) + 18 * 306)
    assert sf.op_count("cash_karp", 3, 325, 306) < n
