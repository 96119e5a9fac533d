"""The stiff input of the kernels' zero-coefficient rule, built with the port
alone (torch + NumPy; no JAX).

A zero tableau coefficient contributes nothing in the Pallas kernels and in
the port's plain versions, while ``fma(0, k, y)`` turns ``y`` NaN when ``k``
is not finite. The input here tells the two rules apart. The ICU row is
linear, and its outflow rate ``gamma_ICU`` is raised to ``STIFF_RATE`` in the
BASE parameters (not in theta). dopri5 then runs at ``substeps = 1`` over
``STIFF_DAYS - 1`` daily intervals with no run-up. The stage values of the
row grow like (h r)^i, so on the last interval the new state stays finite
while dopri5's last stage, ``k[6] = f(y_new)``, overflows. That stage is
never read: ``b_6 = 0``, and the next day starts afresh. Under the
skip-a-zero rule the log-likelihood is finite; under ``fma(0, k, y)`` it is
NaN, and the objective gives ``finfo.min``. The rates sit in the
log-middle of the window where this holds for all ``STIFF_CHAINS`` chains,
found with the plain version on the host: float32 3.67e3-6.27e3, float64
1.12e26-1.41e28, at 3 observation days.

``tests/test_torch_zero_coefficients.py`` holds the JAX Pallas kernel and the
port's plain version against each other here; ``tests/test_torch_kernels.py``
and ``chip_smoke.py`` hold the CUDA kernels against the plain version. Import
it with ``tests/`` on ``sys.path`` (it imports ``reference_impl``).
"""

from __future__ import annotations

import numpy as np
import torch

from mmidv1_tpu_torch import make_params
from mmidv1_tpu_torch.calibration.objective import make_time_grid
from mmidv1_tpu_torch.calibration.param_space import REFLECT, ParameterSpace
from mmidv1_tpu_torch.data import CalibrationData
from mmidv1_tpu_torch.ops import build_objective_fused
from reference_impl import spain_like_prm

STIFF_RATE = {"float32": 4.8e3, "float64": 1e27}
STIFF_DAYS = 3
STIFF_CHAINS = 4
TABLEAU, SUBSTEPS = "dopri5", 1
NAMES = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2", "kappa_2",
         "sigma"]
BOUNDS = dict({n: (0.01, 2.0) for n in NAMES}, seed_exposed=(1.0, 500.0))
SIGMAS = {n: 0.05 for n in NAMES}
_PARAM_KEYS = ("beta", "beta_end_times", "beta_values", "kappa_end_times",
               "kappa_values", "a", "p", "h", "icu", "d_H", "d_ICU", "h_infec",
               "theta", "sigma", "gamma_p", "gamma_A", "gamma_I", "gamma_H",
               "gamma_ICU", "d_community", "seed_exposed")


def stiff_prm(dtype_name: str) -> dict:
    """The Spain-like parameters with ``gamma_ICU`` at the stiff rate of
    ``dtype_name`` and no run-up (NumPy values)."""
    prm = spain_like_prm()
    prm["gamma_ICU"] = STIFF_RATE[dtype_name]
    prm["runup_days"] = 0.0
    return prm


def stiff_param_kwargs(prm: dict) -> dict:
    """The keyword arguments of either package's ``make_params``."""
    return dict(N=prm["N"], M_baseline=prm["M"], runup_days=prm["runup_days"],
                **{k: prm[k] for k in _PARAM_KEYS})


def stiff_data_kwargs(prm: dict) -> dict:
    """The keyword arguments of either package's
    ``CalibrationData.from_arrays``: ``STIFF_DAYS`` days of observations."""
    obs = np.random.default_rng(9).poisson(6.0, size=(STIFF_DAYS, 4)).astype(float)
    return dict(new_confirmed=obs, new_hospitalizations=obs,
                new_icu=obs * 0.2, new_deaths=obs * 0.1,
                population_by_age=prm["N"],
                initial_cumulative_confirmed=[800.0] * 4,
                initial_cumulative_deaths=[4.0] * 4,
                initial_cumulative_hospitalizations=[25.0] * 4,
                initial_cumulative_icu=[5.0] * 4)


def stiff_thetas(theta0: np.ndarray) -> np.ndarray:
    """``STIFF_CHAINS`` points 0.01 (in theta's units) around ``theta0``."""
    rng = np.random.default_rng(0)
    theta0 = np.asarray(theta0, dtype=np.float64)
    return theta0[None, :] + 0.01 * rng.standard_normal((STIFF_CHAINS,
                                                         theta0.size))


def stiff_objective(dtype: torch.dtype, device):
    """``(loglik_batch, thetas)``: the port's fused objective at the stiff
    input (REFLECT, dopri5 at one substep) and its ``STIFF_CHAINS`` points,
    on ``device``."""
    dtype_name = str(dtype).replace("torch.", "")
    prm = stiff_prm(dtype_name)
    params = make_params(**stiff_param_kwargs(prm), dtype=dtype, device=device)
    data = CalibrationData.from_arrays(**stiff_data_kwargs(prm))
    space = ParameterSpace.create(NAMES, BOUNDS, SIGMAS, params, dtype=dtype,
                                  device=device)
    ts = make_time_grid(0.0, STIFF_DAYS)
    ll = build_objective_fused(space, params, data, ts, substeps=SUBSTEPS,
                               tableau=TABLEAU, constraint_mode=REFLECT,
                               dtype=dtype, device=device)
    theta0 = space.extract(params).double().cpu().numpy()
    thetas = torch.as_tensor(stiff_thetas(theta0), dtype=dtype, device=device)
    return ll, thetas
