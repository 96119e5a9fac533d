"""Two-phase calibration orchestrator (optimizer warm start -> ensemble MCMC).

Port of ``mmidv1_tpu/calibration/calibrator.py``, re-design of
``ModelCalibrator`` + ``SEPAIHRDModelCalibration`` (reference:
``src/sir_age_structured/ModelCalibrator.cpp``,
``src/model/SEPAIHRDModelCalibration.cpp``): Phase 1 runs an optimizer (PSO
or hill climbing) in CLAMP mode, its learned covariance is conditioned and
handed to Phase 2's adaptive-Metropolis ensemble in REFLECT mode; NUTS runs
as a single-phase alternative on the CLAMP objective's gradient.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from .hill import HillClimbConfig, run_hill_climb
from .mh import MHConfig, MHResult, run_mh
from .nuts import NUTSConfig, NUTSResult, run_nuts
from .param_space import ParameterSpace
from .pso import PSOConfig, run_pso


def condition_covariance(cov: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """Phase-1 -> Phase-2 covariance conditioning
    (reference ``ModelCalibrator.cpp:97-134``): symmetrize, floor eigenvalues at
    (0.1 * sigma_i)^2, reconstruct, inflate variance 4x, add trace jitter."""
    d = cov.shape[0]
    cov = 0.5 * (cov + cov.T)
    evals, evecs = torch.linalg.eigh(cov)
    min_var = torch.min((0.1 * sigmas) ** 2)
    evals = torch.maximum(evals, min_var)
    floored = (evecs * evals[None, :]) @ evecs.T
    inflated = floored * 4.0
    eps = 1e-8 * torch.trace(inflated) / d
    return inflated + eps * torch.eye(d, dtype=cov.dtype, device=cov.device)


class CalibrationResult(NamedTuple):
    best_theta: torch.Tensor
    best_logl: torch.Tensor
    samples: Optional[torch.Tensor]         # (n_stored, B, d) MCMC samples
    sample_logls: Optional[torch.Tensor]
    phase1_best: Optional[torch.Tensor]     # None for nuts and phase1=None
    phase1_logl: Optional[torch.Tensor]
    phase1_cov: Optional[torch.Tensor]
    mh_result: Optional[MHResult]
    phase1_seconds: float                   # host clock, device work included
    phase2_seconds: float                   # MCMC: MH, or NUTS
    nuts_result: Optional[NUTSResult] = None


def calibrate(
    loglik_batch_clamp: Callable[[torch.Tensor], torch.Tensor],
    loglik_batch_reflect: Callable[[torch.Tensor], torch.Tensor],
    space: ParameterSpace,
    theta0: torch.Tensor,
    *,
    generator: torch.Generator,
    algorithm: str = "psomcmc",
    phase1: Optional[str] = "auto",
    phase1_config=None,
    mh_config: Optional[MHConfig] = None,
    nuts_config: Optional[NUTSConfig] = None,
    n_chains: int = 8,
    value_and_grad_batch_clamp: Optional[Callable] = None,
) -> CalibrationResult:
    """Run a calibration from the reference's algorithm menu
    (``main.cpp:48-79``: pso/psomcmc, hill/hillmcmc, nuts). Like the
    reference, plain ``pso`` / ``hill`` still run the MCMC phase when
    ``mh_config`` is given. ``phase1`` "auto" derives the optimizer from the
    algorithm; an explicit "pso", "hill" or None (MCMC from ``theta0``)
    overrides it, and ``phase1_config`` is that optimizer's config. The
    batched objectives are built with the two constraint modes (CLAMP for
    the optimizer and NUTS, REFLECT for MCMC). ``nuts`` samples from
    ``theta0`` with ``value_and_grad_batch_clamp`` (the K2/K3 engine,
    :func:`mmidv1_tpu_torch.ops.build_objective_fused_grad`; by default
    ``torch.autograd`` through ``loglik_batch_clamp``). Every draw comes
    from ``generator``."""
    algo = algorithm.lower()
    if algo not in ("pso", "psomcmc", "hill", "hillmcmc", "nuts"):
        raise ValueError(f"Unknown algorithm: {algorithm}. Valid: pso, psomcmc, "
                         "hill, hillmcmc, nuts")
    if phase1 == "auto":
        phase1 = {"pso": "pso", "psomcmc": "pso", "hill": "hill",
                  "hillmcmc": "hill", "nuts": None}[algo]
    elif phase1 not in ("pso", "hill", None):
        raise ValueError(f"Unknown phase1: {phase1!r}. "
                         "Valid: 'auto', 'pso', 'hill', None")

    if algo == "nuts":
        t0 = time.perf_counter()
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        nres = run_nuts(loglik_batch_clamp, space, theta0,
                        nuts_config or NUTSConfig(), seed=seed,
                        n_chains=n_chains,
                        value_and_grad_batch=value_and_grad_batch_clamp)
        float(nres.best_logp)               # wait for the device
        return CalibrationResult(
            best_theta=nres.best_x, best_logl=nres.best_logp,
            samples=nres.samples, sample_logls=nres.sample_logps,
            phase1_best=None, phase1_logl=None, phase1_cov=None,
            mh_result=None, phase1_seconds=0.0,
            phase2_seconds=time.perf_counter() - t0, nuts_result=nres)

    t0 = time.perf_counter()
    phase1_best = phase1_logl = phase1_cov = None
    best_theta = theta0
    if phase1 == "pso":
        pres = run_pso(loglik_batch_clamp, space, phase1_config or PSOConfig(),
                       generator=generator, theta0=theta0)
        phase1_best, phase1_logl, phase1_cov = pres.best_x, pres.best_f, \
            pres.final_cov
    elif phase1 == "hill":
        hres = run_hill_climb(loglik_batch_clamp, space, theta0,
                              phase1_config or HillClimbConfig(),
                              generator=generator)
        phase1_best, phase1_logl, phase1_cov = (hres.best_x, hres.best_logl,
                                                hres.final_cov)
    if phase1 is None:
        best_logl = loglik_batch_clamp(theta0[None, :])[0]
    else:
        best_theta, best_logl = phase1_best, phase1_logl
    float(best_logl)                    # wait for the device
    phase1_seconds = time.perf_counter() - t0

    mh_result = None
    samples = sample_logls = None
    phase2_seconds = 0.0
    if mh_config is not None:
        t0 = time.perf_counter()
        init_cov = None
        if phase1_cov is not None:
            init_cov = condition_covariance(phase1_cov,
                                            space.sigmas.to(best_theta.dtype))
        mh_result = run_mh(loglik_batch_reflect, space, best_theta, mh_config,
                           generator=generator, n_chains=n_chains,
                           initial_cov=init_cov)
        samples, sample_logls = mh_result.samples, mh_result.sample_logps
        if float(mh_result.best_logp) > float(best_logl):
            best_theta, best_logl = mh_result.best_x, mh_result.best_logp
        phase2_seconds = time.perf_counter() - t0

    return CalibrationResult(
        best_theta=best_theta, best_logl=best_logl,
        samples=samples, sample_logls=sample_logls,
        phase1_best=phase1_best, phase1_logl=phase1_logl,
        phase1_cov=phase1_cov, mh_result=mh_result,
        phase1_seconds=phase1_seconds, phase2_seconds=phase2_seconds)
