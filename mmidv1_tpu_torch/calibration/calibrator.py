"""Two-phase calibration orchestrator (PSO warm start -> ensemble MCMC).

Port of ``mmidv1_tpu/calibration/calibrator.py``, re-design of
``ModelCalibrator`` + ``SEPAIHRDModelCalibration`` (reference:
``src/sir_age_structured/ModelCalibrator.cpp``,
``src/model/SEPAIHRDModelCalibration.cpp``): Phase 1 runs PSO in CLAMP mode,
its pbest covariance is conditioned and handed to Phase 2's
adaptive-Metropolis ensemble in REFLECT mode; NUTS runs as a single-phase
alternative on the CLAMP objective's gradient.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from .mh import MHConfig, MHResult, run_mh
from .nuts import NUTSConfig, NUTSResult, run_nuts
from .param_space import ParameterSpace
from .pso import PSOConfig, run_pso

_LATER = {"hill": "hill climbing", "hillmcmc": "hill climbing"}


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
    phase1_best: Optional[torch.Tensor]     # None for nuts
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
    phase1_config: Optional[PSOConfig] = None,
    mh_config: Optional[MHConfig] = None,
    nuts_config: Optional[NUTSConfig] = None,
    n_chains: int = 8,
    value_and_grad_batch_clamp: Optional[Callable] = None,
) -> CalibrationResult:
    """Run a calibration from the reference's algorithm menu
    (``main.cpp:48-79``). ``pso``, ``psomcmc`` and ``nuts`` are ported; like
    the reference, plain ``pso`` still runs the MCMC phase when ``mh_config``
    is given. The batched objectives are built with the two constraint modes
    (CLAMP for the optimizer and NUTS, REFLECT for MCMC). ``nuts`` samples
    from ``theta0`` with ``value_and_grad_batch_clamp`` (the K2/K3 engine,
    :func:`mmidv1_tpu_torch.ops.build_objective_fused_grad`; by default
    ``torch.autograd`` through ``loglik_batch_clamp``), seeded from
    ``generator``."""
    algo = algorithm.lower()
    if algo in _LATER:
        raise NotImplementedError(
            f"algorithm {algorithm!r} needs {_LATER[algo]}, which a later "
            "slice of the port brings; use 'pso' or 'psomcmc'")
    if algo not in ("pso", "psomcmc", "nuts"):
        raise ValueError(f"Unknown algorithm: {algorithm}. Valid: pso, psomcmc, "
                         "hill, hillmcmc, nuts")

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
    pres = run_pso(loglik_batch_clamp, space, phase1_config or PSOConfig(),
                   generator=generator, theta0=theta0)
    best_theta, best_logl = pres.best_x, pres.best_f
    float(best_logl)                    # wait for the device
    phase1_seconds = time.perf_counter() - t0

    mh_result = None
    samples = sample_logls = None
    phase2_seconds = 0.0
    if mh_config is not None:
        t0 = time.perf_counter()
        init_cov = condition_covariance(pres.final_cov,
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
        phase1_best=pres.best_x, phase1_logl=pres.best_f,
        phase1_cov=pres.final_cov, mh_result=mh_result,
        phase1_seconds=phase1_seconds, phase2_seconds=phase2_seconds)
