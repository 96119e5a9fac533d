"""SEPAIHRD parameters as a dataclass of tensors, and piecewise schedules.

Port of ``mmidv1_tpu/params.py``. Every field is a ``torch.Tensor`` on one
device and of one float dtype. A field may carry leading batch dimensions:
:meth:`mmidv1_tpu_torch.calibration.param_space.ParameterSpace.apply` turns a
``(B, d)`` theta batch into parameters whose calibrated fields are ``(B,)``
(scalars) or ``(B, n)`` (age vectors, schedules) while the others stay
unbatched; the model functions broadcast one against the other.

Schedule semantics (identical to the reference):
  value(t) = values[0]                        for t <= end_times[0]  (and for t < 0)
  value(t) = values[i]                        for end_times[i-1] < t <= end_times[i]
  value(t) = values[-1]                       for t >  end_times[-1]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SEPAIHRDParams:
    """All parameters of the age-structured SEPAIHRD model.

    Age-vector fields have shape ``(..., n_ages)``; schedule fields
    ``(..., n_periods)``; everything else is a scalar ``(...)``.
    """

    # Demographics / contacts
    N: torch.Tensor
    M_baseline: torch.Tensor
    contact_matrix_scaling_factor: torch.Tensor

    # Transmission
    beta: torch.Tensor
    beta_end_times: torch.Tensor
    beta_values: torch.Tensor
    a: torch.Tensor
    h_infec: torch.Tensor
    theta: torch.Tensor

    # Progression rates
    sigma: torch.Tensor
    gamma_p: torch.Tensor
    gamma_A: torch.Tensor
    gamma_I: torch.Tensor
    gamma_H: torch.Tensor
    gamma_ICU: torch.Tensor

    # Age-specific severity
    p: torch.Tensor
    h: torch.Tensor
    icu: torch.Tensor
    d_H: torch.Tensor
    d_ICU: torch.Tensor
    d_community: torch.Tensor

    # NPI schedule (kappa); kappa_values[0] is the baseline period value
    kappa_end_times: torch.Tensor
    kappa_values: torch.Tensor

    # Initial state multipliers
    E0_multiplier: torch.Tensor
    P0_multiplier: torch.Tensor
    A0_multiplier: torch.Tensor
    I0_multiplier: torch.Tensor
    H0_multiplier: torch.Tensor
    ICU0_multiplier: torch.Tensor
    R0_multiplier: torch.Tensor
    D0_multiplier: torch.Tensor

    # Run-up seeding
    runup_days: torch.Tensor
    seed_exposed: torch.Tensor

    @property
    def n_ages(self) -> int:
        return int(self.N.shape[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.beta.dtype

    @property
    def device(self) -> torch.device:
        return self.beta.device

    def replace(self, **changes) -> "SEPAIHRDParams":
        return dataclasses.replace(self, **changes)

    def to(self, device=None, dtype: torch.dtype = None) -> "SEPAIHRDParams":
        """A copy with every field moved to ``device`` and cast to ``dtype``."""
        return SEPAIHRDParams(**{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)})

    def contact_matrix(self) -> torch.Tensor:
        """Effective contact matrix (scaled baseline), ``(..., A, A)``."""
        s = self.contact_matrix_scaling_factor
        return self.M_baseline * s[..., None, None]

    def to_numpy(self) -> dict:
        """``{field: np.ndarray}``, the inverse of :func:`params_from_numpy`."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}


FIELDS = tuple(f.name for f in dataclasses.fields(SEPAIHRDParams))


def params_from_numpy(d: dict, device="cuda",
                      dtype: torch.dtype = torch.float64) -> SEPAIHRDParams:
    """Build :class:`SEPAIHRDParams` from ``{field: array}`` (every field
    required). This is how parameters cross over from the JAX package:
    ``{f: np.asarray(getattr(p, f)) for f in FIELDS}``."""
    missing = [f for f in FIELDS if f not in d]
    if missing:
        raise ValueError(f"missing parameter fields: {missing}")
    dev = resolve_device(device)
    return SEPAIHRDParams(**{
        f: torch.as_tensor(np.array(d[f], dtype=np.float64)).to(
            device=dev, dtype=dtype)
        for f in FIELDS})


def make_params(
    *,
    N,
    M_baseline,
    beta=0.3,
    beta_end_times=(),
    beta_values=(),
    a=None,
    h_infec=None,
    theta=0.2,
    sigma=0.3,
    gamma_p=0.5,
    gamma_A=0.25,
    gamma_I=0.244,
    gamma_H=0.2,
    gamma_ICU=0.1,
    p=None,
    h=None,
    icu=None,
    d_H=None,
    d_ICU=None,
    d_community=None,
    kappa_end_times=(),
    kappa_values=(),
    E0_multiplier=1.0,
    P0_multiplier=1.0,
    A0_multiplier=1.0,
    I0_multiplier=1.0,
    H0_multiplier=1.0,
    ICU0_multiplier=1.0,
    R0_multiplier=1.0,
    D0_multiplier=1.0,
    runup_days=30.0,
    seed_exposed=10.0,
    contact_matrix_scaling_factor=1.0,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> SEPAIHRDParams:
    """Build validated :class:`SEPAIHRDParams` from host-side values.

    Defaults for severity vectors are zeros; ``a``/``h_infec`` default to ones.
    Mirrors the construction-time validation of
    ``SEPAIHRDParameters::validate`` (reference:
    ``include/model/parameters/SEPAIHRDParameters.hpp:126-179``).
    """
    N = np.asarray(N, dtype=np.float64)
    A = N.shape[-1]

    def vec(x, default):
        if x is None:
            x = np.full((A,), default, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        if x.shape[-1] != A:
            raise ValueError(f"age-vector parameter has size {x.shape[-1]}, expected {A}")
        return x

    M_baseline = np.asarray(M_baseline, dtype=np.float64)
    if M_baseline.shape[-2:] != (A, A):
        raise ValueError(f"contact matrix shape {M_baseline.shape} != ({A},{A})")

    beta_end_times = np.asarray(beta_end_times, dtype=np.float64)
    beta_values = np.asarray(beta_values, dtype=np.float64)
    if beta_end_times.shape != beta_values.shape:
        raise ValueError("beta_end_times and beta_values must have matching sizes")
    if beta_end_times.size and np.any(np.diff(beta_end_times) <= 0):
        raise ValueError("beta_end_times must be strictly increasing")
    kappa_end_times = np.asarray(kappa_end_times, dtype=np.float64)
    kappa_values = np.asarray(kappa_values, dtype=np.float64)
    if kappa_end_times.shape != kappa_values.shape:
        raise ValueError("kappa_end_times and kappa_values must have matching sizes")
    if kappa_end_times.size and np.any(np.diff(kappa_end_times) <= 0):
        raise ValueError("kappa_end_times must be strictly increasing")

    p_vec = vec(p, 0.0)
    if np.any(p_vec < 0) or np.any(p_vec > 1):
        raise ValueError("p must lie in [0, 1]")
    for name, val in [("beta", beta), ("theta", theta), ("sigma", sigma),
                      ("gamma_p", gamma_p), ("gamma_A", gamma_A), ("gamma_I", gamma_I),
                      ("gamma_H", gamma_H), ("gamma_ICU", gamma_ICU)]:
        if float(np.asarray(val)) < 0:
            raise ValueError(f"{name} must be non-negative")
    for name, val in [("a", vec(a, 1.0)), ("h_infec", vec(h_infec, 1.0)),
                      ("h", vec(h, 0.0)), ("icu", vec(icu, 0.0)),
                      ("d_H", vec(d_H, 0.0)), ("d_ICU", vec(d_ICU, 0.0)),
                      ("d_community", vec(d_community, 0.0))]:
        if np.any(val < 0):
            raise ValueError(f"{name} must be non-negative")
    if np.any(beta_values < 0) or not np.all(np.isfinite(beta_values)):
        raise ValueError("beta_values must be finite and non-negative")
    if np.any(kappa_values < 0) or not np.all(np.isfinite(kappa_values)):
        raise ValueError("kappa_values must be finite and non-negative")

    return params_from_numpy(dict(
        N=N, M_baseline=M_baseline,
        contact_matrix_scaling_factor=contact_matrix_scaling_factor,
        beta=beta, beta_end_times=beta_end_times, beta_values=beta_values,
        a=vec(a, 1.0), h_infec=vec(h_infec, 1.0), theta=theta,
        sigma=sigma, gamma_p=gamma_p, gamma_A=gamma_A, gamma_I=gamma_I,
        gamma_H=gamma_H, gamma_ICU=gamma_ICU,
        p=p_vec, h=vec(h, 0.0), icu=vec(icu, 0.0),
        d_H=vec(d_H, 0.0), d_ICU=vec(d_ICU, 0.0),
        d_community=vec(d_community, 0.0),
        kappa_end_times=kappa_end_times, kappa_values=kappa_values,
        E0_multiplier=E0_multiplier, P0_multiplier=P0_multiplier,
        A0_multiplier=A0_multiplier, I0_multiplier=I0_multiplier,
        H0_multiplier=H0_multiplier, ICU0_multiplier=ICU0_multiplier,
        R0_multiplier=R0_multiplier, D0_multiplier=D0_multiplier,
        runup_days=runup_days, seed_exposed=seed_exposed), device, dtype)


def piecewise_value(t: torch.Tensor, end_times: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant schedule lookup.

    ``values[i]`` applies on ``(end_times[i-1], end_times[i]]``, the first
    value extending to ``-inf`` and the last to ``+inf`` (reference
    ``PiecewiseConstantParameterStrategy.cpp:37``,
    ``PieceWiseConstantNPIStrategy.cpp:86``). ``t`` is a scalar or a ``(T,)``
    grid, ``values`` is ``(..., K)``; the result is ``(...)`` or ``(..., T)``.
    A one-hot select-and-sum, so the value is copied exactly.
    """
    K = values.shape[-1]
    if K == 0:
        raise ValueError("piecewise_value requires a non-empty schedule")
    if t.dim() > 1:
        raise ValueError("t must be a scalar or a 1-D grid")
    # select the FIRST k with end_times[k] >= t; all-smaller falls to K-1
    ge = end_times >= t[..., None]                          # t.shape + (K,)
    onehot = ge & (torch.cumsum(ge.to(torch.int32), dim=-1) == 1)
    onehot[..., K - 1] |= ~ge.any(dim=-1)
    vals = values.unsqueeze(-2) if t.dim() == 1 else values
    return torch.where(onehot, vals, torch.zeros((), dtype=values.dtype,
                                                 device=values.device)).sum(-1)


def beta_at(params: SEPAIHRDParams, t: torch.Tensor) -> torch.Tensor:
    """beta(t); falls back to the scalar ``beta`` when no schedule is set
    (reference ``AgeSEPAIHRDModel::computeBeta``)."""
    if params.beta_values.shape[-1] == 0:
        return params.beta.unsqueeze(-1) if t.dim() == 1 else params.beta
    return piecewise_value(t, params.beta_end_times, params.beta_values)


def kappa_at(params: SEPAIHRDParams, t: torch.Tensor) -> torch.Tensor:
    """NPI contact-reduction factor kappa(t); 1 when no schedule is set
    (reference ``PiecewiseConstantNpiStrategy::getReductionFactor``)."""
    if params.kappa_values.shape[-1] == 0:
        return torch.ones_like(t, dtype=params.dtype)
    return piecewise_value(t, params.kappa_end_times, params.kappa_values)
