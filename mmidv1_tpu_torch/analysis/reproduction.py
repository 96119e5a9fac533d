"""Next-generation-matrix reproduction numbers (R0, Rt), batched.

Port of ``mmidv1_tpu/analysis/reproduction.py`` (:43-157), re-design of
``ReproductionNumberCalculator`` (reference:
``src/model/ReproductionNumberCalculator.cpp:19-170``). The reference takes
the spectral radius of the full (4A x 4A) F V^{-1}; F has nonzero entries only
in the E-block rows and V is block-triangular per age, so the nonzero
eigenvalues of F V^{-1} are those of the A x A reduced matrix

    K[i, j] = T[i, j] * D[j]
    T[i, j] = beta(t) * kappa(t) * M_baseline[i, j] * a[i] * h_infec[j] * w[i] / N[j]
    D[j]    = 1/gamma_p + p[j]/gamma_A + theta * (1 - p[j]) / (gamma_I + h[j])

with w = N (R0) or w = S(t) (Rt). Its spectral radius comes from power
iteration (Perron-Frobenius). Where the JAX package vmaps one matrix at a
time, every function here takes batched parameters (scalars ``(B,)``, age
vectors ``(B, A)``) and builds ``(..., B, A, A)`` matrices at once: Rt over a
``(T, B, 11, A)`` trajectory is one power iteration over ``(T, B)`` NGMs.

Products and sums are written elementwise, never as a matmul, so a float32
run on the card cannot fall into TF32 (the JAX code asks XLA for
``Precision.HIGHEST`` for the same reason).

Fidelity notes (mirroring the reference exactly):
- M_baseline is used UNSCALED (the reference ignores
  ``contact_matrix_scaling_factor`` here).
- V's I-outflow is ``gamma_I + h`` only — the reference omits ``d_community``
  from the NGM (``:134-137`` vs ``AgeSEPAIHRDModel.cpp:210``). Pass
  ``include_d_community=True`` for the corrected variant.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..params import SEPAIHRDParams, beta_at, kappa_at


def _col(x: torch.Tensor) -> torch.Tensor:
    """A per-draw scalar ``(...)`` as ``(..., 1)`` against the age axis."""
    return x.unsqueeze(-1)


def _t(params: SEPAIHRDParams, t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=params.dtype, device=params.device)


def infection_duration_weights(params: SEPAIHRDParams,
                               include_d_community: bool = False) -> torch.Tensor:
    """D[j]: expected transmission-weighted residence across P, A, I,
    ``(..., A)``."""
    i_out = _col(params.gamma_I) + params.h
    if include_d_community:
        i_out = i_out + params.d_community
    return (1.0 / _col(params.gamma_p)
            + params.p / _col(params.gamma_A)
            + _col(params.theta) * (1.0 - params.p) / i_out)


def _ngm(params: SEPAIHRDParams, w: torch.Tensor, b: torch.Tensor,
         include_d_community: bool) -> torch.Tensor:
    """K for weights ``w (..., A)`` and schedule factor ``b`` broadcastable
    to ``w``'s leading shape."""
    # empty age bands contribute NOTHING (reference zero-pop `continue`)
    inv_n = torch.where(params.N > 1e-9, 1.0 / params.N,
                        torch.zeros_like(params.N))
    T = (b[..., None, None] * params.a[..., :, None] * params.M_baseline
         * params.h_infec[..., None, :] * w[..., :, None]
         * inv_n[..., None, :])
    T = torch.maximum(T, T.new_zeros(()))
    D = infection_duration_weights(params, include_d_community)
    return T * D[..., None, :]


def reduced_ngm(params: SEPAIHRDParams, w: torch.Tensor, t,
                include_d_community: bool = False) -> torch.Tensor:
    """The A x A reduced next-generation matrix K at one time ``t`` (w = N
    for R0, S(t) for Rt), ``(..., A, A)``."""
    t = _t(params, t)
    b = beta_at(params, t) * kappa_at(params, t)
    return _ngm(params, w, b, include_d_community)


def spectral_radius(K: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Spectral radius of non-negative ``(..., A, A)`` matrices by power
    iteration, over any leading dimensions; ``(...)``."""
    A = K.shape[-1]
    v = torch.full(K.shape[:-1], 1.0 / math.sqrt(A), dtype=K.dtype,
                   device=K.device)

    def matvec(v):
        return torch.sum(K * v.unsqueeze(-2), dim=-1)

    for _ in range(iters):
        w = matvec(v)
        n = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        v = torch.where(n > 0, w / n, v)
    lam = torch.sum(v * matvec(v), dim=-1)
    return torch.maximum(lam, lam.new_zeros(()))


def calculate_r0(params: SEPAIHRDParams,
                 include_d_community: bool = False) -> torch.Tensor:
    """R0 = spectral radius of the NGM at t=0 with the full population
    (reference ``calculateR0``, :141-157); ``(...)`` over the parameters'
    batch."""
    K = reduced_ngm(params, params.N, 0.0, include_d_community)
    return spectral_radius(K)


def calculate_rt(params: SEPAIHRDParams, S_current: torch.Tensor, t,
                 include_d_community: bool = False) -> torch.Tensor:
    """Rt at time t given the current susceptible vector ``(..., A)``
    (reference ``calculateRt``, :160-170)."""
    K = reduced_ngm(params, S_current, t, include_d_community)
    return spectral_radius(K)


def rt_trajectory(params: SEPAIHRDParams, traj: torch.Tensor, ts,
                  include_d_community: bool = False) -> torch.Tensor:
    """Rt at every output point of a ``(T, ..., 11, A)`` trajectory, ``(T,
    ...)``: one power iteration over all T x batch matrices (reference
    ``MetricsCalculator::calculateRtTrajectory``, ``:174-198``)."""
    ts = torch.as_tensor(ts, dtype=traj.dtype, device=traj.device)
    S_t = traj[..., 0, :]                               # (T, ..., A)
    b = (beta_at(params, ts) * kappa_at(params, ts)).movedim(-1, 0)   # (T, ...)
    return spectral_radius(_ngm(params, S_t, b, include_d_community))


def full_ngm_matrices(params: SEPAIHRDParams, w, t, include_d_community=False):
    """The reference's literal (4A x 4A) F and V of unbatched parameters
    (for parity testing only)."""
    p = {k: getattr(params, k).detach().cpu().numpy() for k in
         ("N", "M_baseline", "a", "h_infec", "theta", "sigma", "gamma_p",
          "gamma_A", "gamma_I", "p", "h", "d_community")}
    A = p["N"].size
    n = 4 * A
    tt = _t(params, t)
    b = float(beta_at(params, tt)) * float(kappa_at(params, tt))
    F = np.zeros((n, n))
    w = np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w)
    for i in range(A):
        for j in range(A):
            if p["N"][j] < 1e-9:
                continue
            term = b * p["M_baseline"][i, j] * p["a"][i] * p["h_infec"][j] * \
                w[i] / p["N"][j]
            term = max(term, 0.0)
            F[i, A + j] = term
            F[i, 2 * A + j] = term
            F[i, 3 * A + j] = p["theta"] * term
    V = np.zeros((n, n))
    for age in range(A):
        e, pp, aa, ii = age, A + age, 2 * A + age, 3 * A + age
        V[e, e] = p["sigma"]
        V[pp, e] = -p["sigma"]
        V[pp, pp] = p["gamma_p"]
        V[aa, pp] = -p["p"][age] * p["gamma_p"]
        V[ii, pp] = -(1.0 - p["p"][age]) * p["gamma_p"]
        V[aa, aa] = p["gamma_A"]
        V[ii, ii] = p["gamma_I"] + p["h"][age] + \
            (p["d_community"][age] if include_d_community else 0.0)
    return F, V
