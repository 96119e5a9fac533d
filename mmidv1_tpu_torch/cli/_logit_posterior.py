"""The log posterior in power-logit coordinates, its mass recipes, and its
exact Hessian: the pieces that ``nuts_campaign``, ``make_capped_mass``,
``curvature_probe``, ``energy_error_probe`` and ``serovalid_pipeline``
share.

``theta = lo + width * sigmoid(k y)^(1/k)`` maps R^d onto the box; the
log-Jacobian ``log width + log_sigmoid(k y) / k + log_sigmoid(-k y)`` joins
the log-likelihood, so the theta-marginal law is the bounded posterior
(the JAX tools define this inline: ``scripts/make_capped_mass.py:101``,
``scripts/curvature_probe.py:78``, ``scripts/energy_error_probe.py:111``).

:func:`exact_hessian` differentiates a batched objective twice by reverse
mode: the point is copied once per coordinate, one backward with
``create_graph=True`` gives every copy its gradient, and a second backward
of ``sum_i grad_i[i]`` gives row ``i`` of the Hessian in copy ``i`` (the
copies are independent rows of the batch). It is the exact curvature of the
eager float64 solve, not a finite difference of it.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

Y_STD_FLOOR = 0.25     # scripts/nuts_campaign.py:377


def power_for(flat: np.ndarray, lo: np.ndarray, hi: np.ndarray,
              power: str) -> np.ndarray:
    """The power-logit exponent per parameter: ``'auto'`` gives k = 8 where
    the trace's 0.995 quantile stays below 0.8 of the box and k = 1
    elsewhere; a number gives that k everywhere."""
    if power == "auto":
        u_hi = np.quantile((flat - lo) / (hi - lo), 0.995, axis=0)
        return np.where(u_hi < 0.8, 8.0, 1.0)
    return np.full(flat.shape[-1], float(power))


def shrink(cov: np.ndarray) -> np.ndarray:
    """10 % diagonal shrinkage (keeps the factor positive definite when the
    trace is short)."""
    return 0.9 * cov + 0.1 * np.diag(np.maximum(np.diag(cov), 1e-24))


def floor_std(cov: np.ndarray, floor: float = Y_STD_FLOOR) -> np.ndarray:
    """Raise every marginal std below ``floor`` to it: a wall-pinned column
    is near constant in y, and its empirical width is an artefact of the
    transform's clip."""
    return cov + np.diag(np.maximum(floor ** 2 - np.diag(cov), 0.0))


def logit_mass(y_draws: np.ndarray, floor: float = Y_STD_FLOOR):
    """``(mu, cov)`` of a y-space dense mass from logit-space draws."""
    return y_draws.mean(axis=0), floor_std(shrink(np.cov(y_draws,
                                                        rowvar=False)), floor)


def make_logp_y(loglik_batch: Callable, lower: torch.Tensor,
                upper: torch.Tensor, power) -> Callable:
    """``logp_y(ys (B, d)) -> (B,)``: the log-likelihood at ``theta(y)`` plus
    the log-Jacobian of the power-logit map."""
    lo = lower
    w = torch.clamp(upper - lower, min=1e-30)
    k = torch.as_tensor(power, dtype=lo.dtype, device=lo.device)
    log_w = torch.log(w)

    def logp_y(ys):
        ls = F.logsigmoid(k * ys)
        u = torch.exp(ls / k)
        jac = torch.sum(log_w + ls / k + F.logsigmoid(-k * ys), dim=-1)
        return loglik_batch(lo + w * u) + jac

    return logp_y


def exact_hessian(f_batch: Callable, x: torch.Tensor):
    """``(value, grad, H)`` of ``f`` at the point ``x (d,)``, where
    ``f_batch(xs (B, d)) -> (B,)`` treats rows independently. Reverse over
    reverse on ``d`` copies of ``x``: exact up to the solve's own
    rounding."""
    d = x.shape[-1]
    with torch.enable_grad():
        xs = x.detach().expand(d, d).clone().requires_grad_(True)
        v = f_batch(xs)
        (g,) = torch.autograd.grad(v.sum(), xs, create_graph=True)
        (H,) = torch.autograd.grad(torch.diagonal(g).sum(), xs)
    return v[0].detach(), g[0].detach(), H


def laplace_cov(lap) -> np.ndarray:
    """The full covariance of a Laplace npz (``map_polish``,
    ``serovalid_pipeline``): ``diag(std^2)`` with the free block replaced
    by ``cov_free``."""
    std = np.maximum(lap["std"].astype(np.float64), 1e-12)
    cov = np.diag(std ** 2)
    free = lap["free"]
    cov[np.ix_(free, free)] = lap["cov_free"]
    return cov


class LogitObjective:
    """The float64 eager objective (REFLECT) of a tool's ``args``
    (``device``, ``num_days``, ``substeps``, ``tableau``) and its box;
    :meth:`hessians` gives the logit posterior's exact Hessians."""

    def __init__(self, args):
        from ..calibration.objective import build_objective
        from ..calibration.param_space import REFLECT
        from ..utils.device import resolve_device
        from .common import REPO_ROOT, load_spain_pipeline

        self.dev = resolve_device(args.device)
        pipe = load_spain_pipeline(REPO_ROOT, dtype=torch.float64,
                                   device=self.dev, num_days=args.num_days)
        self.space = pipe.space
        self.names = list(pipe.space.names)
        self.lo = pipe.space.lower.cpu().numpy().astype(np.float64)
        self.hi = pipe.space.upper.cpu().numpy().astype(np.float64)
        self.loglik = build_objective(
            pipe.space, pipe.params, pipe.data, pipe.ts,
            substeps=args.substeps, tableau=args.tableau,
            constraint_mode=REFLECT, dtype=torch.float64, device=self.dev)

    def hessians(self, power, ys):
        """The symmetrised exact Hessians of the logit posterior with
        exponents ``power`` at each row of ``ys`` (NumPy), and the seconds
        each took."""
        logp_y = make_logp_y(self.loglik, self.space.lower, self.space.upper,
                             torch.as_tensor(power, dtype=torch.float64,
                                             device=self.dev))
        out, secs = [], []
        for y0 in ys:
            t0 = time.perf_counter()
            H = exact_hessian(logp_y, torch.as_tensor(y0, device=self.dev))[2]
            H = H.cpu().numpy()
            secs.append(time.perf_counter() - t0)
            out.append(0.5 * (H + H.T))
        return out, secs
