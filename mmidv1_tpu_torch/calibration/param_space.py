"""Calibratable-parameter space: name -> parameter-field mapping + constraints.

Port of ``mmidv1_tpu/calibration/param_space.py`` (:62-233), re-design of
``SEPAIHRDParameterManager`` (reference:
``src/model/parameters/SEPAIHRDParameterManager.cpp``). The mapping is resolved
once into index tables; :meth:`ParameterSpace.apply` turns a ``(..., d)``
theta batch into batched parameters. Name grammar (reference :91-158 /
:197-267):

- scalars: ``beta``, ``theta``, ``sigma``, ``gamma_*``, ``*0_multiplier``,
  ``seed_exposed``, ``runup_days``
- age-indexed: ``a_i``, ``h_infec_i``, ``p_i``, ``h_i``, ``icu_i``, ``d_H_i``,
  ``d_ICU_i``, ``d_community_i``
- schedule-indexed (1-based): ``beta_i`` -> ``beta_values[i-1]``,
  ``kappa_i`` -> ``kappa_values[i-1]`` (``kappa_1`` is the fixed NPI baseline
  and is rejected)

Constraint modes (reference ``applyConstraints``, :302-347):
- CLAMP (optimization): clip into [lo, hi]
- REFLECT (MCMC): reflect off the bounds, preserving detailed balance
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..params import SEPAIHRDParams
from ..utils.device import resolve_device
from ..utils.exceptions import InvalidParameterException

CLAMP = "clamp"
REFLECT = "reflect"

_SCALAR_NAMES = {
    "beta": "beta", "theta": "theta", "sigma": "sigma",
    "gamma_p": "gamma_p", "gamma_A": "gamma_A", "gamma_I": "gamma_I",
    "gamma_H": "gamma_H", "gamma_ICU": "gamma_ICU",
    "E0_multiplier": "E0_multiplier", "P0_multiplier": "P0_multiplier",
    "A0_multiplier": "A0_multiplier", "I0_multiplier": "I0_multiplier",
    "H0_multiplier": "H0_multiplier", "ICU0_multiplier": "ICU0_multiplier",
    "R0_multiplier": "R0_multiplier", "D0_multiplier": "D0_multiplier",
    "seed_exposed": "seed_exposed", "runup_days": "runup_days",
}

# Longest-prefix-first, mirroring the reference's dispatch order which checks
# e.g. h_infec_ before h_ (SEPAIHRDParameterManager.cpp:125-139).
_VECTOR_PREFIXES = [
    ("h_infec_", "h_infec"),
    ("d_community_", "d_community"),
    ("d_ICU_", "d_ICU"),
    ("d_H_", "d_H"),
    ("icu_", "icu"),
    ("a_", "a"),
    ("p_", "p"),
    ("h_", "h"),
]


def _resolve(name: str, n_ages: int, n_beta: int, n_kappa: int) -> Tuple[str, int]:
    """Return (field, index) for a calibratable name; index -1 for scalars."""
    if name in _SCALAR_NAMES:
        return _SCALAR_NAMES[name], -1
    if name.startswith("beta_"):
        try:
            idx = int(name[5:]) - 1
        except ValueError:
            raise InvalidParameterException("ParameterSpace",
                                            f"Could not parse index from: {name}")
        if not (0 <= idx < n_beta):
            raise InvalidParameterException("ParameterSpace",
                                            f"beta index out of range: {name}")
        return "beta_values", idx
    if name.startswith("kappa_"):
        try:
            idx = int(name[6:]) - 1
        except ValueError:
            raise InvalidParameterException("ParameterSpace",
                                            f"Could not parse index from: {name}")
        if idx == 0:
            raise InvalidParameterException(
                "ParameterSpace",
                f"'{name}' refers to the fixed baseline kappa and cannot be "
                "calibrated")
        if not (0 <= idx < n_kappa):
            raise InvalidParameterException("ParameterSpace",
                                            f"kappa index out of range: {name}")
        return "kappa_values", idx
    for prefix, field in _VECTOR_PREFIXES:
        if name.startswith(prefix):
            try:
                idx = int(name[len(prefix):])
            except ValueError:
                raise InvalidParameterException(
                    "ParameterSpace", f"Could not parse age index from: {name}")
            if not (0 <= idx < n_ages):
                raise InvalidParameterException(
                    "ParameterSpace", f"Invalid age index for parameter {name}")
            return field, idx
    raise InvalidParameterException("ParameterSpace", f"Unknown parameter name: {name}")


@dataclasses.dataclass(frozen=True)
class ParameterSpace:
    """Static description of the calibration space over :class:`SEPAIHRDParams`.

    ``lower``/``upper``/``sigmas`` are ``(d,)`` tensors on the space's device
    and in its dtype."""

    names: Tuple[str, ...]
    lower: torch.Tensor
    upper: torch.Tensor
    sigmas: torch.Tensor
    # field -> (positions_in_field, positions_in_theta); scalars use position -1
    _scatter: Dict[str, Tuple[List[int], List[int]]] = dataclasses.field(
        repr=False, default=None)

    @property
    def dim(self) -> int:
        return len(self.names)

    @property
    def dtype(self) -> torch.dtype:
        return self.lower.dtype

    @property
    def device(self) -> torch.device:
        return self.lower.device

    @classmethod
    def create(cls, names: Sequence[str], bounds: Dict[str, Tuple[float, float]],
               sigmas: Dict[str, float], template: SEPAIHRDParams, *,
               dtype: torch.dtype = torch.float64,
               device="cuda") -> "ParameterSpace":
        """Validated construction (reference ctor semantics: every name must
        have bounds and a proposal sigma, :47-53)."""
        for name in names:
            if name not in sigmas:
                raise InvalidParameterException(
                    "ParameterSpace", f"Missing proposal sigma for parameter: {name}")
            if name not in bounds:
                raise InvalidParameterException(
                    "ParameterSpace", f"Missing bounds for parameter: {name}")
        return space_from_numpy(
            names, [bounds[n][0] for n in names], [bounds[n][1] for n in names],
            [sigmas[n] for n in names], template, dtype=dtype, device=device)

    # --- pure functions on (..., d) batches --------------------------------

    def apply(self, base: SEPAIHRDParams, theta: torch.Tensor) -> SEPAIHRDParams:
        """Scatter a ``(..., d)`` theta batch into fresh parameters whose
        calibrated fields carry the batch dimensions. Values are copied
        exactly (index scatter, no arithmetic)."""
        batch = theta.shape[:-1]
        updates = {}
        for field, fidx, tidx in self.scatter_table():
            cur = getattr(base, field)
            if fidx is None:  # scalar field: exactly one theta entry
                updates[field] = theta[..., tidx].to(cur.dtype)
            else:
                new = cur.expand(batch + cur.shape[-1:]).clone()
                new[..., fidx] = theta[..., tidx].to(cur.dtype)
                updates[field] = new
        return base.replace(**updates)

    def scatter_table(self) -> Tuple:
        """:meth:`apply`'s positions, a ``(field, field positions, theta
        positions)`` per field: a scalar field's are ``None`` and one int,
        a vector field's two lists."""
        return tuple((field, None, tidx[0]) if fidx[0] == -1
                     else (field, fidx, tidx)
                     for field, (fidx, tidx) in self._scatter.items())

    def extract(self, params: SEPAIHRDParams) -> torch.Tensor:
        """Gather the current theta ``(..., d)`` from parameters (reference
        ``getCurrentParameters``)."""
        cols: List[torch.Tensor] = [None] * self.dim
        for field, (fidx, tidx) in self._scatter.items():
            cur = getattr(params, field)
            if fidx[0] == -1:
                cols[tidx[0]] = cur
            else:
                for fi, ti in zip(fidx, tidx):
                    cols[ti] = cur[..., fi]
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)

    def clamp(self, theta: torch.Tensor) -> torch.Tensor:
        """OPTIMIZATION_CLAMP constraint mode, written as ``jnp.clip`` is
        (``minimum(maximum(theta, lower), upper)``) so that a coordinate
        exactly on a bound gets half the gradient, as under ``jax.grad``;
        ``torch.clamp`` would pass all of it."""
        return torch.minimum(torch.maximum(theta, self.lower), self.upper)

    def reflect_widths(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(w, degenerate)`` of :meth:`reflect`: each coordinate's width
        between its bounds, 1 where that width is not positive, and where
        it is not."""
        width = self.upper - self.lower
        degenerate = width <= 0
        return torch.where(degenerate, torch.ones_like(width), width), degenerate

    def reflect(self, theta: torch.Tensor) -> torch.Tensor:
        """MCMC_REFLECT constraint mode: reflect off bounds (reference
        ``reflectBound``, :302-313), preserving detailed balance."""
        lo, hi = self.lower, self.upper
        w, degenerate = self.reflect_widths()
        # torch.remainder takes the sign of the divisor, as jnp.mod does
        y = torch.remainder(theta - lo, 2.0 * w)
        y = torch.where(y < 0, y + 2.0 * w, y)
        refl = torch.where(y <= w, lo + y, hi - (y - w))
        return torch.where(degenerate, lo, refl)

    def constrain(self, theta: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == CLAMP:
            return self.clamp(theta)
        if mode == REFLECT:
            return self.reflect(theta)
        raise ValueError(f"unknown constraint mode {mode!r}")

    def in_bounds(self, theta: torch.Tensor) -> torch.Tensor:
        return torch.all((theta >= self.lower) & (theta <= self.upper), dim=-1)


def space_from_numpy(names: Sequence[str], lower, upper, sigmas,
                     base: SEPAIHRDParams, *, dtype: torch.dtype = torch.float64,
                     device="cuda") -> ParameterSpace:
    """Build a :class:`ParameterSpace` from per-name arrays; ``base`` fixes
    the age count and schedule lengths the names resolve against. This is how
    a space crosses over from the JAX package:
    ``space_from_numpy(s.names, s.lower, s.upper, s.sigmas, params)``."""
    names = tuple(names)
    if not names:
        raise InvalidParameterException("ParameterSpace",
                                        "Parameter names list cannot be empty.")
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise InvalidParameterException(
            "ParameterSpace",
            f"Duplicate parameter names: {dupes} (aliased theta entries "
            "would silently shadow each other)")
    n_ages = base.n_ages
    n_beta = int(base.beta_values.shape[-1])
    n_kappa = int(base.kappa_values.shape[-1])
    scatter: Dict[str, Tuple[List[int], List[int]]] = {}
    for ti, name in enumerate(names):
        field, idx = _resolve(name, n_ages, n_beta, n_kappa)
        fi, tis = scatter.setdefault(field, ([], []))
        fi.append(idx)
        tis.append(ti)
    lo = np.asarray(lower, dtype=np.float64)
    hi = np.asarray(upper, dtype=np.float64)
    sg = np.asarray(sigmas, dtype=np.float64)
    if not (lo.shape == hi.shape == sg.shape == (len(names),)):
        raise ValueError("lower, upper and sigmas must each have one entry per name")
    # swap inverted bounds like the reference (:330)
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(x).to(device=dev, dtype=dtype)
    return ParameterSpace(names=names, lower=t(lo), upper=t(hi), sigmas=t(sg),
                          _scatter=scatter)
