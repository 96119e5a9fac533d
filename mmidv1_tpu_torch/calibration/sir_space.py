"""Calibratable-parameter space for the age-structured SIR model.

Port of ``mmidv1_tpu/calibration/sir_space.py``, re-design of
``SIRParameterManager`` (reference:
``src/sir_age_structured/parameters/SIRParameterManager.cpp:6-96``): name
grammar ``q`` / ``scale_C_total`` / ``gamma_<age>`` with the reference's
default proposal sigmas. ``apply``, ``extract`` and the constraint modes
(clamp / reflect) are inherited from :class:`ParameterSpace`: they touch
only the index tables and the bounds, and work on any parameters with
``replace``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.sir import AgeSIRParams
from ..utils.device import resolve_device
from ..utils.exceptions import InvalidParameterException
from .param_space import ParameterSpace

DEFAULT_SIGMAS = {"q": 0.05, "scale_C_total": 0.05, "gamma": 0.01}


@dataclasses.dataclass(frozen=True)
class SIRParameterSpace(ParameterSpace):
    """Maps (q, scale_C_total, gamma_i) names onto AgeSIRParams fields."""

    @classmethod
    def create(cls, names: Sequence[str],
               bounds: Dict[str, Tuple[float, float]],
               sigmas: Optional[Dict[str, float]],
               template: AgeSIRParams, *,
               dtype: torch.dtype = torch.float64,
               device="cuda") -> "SIRParameterSpace":
        if not names:
            raise InvalidParameterException("SIRParameterSpace",
                                            "Parameter names list cannot be empty.")
        if len(set(names)) != len(names):
            raise InvalidParameterException("SIRParameterSpace",
                                            "Duplicate parameter names.")
        sigmas = dict(sigmas or {})
        n_ages = template.n_ages
        scatter: Dict[str, Tuple[List[int], List[int]]] = {}
        for ti, name in enumerate(names):
            if name == "q":
                field, idx = "q", -1
                sigmas.setdefault(name, DEFAULT_SIGMAS["q"])
            elif name == "scale_C_total":
                field, idx = "scale_C", -1
                sigmas.setdefault(name, DEFAULT_SIGMAS["scale_C_total"])
            elif name.startswith("gamma_"):
                try:
                    idx = int(name[6:])
                except ValueError:
                    raise InvalidParameterException(
                        "SIRParameterSpace",
                        f"Could not parse age index from parameter name '{name}'")
                if not (0 <= idx < n_ages):
                    raise InvalidParameterException(
                        "SIRParameterSpace",
                        f"Invalid age index in parameter name '{name}'. "
                        f"Max index: {n_ages - 1}")
                field = "gamma"
                sigmas.setdefault(name, DEFAULT_SIGMAS["gamma"])
            else:
                raise InvalidParameterException(
                    "SIRParameterSpace",
                    f"Parameter name '{name}' not recognized for AgeSIRModel "
                    "calibration.")
            if name not in bounds:
                raise InvalidParameterException(
                    "SIRParameterSpace", f"Missing bounds for parameter: {name}")
            fi, tis = scatter.setdefault(field, ([], []))
            fi.append(idx)
            tis.append(ti)

        lo = np.asarray([bounds[n][0] for n in names], dtype=np.float64)
        hi = np.asarray([bounds[n][1] for n in names], dtype=np.float64)
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)   # swap inverted bounds
        sg = np.asarray([sigmas[n] for n in names], dtype=np.float64)
        dev = resolve_device(device)
        t = lambda x: torch.as_tensor(x).to(device=dev, dtype=dtype)
        return cls(names=tuple(names), lower=t(lo), upper=t(hi), sigmas=t(sg),
                   _scatter=scatter)
