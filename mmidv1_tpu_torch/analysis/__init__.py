"""Post-calibration analysis layer (port of ``mmidv1_tpu/analysis``).

A batched posterior replay on the card: NGM R0/Rt, EssentialMetrics, PPC
quantile bands, ENE-COVID validation, scenario analysis, and the
reference-shaped CSV output tree.
"""

from . import aggregate, diagnostics, writers
from .metrics import essential_metrics, seroprevalence_trajectory
from .report import generate_full_report
from .reproduction import (calculate_r0, calculate_rt, reduced_ngm,
                           rt_trajectory, spectral_radius)

__all__ = [
    "aggregate",
    "diagnostics",
    "writers",
    "essential_metrics",
    "seroprevalence_trajectory",
    "generate_full_report",
    "calculate_r0",
    "calculate_rt",
    "reduced_ngm",
    "rt_trajectory",
    "spectral_radius",
]
