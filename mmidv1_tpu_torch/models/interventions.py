"""Scheduled interventions: time-ordered parameter changes + split simulation.

Port of ``mmidv1_tpu/models/interventions.py``, re-design of
``InterventionCallback`` (reference:
``src/sir_age_structured/InterventionCallback.cpp:10-135``) and of the
split-simulation intervention demo in the age-SIR main
(``src/sir_age_structured/main.cpp:102-167``).

An intervention schedule splits the output grid into segments (on the host,
by ``bisect_left``); each segment integrates with its own transformed
parameters, and segments chain on the exact boundary states.
"""

from __future__ import annotations

import bisect
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.exceptions import InterventionException
from .sir import AgeSIRParams, apply_age_sir_intervention, solve_age_sir


class Intervention(NamedTuple):
    """One scheduled intervention (time, name, value)."""

    time: float
    name: str
    value: float


def validate_schedule(schedule: Sequence[Intervention]) -> List[Intervention]:
    """Sort by time; reject non-finite times (reference
    ``scheduleIntervention`` validation, :28-52)."""
    items = [Intervention(float(t), str(n), float(v)) for t, n, v in schedule]
    for it in items:
        if not np.isfinite(it.time):
            raise InterventionException("validate_schedule",
                                        f"Non-finite intervention time: {it}")
    return sorted(items, key=lambda it: it.time)


def solve_age_sir_scheduled(
    params: AgeSIRParams,
    y0: torch.Tensor,
    ts: Sequence[float],
    schedule: Sequence[Intervention],
    *,
    method: str = "fixed",
    substeps: int = 4,
    tableau: str = "dopri5",
    strict: bool = False,
) -> Tuple[torch.Tensor, AgeSIRParams]:
    """Integrate the age-SIR system applying scheduled interventions.

    Interventions take effect at the first output point >= their scheduled
    time (``applyScheduledInterventions`` :77-128); those at or before the
    first output time apply up front. Invalid interventions are skipped
    with the reference's swallow-and-log semantics unless ``strict=True``.
    Returns ``(trajectory, final_params)``; the trajectory covers the full
    ``ts`` grid with exact state continuity at boundaries.
    """
    ts = np.asarray(ts, dtype=np.float64)
    schedule = validate_schedule(schedule)

    # segment boundaries: output-grid indices where interventions fire
    boundaries: List[Tuple[int, List[Intervention]]] = []
    for it in schedule:
        idx = bisect.bisect_left(ts, it.time)
        if idx <= 0 or idx >= len(ts):
            continue        # before start (applies up front) / after end
        if boundaries and boundaries[-1][0] == idx:
            boundaries[-1][1].append(it)
        else:
            boundaries.append((idx, [it]))
    upfront = [it for it in schedule if bisect.bisect_left(ts, it.time) <= 0]

    p = params
    for it in upfront:
        p = _apply(p, it, strict)

    segments = []
    y = y0
    start = 0
    for idx, items in boundaries + [(len(ts) - 1, [])]:
        seg_ts = ts[start:idx + 1]
        if len(seg_ts) >= 2:
            traj = solve_age_sir(p, y, seg_ts, method=method,
                                 substeps=substeps, tableau=tableau)
            y = traj[-1]
            segments.append(traj if start == 0 else traj[1:])
        elif start == 0:
            segments.append(y[None])
        for it in items:
            p = _apply(p, it, strict)
        start = idx
    return torch.cat(segments, dim=0), p


def _apply(p: AgeSIRParams, it: Intervention, strict: bool) -> AgeSIRParams:
    try:
        return apply_age_sir_intervention(p, it.name, it.value)
    except InterventionException:
        if strict:
            raise
        # swallow-and-continue, mirroring InterventionCallback.cpp:103-120
        return p
