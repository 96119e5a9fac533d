"""Fixed-grid explicit RK integration over an output grid.

Port of the fixed-grid half of ``mmidv1_tpu/ode/integrate.py`` (:177-362);
the adaptive drivers are not ported yet. Python loops take the place of
``lax.scan``; the state ``y`` is any tensor (batch dimensions included), and
the stage coefficients are Python floats, so they take the state's dtype.

- :func:`integrate_times_fixed` stacks the trajectory ``(len(ts), *y.shape)``.
- :func:`fold_times_fixed` applies a user reduction at every output point
  instead (the Poisson objective's path).

The RHS signature is ``f(t, y) -> dy``. With ``interval_ctx`` (a sequence of
length ``len(ts) - 1``) it is ``f(t, y, ctx_k)`` inside interval k: this is how
piecewise-constant schedule values are frozen per daily interval.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .tableaus import Tableau, get_tableau


def _bind(f: Callable, ctx):
    return f if ctx is None else (lambda t, y: f(t, y, ctx))


def _stages(f: Callable, t: float, y, dt: float, tab: Tableau, k_first=None):
    """The stage derivatives of one step (``k_first`` reuses an FSAL stage)."""
    ks = [f(t, y) if k_first is None else k_first]
    for i in range(1, tab.stages):
        yi = y
        for j in range(i):
            aij = float(tab.a[i, j])
            if aij != 0.0:
                yi = yi + (dt * aij) * ks[j]
        ks.append(f(t + float(tab.c[i]) * dt, yi))
    return ks


def _combine(y, ks, dt: float, tab: Tableau):
    y_new = y
    for i in range(tab.stages):
        bi = float(tab.b[i])
        if bi != 0.0:
            y_new = y_new + (dt * bi) * ks[i]
    return y_new


def _advance_interval_fixed(f, t0: float, t1: float, y, substeps: int,
                            tab: Tableau):
    """``substeps`` equal RK steps from t0 to t1. FSAL tableaus chain the last
    stage across substeps (the RHS changes only at interval boundaries, so
    the chain is exact within an interval)."""
    h = (t1 - t0) / substeps
    k = None
    for s in range(substeps):
        ks = _stages(f, t0 + s * h, y, h, tab, k)
        y = _combine(y, ks, h, tab)
        k = ks[-1] if tab.fsal else None
    return y


def _advance_interval_fixed_comp(f, t0: float, t1: float, y, c, substeps: int,
                                 tab: Tableau):
    """Kahan-compensated fixed advance: carries a compensation tensor ``c``
    beside ``y`` so the state accumulation over thousands of substeps keeps
    the per-step increment's precision (see the JAX module for the why)."""
    h = (t1 - t0) / substeps
    for s in range(substeps):
        ks = _stages(f, t0 + s * h, y, h, tab)
        inc = _combine(torch.zeros_like(y), ks, h, tab)
        t = inc - c
        y_new = y + t
        c = (y_new - y) - t
        y = y_new
    return y, c


def _grid(ts) -> np.ndarray:
    ts = np.asarray(ts.detach().cpu() if isinstance(ts, torch.Tensor) else ts,
                    dtype=np.float64)
    if ts.ndim != 1 or ts.size < 1:
        raise ValueError("ts must be a non-empty 1-D grid")
    return ts


def integrate_times_fixed(f, y0, ts, *, substeps=4, method="dopri5",
                          interval_ctx=None):
    """Fixed-grid integration: ``substeps`` equal RK steps per output
    interval. ``out[0] == y0``."""
    tab = get_tableau(method)
    ts = _grid(ts)
    out = [y0]
    y = y0
    for k in range(len(ts) - 1):
        ctx = None if interval_ctx is None else interval_ctx[k]
        y = _advance_interval_fixed(_bind(f, ctx), float(ts[k]),
                                    float(ts[k + 1]), y, substeps, tab)
        out.append(y)
    return torch.stack(out)


def fold_times_fixed(f, y0, ts, fold, init, *, substeps=4, method="dopri5",
                     interval_ctx=None, compensated=False, pre_interval=None):
    """Like :func:`integrate_times_fixed` but folds instead of stacking.

    ``fold(acc, i, y_i) -> acc`` is called for every output index i
    (including 0 with ``y0``). Returns ``(acc, y_final)``.

    ``pre_interval(y) -> y`` is applied to the carried state at the START of
    every output interval (a linear projection, e.g. zeroing the
    pure-accumulator rows); in the compensated path the same projection is
    applied to the compensation tensor. ``compensated=True`` carries a Kahan
    compensation across the whole grid (non-FSAL stepping).
    """
    tab = get_tableau(method)
    ts = _grid(ts)
    pre = (lambda y: y) if pre_interval is None else pre_interval
    acc = fold(init, 0, y0)
    y = y0
    c = torch.zeros_like(y0) if compensated else None
    for k in range(len(ts) - 1):
        ctx = None if interval_ctx is None else interval_ctx[k]
        fk = _bind(f, ctx)
        if compensated:
            y, c = _advance_interval_fixed_comp(fk, float(ts[k]),
                                                float(ts[k + 1]), pre(y),
                                                pre(c), substeps, tab)
        else:
            y = _advance_interval_fixed(fk, float(ts[k]), float(ts[k + 1]),
                                        pre(y), substeps, tab)
        acc = fold(acc, k + 1, y)
    return acc, y
