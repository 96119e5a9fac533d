"""Explicit RK integration over an output grid: fixed-grid and adaptive.

Port of ``mmidv1_tpu/ode/integrate.py``. Python loops take the place of
``lax.scan`` and ``lax.while_loop``; the state ``y`` is any tensor (batch
dimensions included), and the stage coefficients are Python floats, so they
take the state's dtype.

- :func:`integrate_times_fixed` stacks the trajectory ``(len(ts), *y.shape)``.
- :func:`fold_times_fixed` applies a user reduction at every output point
  instead (the Poisson objective's path).
- :func:`integrate_times` / :func:`fold_times` step adaptively with odeint's
  ``integrate_times`` semantics (exact landing on every output time, max-norm
  error control, the controller's dt memory kept across output points). By
  default one controller serves the whole state, as the JAX function does
  for one trajectory; ``batch_dims=k`` gives each of the leading ``k``
  dimensions its own ``t``, ``dt``, step count and accept mask, which equals
  ``jax.vmap`` of the JAX function lane by lane.

The RHS signature is ``f(t, y) -> dy``. With ``interval_ctx`` (a sequence of
length ``len(ts) - 1``) it is ``f(t, y, ctx_k)`` inside interval k: this is how
piecewise-constant schedule values are frozen per daily interval.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .tableaus import Tableau, get_tableau

MAX_STEPS_PER_INTERVAL = 10_000


def _bind(f: Callable, ctx):
    return f if ctx is None else (lambda t, y: f(t, y, ctx))


class _Coefs:
    """A tableau's nonzero ``dt * a[i, j]`` and ``dt * b[i]`` for one step
    size, as 0-dim tensors in the state's dtype on its device, made once
    per solve: each stage update is then one multiply and one add, with the
    same values as a Python-float coefficient (rounded to the dtype), and no
    scalar conversion at every use."""

    def __init__(self, tab: Tableau, dt: float, like: torch.Tensor):
        t = lambda c: torch.tensor(dt * c, dtype=like.dtype, device=like.device)
        self.stages, self.fsal, self.c = tab.stages, tab.fsal, tab.c
        self.a = [[(j, t(float(tab.a[i, j]))) for j in range(i)
                   if float(tab.a[i, j]) != 0.0] for i in range(tab.stages)]
        self.b = [(i, t(float(tab.b[i]))) for i in range(tab.stages)
                  if float(tab.b[i]) != 0.0]


def _coefs(cache, tab: Tableau, dt: float, like: torch.Tensor) -> _Coefs:
    if cache is None:
        return _Coefs(tab, dt, like)
    if dt not in cache:
        cache[dt] = _Coefs(tab, dt, like)
    return cache[dt]


def _stages(f: Callable, t: float, y, dt: float, co: _Coefs, k_first=None):
    """The stage derivatives of one step (``k_first`` reuses an FSAL stage)."""
    ks = [f(t, y) if k_first is None else k_first]
    for i in range(1, co.stages):
        yi = y
        for j, aij in co.a[i]:
            yi = yi + aij * ks[j]
        ks.append(f(t + float(co.c[i]) * dt, yi))
    return ks


def _combine(y, ks, co: _Coefs):
    y_new = y
    for i, bi in co.b:
        y_new = y_new + bi * ks[i]
    return y_new


def _advance_interval_fixed(f, t0: float, t1: float, y, substeps: int,
                            tab: Tableau, cache=None):
    """``substeps`` equal RK steps from t0 to t1 (``cache`` keeps the
    coefficients across calls). FSAL tableaus chain the last
    stage across substeps (the RHS changes only at interval boundaries, so
    the chain is exact within an interval)."""
    h = (t1 - t0) / substeps
    co = _coefs(cache, tab, h, y)
    k = None
    for s in range(substeps):
        ks = _stages(f, t0 + s * h, y, h, co, k)
        y = _combine(y, ks, co)
        k = ks[-1] if co.fsal else None
    return y


def _advance_interval_fixed_comp(f, t0: float, t1: float, y, c, substeps: int,
                                 tab: Tableau, cache=None):
    """Kahan-compensated fixed advance: carries a compensation tensor ``c``
    beside ``y`` so the state accumulation over thousands of substeps keeps
    the per-step increment's precision (see the JAX module for the why)."""
    h = (t1 - t0) / substeps
    co = _coefs(cache, tab, h, y)
    for s in range(substeps):
        ks = _stages(f, t0 + s * h, y, h, co)
        inc = _combine(torch.zeros_like(y), ks, co)
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
    cache = {}
    for k in range(len(ts) - 1):
        ctx = None if interval_ctx is None else interval_ctx[k]
        y = _advance_interval_fixed(_bind(f, ctx), float(ts[k]),
                                    float(ts[k + 1]), y, substeps, tab, cache)
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
    cache = {}
    for k in range(len(ts) - 1):
        ctx = None if interval_ctx is None else interval_ctx[k]
        fk = _bind(f, ctx)
        if compensated:
            y, c = _advance_interval_fixed_comp(fk, float(ts[k]),
                                                float(ts[k + 1]), pre(y),
                                                pre(c), substeps, tab, cache)
        else:
            y = _advance_interval_fixed(fk, float(ts[k]), float(ts[k + 1]),
                                        pre(y), substeps, tab, cache)
        acc = fold(acc, k + 1, y)
    return acc, y


# ---------------------------------------------------------------------------
# Adaptive stepping (JAX :81-175, :365-393)
# ---------------------------------------------------------------------------

def rk_step(f: Callable, t, y, dt, tab: Tableau):
    """One explicit RK step with a tensor step size ``dt`` (0-dim, or the
    shape of ``y``'s leading batch dimensions, one step a lane). Returns
    ``(y_new, err)``, ``err`` the embedded error estimate (zeros without
    one)."""
    dtb = dt.reshape(dt.shape + (1,) * (y.dim() - dt.dim()))
    ks = []
    for i in range(tab.stages):
        yi = y
        for j in range(i):
            aij = float(tab.a[i, j])
            if aij != 0.0:
                yi = yi + (dtb * aij) * ks[j]
        ks.append(f(t + float(tab.c[i]) * dt, yi))
    y_new = y
    for i in range(tab.stages):
        bi = float(tab.b[i])
        if bi != 0.0:
            y_new = y_new + (dtb * bi) * ks[i]
    err = torch.zeros_like(y_new)
    if tab.b_err is not None:
        for i in range(tab.stages):
            bei = float(tab.b_err[i])
            if bei != 0.0:
                err = err + (dtb * bei) * ks[i]
    return y_new, err


def _error_norm(err, y_old, atol, rtol, batch_dims: int):
    """Boost.Odeint ``default_error_checker`` with a_x=1, a_dxdt=0: the
    max-norm of ``|err_i| / (atol + rtol * |y_i|)`` over each lane."""
    scale = atol + rtol * torch.abs(y_old)
    return torch.amax(torch.abs(err) / scale,
                      dim=tuple(range(batch_dims, err.dim())))


def _advance_interval_adaptive(f, t0, t1, y, dt, atol, rtol, tab: Tableau,
                               max_steps: int, batch_dims: int, stats):
    """Adaptively integrate from ``t0`` to ``t1`` (0-dim tensors), landing
    exactly on ``t1``; returns ``(y(t1), dt)``.

    Each attempt is clamped to the rest of the interval. A lane that has
    landed (or spent ``max_steps`` attempts) keeps its ``t``, ``dt``, ``y``
    and step count, as a lane of JAX's batched ``while_loop`` keeps its
    carry, so an attempt changes nothing on a finished lane. Deciding
    whether any lane is still active is one host read an attempt."""
    inv_dec = -1.0 / (tab.error_order - 1)
    inv_inc = -1.0 / tab.order
    lanes = y.shape[:batch_dims]
    per_lane = lambda m: m.reshape(m.shape + (1,) * (y.dim() - batch_dims))
    edge = t1 - 1e-12 * torch.clamp_min(torch.abs(t1), 1.0)
    t = t0.expand(lanes)
    n = torch.zeros(lanes, dtype=torch.int64, device=y.device)
    while True:
        active = (t < edge) & (n < max_steps)
        if not bool(active.any()):
            break
        if stats is not None:
            stats["attempts"] = stats.get("attempts", 0) + 1
        dt_try = torch.minimum(dt, t1 - t)
        y_new, err = rk_step(f, t, y, dt_try, tab)
        err_norm = _error_norm(err, y, atol, rtol, batch_dims)
        # a NaN/Inf state is rejected with the largest shrink
        err_norm = torch.where(torch.isfinite(err_norm), err_norm, 1e10)
        accept = err_norm <= 1.0
        # boost default_step_adjuster: reject dt *= max(0.9 err^(-1/(eo-1)),
        # 0.2); accept with err < 0.5 dt *= 0.9 max(err, 5^-order)^(-1/order)
        dt_dec = dt_try * torch.clamp_min(0.9 * err_norm ** inv_dec, 0.2)
        err_floored = torch.clamp_min(err_norm, 5.0 ** (-float(tab.order)))
        dt_inc = torch.where(err_norm < 0.5,
                             dt_try * 0.9 * err_floored ** inv_inc, dt_try)
        # on accept the controller keeps its dt memory over a landing step
        # clamped to the output point (integrate_times: dt = max(dt, dt_new))
        t_next = torch.where(accept, t + dt_try, t)
        y_next = torch.where(per_lane(accept), y_new, y)
        dt_next = torch.where(accept, torch.maximum(dt, dt_inc), dt_dec)
        t = torch.where(active, t_next, t)
        y = torch.where(per_lane(active), y_next, y)
        dt = torch.where(active, dt_next, dt)
        n = n + active.to(n.dtype)
    # max_steps spent without landing (boost throws): poison the lane with
    # NaN so that a likelihood sees an explicit failure
    landed = t >= edge
    y = torch.where(per_lane(landed), y, torch.full_like(y, float("nan")))
    return y, dt


def _adaptive_setup(method, y0, ts, dt0, atol, rtol, batch_dims):
    tab = get_tableau(method)
    if tab.b_err is None:
        raise ValueError(
            f"tableau '{method if isinstance(method, str) else tab.name}' has "
            "no embedded error estimate; the adaptive controller would accept "
            "every step and grow dt unboundedly — use it on the fixed-grid "
            "path instead")
    # t, dt and the tolerances in the state's dtype, as the JAX integrators
    # keep them: a float64 t would land a float32 run elsewhere
    like = lambda v: torch.as_tensor(v, dtype=y0.dtype, device=y0.device)
    ts = like(_grid(ts))
    dt = torch.broadcast_to(like(dt0), y0.shape[:batch_dims])
    return tab, ts, dt, like(atol), like(rtol)


def integrate_times(f, y0, ts, *, dt0=1.0, atol=1e-6, rtol=1e-6,
                    method="dopri5", max_steps=MAX_STEPS_PER_INTERVAL,
                    interval_ctx=None, batch_dims=0, stats=None):
    """Adaptive integration with output at every element of ``ts``; returns
    ``(len(ts), *y0.shape)`` with ``out[0] == y0``. ``batch_dims`` leading
    dimensions of ``y0`` get a controller each; ``stats`` (a dict), when
    given, counts the controller's ``attempts``."""
    tab, ts, dt, atol, rtol = _adaptive_setup(method, y0, ts, dt0, atol, rtol,
                                              batch_dims)
    out = [y0]
    y = y0
    for k in range(len(ts) - 1):
        ctx = None if interval_ctx is None else interval_ctx[k]
        y, dt = _advance_interval_adaptive(_bind(f, ctx), ts[k], ts[k + 1], y,
                                           dt, atol, rtol, tab, max_steps,
                                           batch_dims, stats)
        out.append(y)
    return torch.stack(out)


def fold_times(f, y0, ts, fold, init, *, dt0=1.0, atol=1e-6, rtol=1e-6,
               method="dopri5", max_steps=MAX_STEPS_PER_INTERVAL,
               interval_ctx=None, batch_dims=0, stats=None):
    """Adaptive-stepping variant of :func:`fold_times_fixed`; returns
    ``(acc, y_final)``."""
    tab, ts, dt, atol, rtol = _adaptive_setup(method, y0, ts, dt0, atol, rtol,
                                              batch_dims)
    acc = fold(init, 0, y0)
    y = y0
    for k in range(len(ts) - 1):
        ctx = None if interval_ctx is None else interval_ctx[k]
        y, dt = _advance_interval_adaptive(_bind(f, ctx), ts[k], ts[k + 1], y,
                                           dt, atol, rtol, tab, max_steps,
                                           batch_dims, stats)
        acc = fold(acc, k + 1, y)
    return acc, y
