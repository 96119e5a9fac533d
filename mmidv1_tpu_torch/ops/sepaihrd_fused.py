"""K1: the fused SEPAIHRD objective (fixed-grid RK solve + Poisson fold).

Port of ``mmidv1_tpu/ops/sepaihrd_pallas.py`` (``period_runs_for_grid``,
``shared_prep``, ``fused_objective``, ``build_objective_pallas``). The kernel
is hand-written CUDA C++ for Hopper, ``csrc/sepaihrd_fused.cu`` (its header
says what bounds it and how it is laid out), built by :mod:`._build` and
called through ctypes.

Layout (chains last, so neighbouring threads read neighbouring addresses):

  y0      (11, 4, B)  initial states, compartment-major
  agevec  (8, 4, B)   a, h_infec/N, p, h, icu, d_H, d_ICU, d_community
  scal    (7, B)      theta, sigma, gamma_p, gamma_A, gamma_I, gamma_H, gamma_ICU
  beff    (n_runs, B) beta*kappa*scaling per static schedule run
  obs     (T_obs, 3, 4) observations (deaths, hosp, icu), 0 where invalid
  valid   (T_obs, 3, 4) 1.0 where an observation is finite and >= 0

:func:`fused_objective` dispatches on the device of its inputs alone: CPU
tensors go to :func:`fused_objective_reference` (the plain PyTorch version),
CUDA tensors to the kernel. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..calibration.objective import base_state, check_grid, lowest
from ..calibration.param_space import REFLECT, ParameterSpace
from ..data.calibration_data import CalibrationData
from ..models import sepaihrd
from ..ode.integrate import _advance_interval_fixed
from ..ode.tableaus import get_tableau
from ..params import SEPAIHRDParams
from ..utils.device import resolve_device

N_AGES = 4
_DAY_ROWS = [7, 8, 9]                 # the same rows in the R-dropped state
_CARRIED = [0, 1, 2, 3, 4, 5, 6, 8, 9, 10]


def period_runs_for_grid(ts, beta_end_times, kappa_end_times):
    """Static per-interval schedule runs: consecutive daily intervals sharing
    the same (beta period, kappa period), evaluated at interval midpoints
    (matching ``interval_beta_eff``). Returns a tuple of
    ``(beta_row, kappa_row, start_interval, count)``."""
    ts = np.asarray(ts, dtype=np.float64)
    mids = 0.5 * (ts[:-1] + ts[1:])
    bet = np.asarray(beta_end_times, dtype=np.float64)
    ket = np.asarray(kappa_end_times, dtype=np.float64)

    def idx(end_times, n_values):
        if n_values == 0:
            return np.zeros(len(mids), dtype=int)
        i = np.searchsorted(end_times, mids, side="left")
        return np.clip(i, 0, n_values - 1)

    pb = idx(bet, len(bet))
    pk = idx(ket, len(ket))
    runs = []
    start = 0
    for t in range(1, len(mids) + 1):
        if t == len(mids) or pb[t] != pb[start] or pk[t] != pk[start]:
            runs.append((int(pb[start]), int(pk[start]), start, t - start))
            start = t
    return tuple(runs)


def _check_inputs(y0, agevec, scal, beff, obs, valid, M, run_start, run_count,
                  runup_offset, substeps):
    tensors = dict(y0=y0, agevec=agevec, scal=scal, beff=beff, obs=obs,
                   valid=valid)
    dev, dtype = y0.device, y0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_objective takes float32 or float64, got {dtype}")
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every input "
                             f"must be {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B = y0.shape[-1]
    n_runs = len(run_start)
    T_obs = obs.shape[0]
    want = dict(y0=(C.NUM_COMPARTMENTS, N_AGES, B), agevec=(8, N_AGES, B),
                scal=(7, B), beff=(n_runs, B), obs=(T_obs, 3, N_AGES),
                valid=(T_obs, 3, N_AGES))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if B < 1 or T_obs < 1:
        raise ValueError("need at least one chain and one observation row")
    if np.shape(M) != (N_AGES, N_AGES):
        raise ValueError(f"M has shape {np.shape(M)}, expected (4, 4)")
    if len(run_count) != n_runs or n_runs < 1:
        raise ValueError("run_start and run_count must be equal, non-empty")
    ends = np.cumsum(run_count)
    if run_start[0] != 0 or any(s != e for s, e in zip(run_start[1:], ends[:-1])) \
            or any(c < 1 for c in run_count):
        raise ValueError("schedule runs must tile the intervals from 0 in order")
    n_intervals = int(ends[-1])
    if n_intervals + 1 - runup_offset != T_obs or not 0 <= runup_offset <= n_intervals:
        raise ValueError(f"{n_intervals} intervals with runup_offset "
                         f"{runup_offset} do not end on observation row {T_obs - 1}")
    if int(substeps) < 1:
        raise ValueError("substeps must be >= 1")
    return B, n_runs, T_obs


def fused_objective(y0: torch.Tensor, agevec: torch.Tensor, scal: torch.Tensor,
                    beff: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
                    M, *, run_start: Sequence[int], run_count: Sequence[int],
                    runup_offset: int, substeps: int = 4,
                    tableau: str = "dopri5") -> torch.Tensor:
    """Log-likelihood per chain, ``(B,)``, of the fused solve + fold.

    ``M`` is the host (4, 4) baseline contact matrix; ``run_start`` /
    ``run_count`` tile the daily intervals into static schedule runs (row r
    of ``beff`` applies to run r). CPU inputs run the plain version; CUDA
    inputs launch the kernel on the current stream, or raise."""
    B, n_runs, T_obs = _check_inputs(y0, agevec, scal, beff, obs, valid, M,
                                     run_start, run_count, runup_offset, substeps)
    if y0.device.type == "cpu":
        return fused_objective_reference(
            y0, agevec, scal, beff, obs, valid, M, run_start=run_start,
            run_count=run_count, runup_offset=runup_offset, substeps=substeps,
            tableau=tableau)
    if y0.device.type != "cuda":
        raise ValueError(f"unsupported device {y0.device}")

    from . import _build

    lib = _build.load("sepaihrd_fused")
    tab = get_tableau(tableau)
    S = tab.stages
    h = 1.0 / substeps
    a = (ctypes.c_double * (S * S))(*[float(h * x) for x in tab.a.reshape(-1)])
    b = (ctypes.c_double * S)(*[float(h * x) for x in tab.b])
    m = (ctypes.c_double * 16)(*[float(x) for x in np.asarray(M).reshape(-1)])
    rs = (ctypes.c_int * n_runs)(*[int(x) for x in run_start])
    rc = (ctypes.c_int * n_runs)(*[int(x) for x in run_count])
    out = torch.empty(B, dtype=y0.dtype, device=y0.device)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        fn = lib.sepaihrd_fused_f32 if y0.dtype == torch.float32 \
            else lib.sepaihrd_fused_f64
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
        err = fn(y0.data_ptr(), agevec.data_ptr(), scal.data_ptr(),
                 beff.data_ptr(), obs.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), B, T_obs, int(runup_offset), int(substeps), S,
                 int(tab.fsal), a, b, m, n_runs, rs, rc, stream)
    if err != 0:
        lib.sepaihrd_fused_error_string.restype = ctypes.c_char_p
        lib.sepaihrd_fused_error_string.argtypes = [ctypes.c_int]
        msg = lib.sepaihrd_fused_error_string(err).decode()
        raise RuntimeError(f"sepaihrd_fused kernel launch failed: {msg} ({err})")
    fused_objective.launches += 1
    return out


fused_objective.launches = 0


def fused_objective_reference(y0, agevec, scal, beff, obs, valid, M, *,
                              run_start, run_count, runup_offset: int,
                              substeps: int = 4,
                              tableau: str = "dopri5") -> torch.Tensor:
    """The plain PyTorch version of the kernel: same inputs, same function,
    one eager op at a time (chains last, R dropped as in the kernel)."""
    dtype, dev = y0.dtype, y0.device
    tab = get_tableau(tableau)
    Mt = torch.as_tensor(np.asarray(M, dtype=np.float64), dtype=dtype, device=dev)
    a_, hinfN, p, hh, icu, dH, dICU, dcomm = agevec.unbind(0)     # (4, B) each
    theta, sigma, gp, gA, gI, gH, gICU = scal.unsqueeze(1).unbind(0)  # (1, B)
    eps = C.POISSON_EPSILON

    def rhs(y, beta):
        S_, E_, P_, A_, I_, H_, ICU_ = y[:7].unbind(0)
        ip = (P_ + A_ + theta * I_) * hinfN
        lam = torch.sum(Mt[:, :, None] * ip[None, :, :], dim=1)
        lam = torch.clamp_min(beta * (a_ * lam), 0.0)
        fSE = lam * S_
        fEP = sigma * E_
        fPo = gp * P_
        fPA = p * fPo
        fPI = fPo - fPA
        fIH = hh * I_
        fIR = gI * I_
        fIDc = dcomm * I_
        fHICU = icu * H_
        dHrow = dH * H_
        dICUrow = dICU * ICU_
        return torch.stack([
            -fSE, fSE - fEP, fEP - fPo, fPA - gA * A_,
            fPI - (fIR + fIH + fIDc), fIH - (gH * H_ + dHrow + fHICU),
            fHICU - (gICU * ICU_ + dICUrow), dHrow + dICUrow + fIDc,
            fIH, fHICU])

    def poisson_row(j, incs):
        return torch.sum(obs[j][..., None] * torch.log(incs)
                         - valid[j][..., None] * incs, dim=(0, 1))

    B = y0.shape[-1]
    y = y0[_CARRIED]
    ll = torch.zeros(B, dtype=dtype, device=dev)
    comp = torch.zeros(B, dtype=dtype, device=dev)
    if runup_offset == 0:
        ll = ll + poisson_row(0, torch.full((3, N_AGES, B), eps, dtype=dtype,
                                            device=dev))
    T_obs = obs.shape[0]
    for r, (start, count) in enumerate(zip(run_start, run_count)):
        beta = beff[r]
        f = lambda t, yy, beta=beta: rhs(yy, beta)
        for t in range(start, start + count):
            y = y.clone()
            y[_DAY_ROWS] = 0.0
            y = _advance_interval_fixed(f, 0.0, 1.0, y, substeps, tab)
            j = t + 1 - runup_offset
            if 0 <= j < T_obs:
                term = poisson_row(j, torch.clamp_min(y[_DAY_ROWS], 0.0) + eps)
                contrib = term - comp
                ll_new = ll + contrib
                comp = (ll_new - ll) - contrib
                ll = ll_new
    return ll


def op_count(tableau: str, substeps: int, n_intervals: int, n_obs_days: int) -> int:
    """Floating-point operations per chain the kernel's arithmetic implies
    (from its source: 41 per RHS per age lane, 20 per non-zero stage or
    update coefficient per lane, 18 per observed day per lane), for the
    roofline bound."""
    tab = get_tableau(tableau)
    S = tab.stages
    nnz = int(np.count_nonzero(np.tril(tab.a, -1))) + int(np.count_nonzero(tab.b))
    rhs_per_interval = 1 + substeps * (S - 1) if tab.fsal else substeps * S
    per_lane = (n_intervals * (41 * rhs_per_interval + 20 * nnz * substeps)
                + 18 * n_obs_days)
    return N_AGES * per_lane


class FusedPrep:
    """The host constants and the theta -> kernel-input prep shared by the
    fused objective (port of ``shared_prep``)."""

    def __init__(self, space: ParameterSpace, base_params: SEPAIHRDParams,
                 data: CalibrationData, ts, *, base_initial_state=None,
                 constraint_mode: str = REFLECT, dtype: torch.dtype,
                 device: torch.device):
        ts, self.runup_offset, self.num_obs = check_grid(ts, data)
        if not np.all(np.diff(ts) == 1.0):
            raise ValueError("the fused objective integrates daily intervals: "
                             "ts must be unit-spaced")
        self.space, self.mode, self.dtype, self.device = (space, constraint_mode,
                                                          dtype, device)
        self.base = base_params.to(device, dtype)
        self.base_y0 = torch.as_tensor(
            base_state(base_params, data, base_initial_state),
            dtype=dtype, device=device)
        runs = period_runs_for_grid(ts, base_params.beta_end_times.cpu().numpy(),
                                    base_params.kappa_end_times.cpu().numpy())
        self.pb = [r[0] for r in runs]
        self.pk = [r[1] for r in runs]
        self.run_start = tuple(r[2] for r in runs)
        self.run_count = tuple(r[3] for r in runs)
        # streams in kernel order: deaths, hosp, icu (state rows D, CumH, CumICU)
        o = np.stack([np.asarray(data.new_deaths, dtype=np.float64),
                      np.asarray(data.new_hospitalizations, dtype=np.float64),
                      np.asarray(data.new_icu, dtype=np.float64)], axis=1)
        v = (np.isfinite(o) & (o >= 0)).astype(np.float64)
        self.obs = torch.as_tensor(np.where(v > 0, o, 0.0) * v, dtype=dtype,
                                   device=device)
        self.valid = torch.as_tensor(v, dtype=dtype, device=device)
        self.M = base_params.M_baseline.cpu().numpy().astype(np.float64)
        N = base_params.N.cpu().numpy().astype(np.float64)
        self.invN = torch.as_tensor(
            np.where(N > C.MIN_POPULATION_FOR_DIVISION, 1.0 / N, 0.0),
            dtype=dtype, device=device)

    def kernel_args(self, thetas: torch.Tensor):
        """``(args, kwargs, infeasible)`` of :func:`fused_objective` for a
        ``(B, d)`` theta batch."""
        theta = self.space.constrain(thetas.to(self.dtype), self.mode)
        B = theta.shape[0]
        prm = self.space.apply(self.base, theta)
        y0, infeasible = sepaihrd.initial_state_for_params(prm, self.base_y0)
        y0 = y0.expand(B, C.NUM_COMPARTMENTS, N_AGES).permute(1, 2, 0).contiguous()
        vecs = [prm.a, prm.h_infec * self.invN, prm.p, prm.h, prm.icu, prm.d_H,
                prm.d_ICU, prm.d_community]
        agevec = torch.stack([v.expand(B, N_AGES) for v in vecs]) \
            .permute(0, 2, 1).contiguous()
        scal = torch.stack([s.expand(B) for s in (
            prm.theta, prm.sigma, prm.gamma_p, prm.gamma_A, prm.gamma_I,
            prm.gamma_H, prm.gamma_ICU)]).contiguous()
        if prm.beta_values.shape[-1]:
            bsrc = prm.beta_values
        else:
            bsrc = prm.beta.unsqueeze(-1)
        bsrc = bsrc * prm.contact_matrix_scaling_factor.unsqueeze(-1)
        if prm.kappa_values.shape[-1]:
            ksrc = prm.kappa_values
        else:
            ksrc = torch.ones(1, dtype=self.dtype, device=self.device)
        beff = torch.stack([(bsrc[..., i] * ksrc[..., k]).expand(B)
                            for i, k in zip(self.pb, self.pk)]).contiguous()
        return ((y0, agevec, scal, beff, self.obs, self.valid, self.M),
                dict(run_start=self.run_start, run_count=self.run_count,
                     runup_offset=self.runup_offset), infeasible.expand(B))


def build_objective_fused(space: ParameterSpace, base_params: SEPAIHRDParams,
                          data: CalibrationData, ts, *, base_initial_state=None,
                          substeps: int = 4, tableau: str = "dopri5",
                          constraint_mode: str = REFLECT,
                          dtype: Optional[torch.dtype] = None,
                          device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched objective ``loglik_batch(thetas (B, d)) -> (B,)`` backed by the
    fused kernel (counterpart of ``build_objective_pallas``). Constrain,
    apply, initial state and the per-run beta stay in PyTorch; the solve and
    fold run in one launch. Infeasible, NaN or Inf results become
    ``finfo(dtype).min``. ``dtype``/``device`` default to the base
    parameters'."""
    dtype = dtype or base_params.dtype
    dev = resolve_device(device or base_params.device)
    prep = FusedPrep(space, base_params, data, ts,
                     base_initial_state=base_initial_state,
                     constraint_mode=constraint_mode, dtype=dtype, device=dev)

    def loglik_batch(thetas: torch.Tensor) -> torch.Tensor:
        args, kw, infeasible = prep.kernel_args(thetas)
        ll = fused_objective(*args, **kw, substeps=substeps, tableau=tableau)
        bad = infeasible | torch.isnan(ll) | torch.isinf(ll)
        return torch.where(bad, torch.full_like(ll, lowest(dtype)), ll)

    loglik_batch.prep = prep
    return loglik_batch
