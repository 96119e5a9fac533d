"""K1: the fused SEPAIHRD objective (fixed-grid RK solve + Poisson fold).

Port of ``mmidv1_tpu/ops/sepaihrd_pallas.py`` (``period_runs_for_grid``,
``shared_prep``, ``fused_objective``, ``build_objective_pallas``). The kernel
is hand-written CUDA C++ for Hopper, ``csrc/sepaihrd_fused.cu`` over
``csrc/sepaihrd_forward.cuh`` (whose header says what bounds it and how its
two regimes are laid out), built by :mod:`._build` and called through ctypes.

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
On the card :func:`choose_forward_regime` picks the kernel's regime from the
chain count: the cascade split over producer and consumer warps for few
chains (:func:`plain_forward_split` is its plain model), one thread per
(chain, age) for many.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..calibration.objective import base_state, check_grid, lowest
from ..calibration.param_space import CLAMP, REFLECT, ParameterSpace
from ..data.calibration_data import CalibrationData
from ..models import sepaihrd
from ..ode.integrate import _advance_interval_fixed
from ..ode.tableaus import get_tableau
from ..params import SEPAIHRDParams
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.graphs import GraphCache
from ._build import SUFFIX, launch, tableau_id

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


def check_tensors(tensors: dict, what: str):
    """Every tensor of ``tensors`` (name -> tensor) float32 or float64, of
    one dtype, on one device and contiguous, as the kernels take them."""
    first = next(iter(tensors.values()))
    dev, dtype = first.device, first.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32 or float64, got {dtype}")
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every input "
                             f"must be {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_forward_inputs(y0, agevec, scal, beff, obs, valid, M, run_start,
                         run_count, runup_offset, substeps):
    """Check the inputs of K1 or K2 (:func:`fused_objective`): ``(B, n_runs,
    T_obs)``."""
    tensors = dict(y0=y0, agevec=agevec, scal=scal, beff=beff, obs=obs,
                   valid=valid)
    check_tensors(tensors, "fused_objective")
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
    check_schedule(M, run_start, run_count, runup_offset, substeps, T_obs)
    return B, n_runs, T_obs


def check_schedule(M, run_start, run_count, runup_offset, substeps, T_obs):
    """Validate the host constants the kernels take besides the tensors
    (once per distinct set: a sampler passes the same ones at every call)."""
    _check_schedule(np.shape(M), tuple(run_start), tuple(run_count),
                    int(runup_offset), int(substeps), int(T_obs))


@functools.lru_cache(maxsize=64)
def _check_schedule(M_shape, run_start, run_count, runup_offset, substeps,
                    T_obs):
    n_runs = len(run_start)
    if M_shape != (N_AGES, N_AGES):
        raise ValueError(f"M has shape {M_shape}, expected (4, 4)")
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
    if substeps < 1:
        raise ValueError("substeps must be >= 1")


SPLIT, WIDE = 1, 2      # the forward kernels' regimes (csrc/sepaihrd_forward.cuh)
# the split regime up to this many chains an SM (2 blocks of 8 chains)
SPLIT_CHAINS_PER_SM = 16
# The longest mean cycle of the recurrence's dependency graph, counted from
# the kernel source (the header of csrc/sepaihrd_forward.cuh writes it out):
# lam(i) -> kE(i) -> uE(i+1) -> kP(i+1) -> uP(i+2) -> lam(i+2), 17 arithmetic
# instructions and one shuffle round over two stages. Cycles from instruction
# latencies (4 a float32 and 8 a float64 arithmetic instruction, 24 a
# shuffle; from published tables, not measured).
CHAIN_INSTRUCTIONS = 17
CHAIN_STAGES = 2
_ARITH_CYCLES = {4: 4, 8: 8}
_SHUFFLE_CYCLES = 24


def chain_cycles(elem: int) -> float:
    """Cycles a dependent RK stage that the recurrence's longest dependency
    cycle takes at least, for values of ``elem`` bytes."""
    return (CHAIN_INSTRUCTIONS * _ARITH_CYCLES[elem]
            + _SHUFFLE_CYCLES) / CHAIN_STAGES


def stage_use(tableau: str):
    """Which stages of a substep the kernels touch under their zero rule
    (csrc/sepaihrd_common.cuh), as lists of bools by stage: ``feeds`` (a
    later stage input reads its derivative), ``live`` (feeds, or its ``b``
    is not 0: the adjoint transposes it) and ``evaluated`` (live, or carried
    by FSAL: the forward evaluates its RHS). A zero coefficient is skipped,
    so a stage that nothing reads is dead: fehlberg78's stage 10 in both
    directions, dopri5's last in the adjoint only."""
    tab = get_tableau(tableau)
    S = tab.stages
    feeds = [bool(np.any(tab.a[i + 1:, i] != 0.0)) for i in range(S)]
    live = [f or float(tab.b[i]) != 0.0 for i, f in enumerate(feeds)]
    evaluated = [x or (tab.fsal and i == S - 1) for i, x in enumerate(live)]
    return feeds, live, evaluated


def dependent_stages(tableau: str, substeps: int, n_intervals: int) -> int:
    """RHS evaluations of one chain, each of which needs the one before
    (FSAL carries the first stage of every substep of a day but the
    first)."""
    n = sum(stage_use(tableau)[2])
    per_day = 1 + substeps * (n - 1) if get_tableau(tableau).fsal else substeps * n
    return n_intervals * per_day


def choose_forward_regime(B: int, sm_count: int) -> int:
    """The regime of K1 and K2 for ``B`` chains on a card with ``sm_count``
    SMs.

    The split regime puts the infection subsystem of 8 chains on a warp of
    its own and the rest of the model on a second one: fewer instructions on
    the warp that sets the pace, at twice the warps. The wide regime runs
    one thread per (chain, age) with all ten rows. Few chains leave the card
    empty and only the time of one stage counts; many fill it and only the
    arithmetic does. The split regime's time is flat while every warp has a
    scheduler to itself (2 blocks an SM) and then steps up with the blocks
    an SM; the constant comes from ``chip_smoke.py``'s ``[crossover-fwd]``
    lines on an H100 with 132 SMs (PERF.md): in float32 and float64 alike
    the split regime wins by 17 to 20 % up to B = 2048 (2 blocks an SM) and
    loses at 3072 (3), so it is taken up to 2 blocks of 8 chains an SM,
    B <= 2112 there."""
    return SPLIT if B <= SPLIT_CHAINS_PER_SM * sm_count else WIDE


def check_regime(regime):
    if regime not in (None, SPLIT, WIDE):
        raise ValueError(f"regime must be None, {SPLIT} (split) or {WIDE} "
                         f"(wide), got {regime!r}")


_P, _I = ctypes.c_void_p, ctypes.c_int
# the forward kernels' C arguments before the stream, by checkpoint tensors:
# K1's (none), K2's (one, with its count)
_FORWARD_ARGS = {n: (_P,) * (7 + n) + (_I,) * 5 + (_P,) * 3 + (_I,)
                 + (_P,) * 2 + (_I,) * (1 + n) for n in (0, 1)}


def launch_forward(what: str, y0, agevec, scal, beff, obs, valid, M, *,
                   run_start, run_count, runup_offset, substeps, tableau,
                   ckpt=None, regime=None):
    """Launch K1 (``ckpt`` None) or K2 on checked CUDA inputs
    (:func:`check_forward_inputs`) and count the launch in the tracer's
    ``launches`` under ``("k1" or "k2", regime, tableau, chains)``: the
    log-likelihoods ``(B,)``. ``regime`` None lets
    :func:`choose_forward_regime` pick; ``what`` names the failing call."""
    dev, B = y0.device, y0.shape[-1]
    _S, _fsal, a, b, m, rs, rc = host_consts(tableau, substeps, M, run_start,
                                             run_count)
    if regime is None:
        regime = choose_forward_regime(
            B, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty(B, dtype=y0.dtype, device=dev)
    ck = () if ckpt is None else (ckpt,)
    name, stem = (("sepaihrd_adjoint", "sepaihrd_fwd_ckpt") if ck
                  else ("sepaihrd_fused", "sepaihrd_fused"))
    launch(what, dev, name, f"{stem}_{SUFFIX[y0.element_size()]}",
           _FORWARD_ARGS[len(ck)],
           *(t.data_ptr() for t in (y0, agevec, scal, beff, obs, valid, out)
             + ck), B, obs.shape[0], int(runup_offset), int(substeps),
           tableau_id(tableau), a, b, m, len(rs), rs, rc,
           *(c.shape[0] for c in ck), int(regime))
    trace.count("launches", ("k2" if ck else "k1", int(regime), tableau, B))
    return out


def fused_objective(y0: torch.Tensor, agevec: torch.Tensor, scal: torch.Tensor,
                    beff: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
                    M, *, run_start: Sequence[int], run_count: Sequence[int],
                    runup_offset: int, substeps: int = 4,
                    tableau: str = "dopri5",
                    regime: Optional[int] = None) -> torch.Tensor:
    """Log-likelihood per chain, ``(B,)``, of the fused solve + fold.

    ``M`` is the host (4, 4) baseline contact matrix; ``run_start`` /
    ``run_count`` tile the daily intervals into static schedule runs (row r
    of ``beff`` applies to run r). CPU inputs run the plain version; CUDA
    inputs launch the kernel on the current stream, or raise. ``regime``
    forces the kernel's split (1) or wide (2) regime past
    :func:`choose_forward_regime`, for tests and timing. The whole call is
    the tracer's span ``k1.launch`` (on the host: the plain version)."""
    with trace.span("k1.launch"):
        check_forward_inputs(y0, agevec, scal, beff, obs, valid, M,
                             run_start, run_count, runup_offset, substeps)
        check_regime(regime)
        kw = dict(run_start=run_start, run_count=run_count,
                  runup_offset=runup_offset, substeps=substeps, tableau=tableau)
        if y0.device.type == "cpu":
            return fused_objective_reference(y0, agevec, scal, beff, obs,
                                             valid, M, **kw)
        if y0.device.type != "cuda":
            raise ValueError(f"unsupported device {y0.device}")
        return launch_forward("fused_objective", y0, agevec, scal, beff,
                              obs, valid, M, **kw, regime=regime)


def host_consts(tableau: str, substeps: int, M, run_start, run_count):
    """The kernels' host-side constants as ctypes arrays: ``(stages, fsal,
    h*a (S*S), h*b (S), M (16), run_start, run_count)``, made once per
    distinct set and kept (the kernels only read them)."""
    return _host_consts(tableau, int(substeps),
                        np.asarray(M, dtype=np.float64).tobytes(),
                        tuple(run_start), tuple(run_count))


@functools.lru_cache(maxsize=64)
def _host_consts(tableau, substeps, M_bytes, run_start, run_count):
    tab = get_tableau(tableau)
    S, n_runs = tab.stages, len(run_start)
    h = 1.0 / substeps
    a = (ctypes.c_double * (S * S))(*[float(h * x) for x in tab.a.reshape(-1)])
    b = (ctypes.c_double * S)(*[float(h * x) for x in tab.b])
    m = (ctypes.c_double * 16).from_buffer_copy(M_bytes)
    rs = (ctypes.c_int * n_runs)(*[int(x) for x in run_start])
    rc = (ctypes.c_int * n_runs)(*[int(x) for x in run_count])
    return S, int(tab.fsal), a, b, m, rs, rc


def fused_objective_reference(y0, agevec, scal, beff, obs, valid, M, *,
                              run_start, run_count, runup_offset: int,
                              substeps: int = 4,
                              tableau: str = "dopri5") -> torch.Tensor:
    """The plain PyTorch version of the kernel: same inputs, same function,
    one eager op at a time (chains last, R dropped as in the kernel)."""
    ll, _ = plain_forward(y0, agevec, scal, beff, obs, valid, M,
                          run_start=run_start, run_count=run_count,
                          runup_offset=runup_offset, substeps=substeps,
                          tableau=tableau)
    return ll


def fused_objective_split_reference(y0, agevec, scal, beff, obs, valid, M, *,
                                    run_start, run_count, runup_offset: int,
                                    substeps: int = 4,
                                    tableau: str = "dopri5") -> torch.Tensor:
    """The plain model of the kernel's split regime
    (:func:`plain_forward_split`): equal to
    :func:`fused_objective_reference` bit for bit."""
    ll, _ = plain_forward_split(y0, agevec, scal, beff, obs, valid, M,
                                run_start=run_start, run_count=run_count,
                                runup_offset=runup_offset, substeps=substeps,
                                tableau=tableau)
    return ll


def plain_forward(y0, agevec, scal, beff, obs, valid, M, *, run_start,
                  run_count, runup_offset: int, substeps: int = 4,
                  tableau: str = "dopri5", chunk: int = 0,
                  incidence=sepaihrd.max0):
    """The forward solve + fold of K1 (and of K2) in eager PyTorch, for any
    autograd mode. Returns ``(ll (B,), ckpts)``: with ``chunk > 0`` ``ckpts``
    is the ``(n_chunks, 10, 4, B)`` stack of pre-reset day-start states at
    every ``t % chunk == 0``, else None. ``incidence(cv)`` is the clamp of
    a day's raw incidence before the ``+ 1e-10``; its forward value must be
    ``max(cv, 0)``, and its gradient is the caller's choice."""
    ll, _y, ckpts = plain_days(
        y0[_CARRIED], agevec, scal, beff, obs, valid, M, run_start=run_start,
        run_count=run_count, runup_offset=runup_offset, substeps=substeps,
        tableau=tableau, chunk=chunk, incidence=incidence)
    return ll, (torch.stack(ckpts) if chunk else None)


class _PlainModel:
    """The SEPAIHRD right-hand side on the R-dropped state in eager PyTorch,
    chains last, in the cascade's two halves as the kernels have it
    (``rhs_up`` / ``rhs_down`` in csrc/sepaihrd_common.cuh), and the Poisson
    row. ``rhs`` is both halves stacked."""

    def __init__(self, agevec, scal, obs, valid, M):
        self.Mt = torch.as_tensor(np.asarray(M, dtype=np.float64),
                                  dtype=agevec.dtype, device=agevec.device)
        self.agevec = agevec.unbind(0)                    # (4, B) each
        self.scal = scal.unsqueeze(1).unbind(0)           # (1, B) each
        self.obs, self.valid = obs, valid

    def up(self, u, beta):
        """d/dt of S E P A I from their own state ``u`` (5 rows)."""
        a_, hinfN, p, hh, _icu, _dH, _dICU, dcomm = self.agevec
        theta, sigma, gp, gA, gI, _gH, _gICU = self.scal
        S_, E_, P_, A_, I_ = u[0], u[1], u[2], u[3], u[4]
        ip = (P_ + A_ + theta * I_) * hinfN
        lam = torch.sum(self.Mt[:, :, None] * ip[None, :, :], dim=1)
        lam = sepaihrd.max0(beta * (a_ * lam))
        fSE = lam * S_
        fEP = sigma * E_
        fPo = gp * P_
        fPA = p * fPo
        fPI = fPo - fPA
        fIH = hh * I_
        fIR = gI * I_
        fIDc = dcomm * I_
        return [-fSE, fSE - fEP, fEP - fPo, fPA - gA * A_,
                fPI - (fIR + fIH + fIDc)]

    def down(self, I_, z):
        """d/dt of H ICU D CumH CumICU from I and their own state ``z``."""
        _a, _hinfN, _p, hh, icu, dH, dICU, dcomm = self.agevec
        gH, gICU = self.scal[5], self.scal[6]
        H_, ICU_ = z[0], z[1]
        fIH = hh * I_
        fIDc = dcomm * I_
        fHICU = icu * H_
        dHrow = dH * H_
        dICUrow = dICU * ICU_
        return [fIH - (gH * H_ + dHrow + fHICU),
                fHICU - (gICU * ICU_ + dICUrow), dHrow + dICUrow + fIDc,
                fIH, fHICU]

    def rhs(self, y, beta):
        return torch.stack(self.up(y, beta) + self.down(y[4], y[5:]))

    def poisson_row(self, j, incs):
        return torch.sum(self.obs[j][..., None] * torch.log(incs)
                         - self.valid[j][..., None] * incs, dim=(0, 1))

    def fold_start(self, B, row0: bool):
        """``(ll, comp)`` before the first day, with observation row 0's
        constant term (no run-up) when ``row0``."""
        dtype, dev = self.obs.dtype, self.obs.device
        ll = torch.zeros(B, dtype=dtype, device=dev)
        if row0:
            ll = ll + self.poisson_row(0, torch.full(
                (3, N_AGES, B), C.POISSON_EPSILON, dtype=dtype, device=dev))
        return ll, torch.zeros(B, dtype=dtype, device=dev)

    def fold_day(self, ll, comp, j, incs):
        """Kahan-add day row ``j``'s Poisson term at incidences ``incs``."""
        contrib = self.poisson_row(j, incs + C.POISSON_EPSILON) - comp
        ll_new = ll + contrib
        return ll_new, (ll_new - ll) - contrib


def plain_days(y, agevec, scal, beff, obs, valid, M, *, run_start, run_count,
               runup_offset: int, substeps: int = 4, tableau: str = "dopri5",
               chunk: int = 0, incidence=sepaihrd.max0, days=None):
    """The days ``[days[0], days[1])`` (default: all) of the plain forward,
    from the carried pre-reset state ``y (10, 4, B)`` at the start of day
    ``days[0]``: ``(ll (B,), y_end (10, 4, B), ckpts)``, where ``ll`` is the
    Kahan sum of these days' Poisson terms (plus observation row 0's
    constant term when day 0 is included and there is no run-up), ``y_end``
    the pre-reset state after the last day and ``ckpts`` the list of
    day-start states at every ``t % chunk == 0`` (empty for ``chunk == 0``)."""
    tab = get_tableau(tableau)
    model = _PlainModel(agevec, scal, obs, valid, M)
    first, last = days if days is not None else (0, int(sum(run_count)))
    ll, comp = model.fold_start(y.shape[-1],
                                  runup_offset == 0 and first == 0)
    T_obs = obs.shape[0]
    ckpts, cache = [], {}
    for r, (start, count) in enumerate(zip(run_start, run_count)):
        beta = beff[r]
        f = lambda t, yy, beta=beta: model.rhs(yy, beta)
        for t in range(max(start, first), min(start + count, last)):
            if chunk and t % chunk == 0:
                ckpts.append(y)
            y = y.clone()
            y[_DAY_ROWS] = 0.0
            y = _advance_interval_fixed(f, 0.0, 1.0, y, substeps, tab, cache)
            j = t + 1 - runup_offset
            if 0 <= j < T_obs:
                ll, comp = model.fold_day(ll, comp, j, incidence(y[_DAY_ROWS]))
    return ll, y, ckpts


def _rk_substep(stage, y, h: float, tab, k_first=None):
    """One RK step of size ``h`` with the operations of
    ``ode.integrate._stages`` and ``_combine`` in their order; ``stage(i,
    yi)`` gives the derivative at stage input ``yi``, and ``k_first`` takes
    the place of stage 0 (FSAL). Returns ``(y_new, last stage)``."""
    ks = [stage(0, y) if k_first is None else k_first]
    for i in range(1, tab.stages):
        yi = y
        for j in range(i):
            aij = float(tab.a[i, j])
            if aij != 0.0:
                yi = yi + (h * aij) * ks[j]
        ks.append(stage(i, yi))
    y_new = y
    for i in range(tab.stages):
        bi = float(tab.b[i])
        if bi != 0.0:
            y_new = y_new + (h * bi) * ks[i]
    return y_new, ks[-1]


def plain_forward_split(y0, agevec, scal, beff, obs, valid, M, *, run_start,
                        run_count, runup_offset: int, substeps: int = 4,
                        tableau: str = "dopri5", chunk: int = 0,
                        incidence=sepaihrd.max0):
    """A plain PyTorch model of the kernels' split regime: what
    :func:`plain_forward` returns, computed as the producer and consumer
    warps compute it.

    The model is a cascade: S E P A I are closed under the right-hand side,
    and H ICU D CumH CumICU are linear rows driven by I. So the upstream
    five rows are integrated alone over all days, recording for every stage
    of every substep the stage input of I (what the producer hands over);
    then the downstream five rows are integrated from the record with the
    same tableau (their own FSAL stage carried), reset each day, and folded.
    Each row sees the same operations in the same order as in
    :func:`plain_forward`, so the two agree bit for bit."""
    tab = get_tableau(tableau)
    model = _PlainModel(agevec, scal, obs, valid, M)
    y = y0[_CARRIED]
    h = 1.0 / substeps
    days = [(r, t) for r, (start, count) in enumerate(zip(run_start, run_count))
            for t in range(start, start + count)]

    def substeps_of_day(stage_of, y):
        """``substeps`` steps from ``y``; ``stage_of(sub)`` is the stage
        function of substep ``sub``."""
        k_last = None
        for sub in range(substeps):
            y, k_last = _rk_substep(stage_of(sub), y, h, tab,
                                    k_last if tab.fsal else None)
        return y

    # the producer: S E P A I alone, I's stage inputs recorded
    u, up_ckpts, record = y[:5], [], []
    for r, t in days:
        if chunk and t % chunk == 0:
            up_ckpts.append(u)
        day = [dict() for _ in range(substeps)]

        def stage_of(sub, beta=beff[r], day=day):
            def stage(i, ui):
                day[sub][i] = ui[4]
                return torch.stack(model.up(ui, beta))
            return stage

        u = substeps_of_day(stage_of, u)
        record.append(day)

    # the consumer: the linear rows from the record, the reset and the fold
    z, down_ckpts = y[5:], []
    ll, comp = model.fold_start(y.shape[-1], runup_offset == 0)
    for (r, t), day in zip(days, record):
        if chunk and t % chunk == 0:
            down_ckpts.append(z)
        z = z.clone()
        z[2:] = 0.0

        def stage_of(sub, day=day):
            return lambda i, zi: torch.stack(model.down(day[sub][i], zi))

        z = substeps_of_day(stage_of, z)
        j = t + 1 - runup_offset
        if 0 <= j < obs.shape[0]:
            ll, comp = model.fold_day(ll, comp, j, incidence(z[2:]))
    ckpts = [torch.cat([a, b]) for a, b in zip(up_ckpts, down_ckpts)]
    return ll, (torch.stack(ckpts) if chunk else None)


def op_count(tableau: str, substeps: int, n_intervals: int, n_obs_days: int) -> int:
    """Floating-point operations per chain the kernel's arithmetic implies
    (from its source: 41 per RHS evaluated (:func:`stage_use`) per age lane,
    20 per non-zero stage or update coefficient per lane, 18 per observed
    day per lane), for the roofline bound."""
    tab = get_tableau(tableau)
    nnz = int(np.count_nonzero(np.tril(tab.a, -1))) + int(np.count_nonzero(tab.b))
    per_lane = (n_intervals * (41 * dependent_stages(tableau, substeps, 1)
                               + 20 * nnz * substeps)
                + 18 * n_obs_days)
    return N_AGES * per_lane


# The gather table's format, here alone: ops/_build.py writes what the prep
# kernel needs of it into the generated header sepaihrd_prep_layout.cuh.
# The slots: agevec's fields by age, scal's, the contact scaling, the
# multipliers and run-up; then the schedule's beta and kappa sources.
AGE_FIELDS = ("a", "h_infec", "p", "h", "icu", "d_H", "d_ICU", "d_community")
SCAL_FIELDS = ("theta", "sigma", "gamma_p", "gamma_A", "gamma_I", "gamma_H",
               "gamma_ICU")
INIT_FIELDS = ("E0_multiplier", "P0_multiplier", "A0_multiplier",
               "I0_multiplier", "H0_multiplier", "ICU0_multiplier",
               "R0_multiplier", "D0_multiplier", "runup_days", "seed_exposed")
_SCAL0 = N_AGES * len(AGE_FIELDS)
_SCALING = _SCAL0 + len(SCAL_FIELDS)
_INIT0 = _SCALING + 1
_FIXED_SLOTS = _INIT0 + len(INIT_FIELDS)
# The table's sections, in order; their offsets are the kernel's ``head``
# argument: src (each slot's theta column, or -1 for its base value), base
# (each slot's base value), run_beta / run_kappa (each schedule run's beta
# and kappa slots), invN / N / frac (1/N, 0 below the floor; N; N / sum N),
# y0 (the multiplier branch's data-inferred state), lo / hi / w / w2 / deg
# (the constraint's per-column bounds, width (1 where degenerate), twice
# it, and 1 where degenerate)
PREP_SECTIONS = ("src", "base", "run_beta", "run_kappa", "invN", "N", "frac",
                 "y0", "lo", "hi", "w", "w2", "deg")
PREP_MODES = {CLAMP: 0, REFLECT: 1}       # the prep kernel's mode argument


def prep_layout_constants():
    """``{name: value}`` of the generated header ``sepaihrd_prep_layout.cuh``:
    the index of each section in the kernel's ``head``, the slots it reads
    by position, and K1's input shape."""
    camel = lambda s: "k" + "".join(w[:1].upper() + w[1:] for w in s.split("_"))
    return dict(
        {camel(s): i for i, s in enumerate(PREP_SECTIONS)},
        kSections=len(PREP_SECTIONS), kAges=N_AGES,
        kRows=C.NUM_COMPARTMENTS, kAgeFields=len(AGE_FIELDS),
        kHInfec=AGE_FIELDS.index("h_infec"), kScal0=_SCAL0,
        kScalSlots=len(SCAL_FIELDS), kScaling=_SCALING, kMult=_INIT0,
        kMults=INIT_FIELDS.index("runup_days"),
        kRunup=_INIT0 + INIT_FIELDS.index("runup_days"),
        kSeed=_INIT0 + INIT_FIELDS.index("seed_exposed"),
        kFixedSlots=_FIXED_SLOTS)


# the prep kernel's entry points by (dtype, the constraint's dtype), and the
# C arguments before the stream of the prep and mask kernels
_PREP_SUFFIX = {(torch.float32, torch.float32): "f32",
                (torch.float64, torch.float64): "f64"}
_PREP_ARGS = (_P,) * 2 + (ctypes.POINTER(_I),) + (_P,) * 5 + (_I,) * 4
_MASK_ARGS = (_P,) * 3 + (_I,)


def _mask_where(ll: torch.Tensor, infeasible: torch.Tensor) -> torch.Tensor:
    bad = infeasible | torch.isnan(ll) | torch.isinf(ll)
    return torch.where(bad, torch.full_like(ll, lowest(ll.dtype)), ll)


def _mask_kernel(ll: torch.Tensor, infeasible: torch.Tensor) -> torch.Tensor:
    check_tensors(dict(ll=ll), "mask_values")
    if infeasible.shape != ll.shape or infeasible.dtype != torch.bool \
            or infeasible.device != ll.device:
        raise ValueError("infeasible must be a bool tensor shaped and placed "
                         "as ll")
    infeasible = infeasible.contiguous()
    B = ll.shape[0]
    out = torch.empty_like(ll)
    launch("mask_values", ll.device, "sepaihrd_prep",
           f"sepaihrd_mask_{SUFFIX[ll.element_size()]}", _MASK_ARGS,
           ll.data_ptr(), infeasible.data_ptr(), out.data_ptr(), B)
    trace.count("launches", ("mask", B))
    return out


class _MaskFn(torch.autograd.Function):
    """The mask kernel under autograd: the gradient of ``torch.where``'s
    kept rows, zero on the masked ones."""

    @staticmethod
    def forward(ctx, ll, infeasible):
        ctx.save_for_backward(ll, infeasible)
        return _mask_kernel(ll, infeasible)

    @staticmethod
    def backward(ctx, g):
        ll, infeasible = ctx.saved_tensors
        bad = infeasible | torch.isnan(ll) | torch.isinf(ll)
        return torch.where(bad, torch.zeros_like(g), g), None


def mask_values(ll: torch.Tensor, infeasible: torch.Tensor) -> torch.Tensor:
    """The objective's values from K1's log-likelihoods ``ll (B,)``: a row
    that is infeasible, NaN or Inf becomes ``finfo(dtype).min``. CUDA
    tensors take the mask kernel (counted in the tracer's ``launches``
    under ``("mask", B)``; under autograd its gradient is ``torch.where``'s),
    host tensors the same ``torch.where``."""
    if not ll.is_cuda:
        return _mask_where(ll, infeasible)
    return _MaskFn.apply(ll, infeasible)


class _PrepFn(torch.autograd.Function):
    """The prep kernel under autograd: the forward is the kernel; the
    backward recomputes the plain version from the saved thetas and
    backpropagates through it, so the gradient is the plain version's."""

    @staticmethod
    def forward(ctx, thetas, prep):
        ctx.set_materialize_grads(False)
        ctx.prep = prep
        ctx.save_for_backward(thetas)
        args, infeasible = prep._prep_kernel(thetas)
        ctx.mark_non_differentiable(infeasible)
        return (*args, infeasible)

    @staticmethod
    def backward(ctx, *grads):
        (thetas,) = ctx.saved_tensors
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            args, _infeasible = ctx.prep._prep_plain(th)
            used = [(a, g) for a, g in zip(args, grads) if g is not None]
            if not used:
                return None, None
            (grad,) = torch.autograd.grad([a for a, _g in used], th,
                                          [g for _a, g in used],
                                          allow_unused=True)
        return grad, None


class FusedPrep:
    """The host constants and the theta -> kernel-input prep shared by the
    fused objective (port of ``shared_prep``).

    The prep reads one gather table, built here once and held on the
    device (``table``, float64, the sections of :data:`PREP_SECTIONS`, whose
    offsets are ``offsets``): for each slot (a field element of the
    parameters that feeds K1's inputs) the theta column it takes, after the
    constraint, or its base value; each schedule run's beta and kappa
    slots; and the constants of the derived inputs (1/N, N, the run-up's
    age shares, the multiplier branch's state, the constraint's per-column
    bounds and widths). On the card the prep kernel computes all of K1's
    inputs from it in one launch; under autograd its gradient is the plain
    version's (:class:`_PrepFn`). Host tensors take the plain version,
    PyTorch over the same slots, whose gradients flow through its
    gathers."""

    def __init__(self, space: ParameterSpace, base_params: SEPAIHRDParams,
                 data: CalibrationData, ts, *, base_initial_state=None,
                 constraint_mode: str = REFLECT, dtype: torch.dtype,
                 device: torch.device):
        ts, self.runup_offset, self.num_obs = check_grid(ts, data)
        if not np.all(np.diff(ts) == 1.0):
            raise ValueError("the fused objective integrates daily intervals: "
                             "ts must be unit-spaced")
        if constraint_mode not in PREP_MODES:
            raise ValueError(f"unknown constraint mode {constraint_mode!r}")
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
        self._build_table()

    def _build_table(self):
        """The slots (their fields, the theta column or -1 of each, their
        base values), each run's beta and kappa slots, ``table``, its
        sections' ``offsets`` and the kernel's ``head`` (the same offsets)."""
        base, space = self.base, self.space
        nb, nk = (int(base.beta_values.shape[-1]),
                  int(base.kappa_values.shape[-1]))
        beta = [("beta_values", i) for i in range(nb)] or [("beta", None)]
        kappa = [("kappa_values", k) for k in range(nk)] or [(None, None)]
        slots = ([(f, j) for f in AGE_FIELDS for j in range(N_AGES)]
                 + [(f, None) for f in SCAL_FIELDS + (
                     "contact_matrix_scaling_factor",) + INIT_FIELDS]
                 + beta + kappa)
        column = {}
        for field, fidx, tidx in space.scatter_table():
            for fi, ti in (((None, tidx),) if fidx is None else zip(fidx, tidx)):
                column[(field, fi)] = ti
        self.src = [column.get(s, -1) for s in slots]
        one = torch.ones((), dtype=self.dtype, device=self.device)
        self.base_row = torch.stack([
            one if f is None else getattr(base, f) if j is None
            else getattr(base, f)[j] for f, j in slots])
        self.beta_slots = range(_FIXED_SLOTS, _FIXED_SLOTS + len(beta))
        self.kappa_slots = range(self.beta_slots.stop,
                                 self.beta_slots.stop + len(kappa))
        self.run_beta = [self.beta_slots[i] for i in self.pb]
        self.run_kappa = [self.kappa_slots[k] for k in self.pk]
        d = space.dim
        self.gather = torch.tensor([c if c >= 0 else d + s
                                    for s, c in enumerate(self.src)],
                                   dtype=torch.int64, device=self.device)
        w, degenerate = space.reflect_widths()
        sections = dict(
            src=self.src, base=self.base_row, run_beta=self.run_beta,
            run_kappa=self.run_kappa, invN=self.invN, N=base.N,
            frac=sepaihrd.age_fraction(base.N), y0=self.base_y0,
            lo=space.lower, hi=space.upper, w=w, w2=2.0 * w, deg=degenerate)
        parts = [torch.as_tensor(sections[s]).reshape(-1).to(
            device=self.device, dtype=torch.float64) for s in PREP_SECTIONS]
        sizes = [p.numel() for p in parts]
        self.offsets = dict(zip(PREP_SECTIONS,
                                np.cumsum([0] + sizes[:-1]).tolist()))
        self.head = (ctypes.c_int * len(PREP_SECTIONS))(
            *(self.offsets[s] for s in PREP_SECTIONS))
        self.table = torch.cat(parts)

    def kernel_args(self, thetas: torch.Tensor):
        """``(args, kwargs, infeasible)`` of :func:`fused_objective` for a
        ``(B, d)`` theta batch: the tracer's span ``objective.prep``. CUDA
        thetas take the prep kernel (one launch, counted in ``launches``
        under ``("prep", mode, B)``; under autograd through :class:`_PrepFn`);
        host thetas the plain version, with ``prep.constrain``,
        ``prep.apply``, ``prep.initial_state`` and ``prep.pack`` inside. On
        the card it enqueues no host-to-device copy and reads nothing back,
        so a CUDA graph can capture it."""
        with trace.span("objective.prep"):
            if thetas.is_cuda:
                *args, infeasible = _PrepFn.apply(thetas, self)
                args = tuple(args)
            else:
                args, infeasible = self._prep_plain(thetas)
            return (args + (self.obs, self.valid, self.M),
                    dict(run_start=self.run_start, run_count=self.run_count,
                         runup_offset=self.runup_offset), infeasible)

    def _prep_kernel(self, thetas):
        """The prep kernel's ``((y0, agevec, scal, beff), infeasible)``."""
        thetas = thetas.detach().to(self.dtype).contiguous()
        B, d = thetas.shape if thetas.dim() == 2 else (0, 0)
        dev = self.table.device
        if d != self.space.dim or B < 1 or thetas.device != dev:
            raise ValueError(f"thetas must be (B, {self.space.dim}) on {dev}, "
                             f"got {tuple(thetas.shape)} on {thetas.device}")
        key = (self.dtype, torch.promote_types(self.dtype, self.space.dtype))
        if key not in _PREP_SUFFIX:
            raise ValueError(
                f"the prep kernel takes a float32 or float64 objective over a "
                f"space of its dtype, or a float64 objective over a float32 "
                f"space: not a {self.dtype} objective over a "
                f"{self.space.dtype} space")
        R = len(self.run_beta)
        new = lambda *shape: torch.empty(shape, dtype=self.dtype, device=dev)
        args = (new(C.NUM_COMPARTMENTS, N_AGES, B),
                new(len(AGE_FIELDS), N_AGES, B), new(len(SCAL_FIELDS), B),
                new(R, B))
        infeasible = torch.empty(B, dtype=torch.bool, device=dev)
        launch("FusedPrep.kernel_args", dev, "sepaihrd_prep",
               f"sepaihrd_prep_{_PREP_SUFFIX[key]}", _PREP_ARGS,
               thetas.data_ptr(), self.table.data_ptr(), self.head,
               *(a.data_ptr() for a in args), infeasible.data_ptr(), B, d, R,
               PREP_MODES[self.mode])
        trace.count("launches", ("prep", self.mode, B))
        return args, infeasible

    def _prep_plain(self, thetas):
        """The plain version: every slot gathered from the constrained
        thetas and the base values at once, then K1's inputs in PyTorch."""
        B = thetas.shape[0]
        with trace.span("prep.constrain"):
            theta = self.space.constrain(thetas.to(self.dtype), self.mode)
        with trace.span("prep.apply"):
            slots = torch.cat([theta.to(self.dtype),
                               self.base_row.expand(B, -1)], dim=1)[:, self.gather]
        with trace.span("prep.initial_state"):
            # a field no theta feeds keeps its base shape, as apply leaves it
            prm = self.base.replace(**{
                f: slots[:, s] if self.src[s] >= 0 else getattr(self.base, f)
                for s, f in enumerate(INIT_FIELDS, _INIT0)})
            y0, infeasible = sepaihrd.initial_state_for_params(prm,
                                                               self.base_y0)
        with trace.span("prep.pack"):
            y0 = y0.expand(B, C.NUM_COMPARTMENTS, N_AGES).permute(1, 2, 0)
            age = slots[:, :_SCAL0].reshape(B, len(AGE_FIELDS), N_AGES)
            agevec = torch.cat([age[:, :1], age[:, 1:2] * self.invN, age[:, 2:]],
                               dim=1).permute(1, 2, 0)
            scal = slots[:, _SCAL0:_SCALING].T
            bs = slots[:, self.beta_slots.start:self.beta_slots.stop] \
                * slots[:, _SCALING:_SCALING + 1]
            ks = slots[:, self.kappa_slots.start:self.kappa_slots.stop]
            # one product a run, as the runs share their beta and kappa
            beff = torch.stack([bs[:, i] * ks[:, k]
                                for i, k in zip(self.pb, self.pk)])
            args = tuple(a.contiguous() for a in (y0, agevec, scal, beff))
        return args, infeasible.expand(B)


# K1 value graphs an objective keeps, the least recently used dropped first
VALUE_GRAPHS = 8


def build_objective_fused(space: ParameterSpace, base_params: SEPAIHRDParams,
                          data: CalibrationData, ts, *, base_initial_state=None,
                          substeps: int = 4, tableau: str = "dopri5",
                          constraint_mode: str = REFLECT,
                          dtype: Optional[torch.dtype] = None,
                          device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched objective ``loglik_batch(thetas (B, d)) -> (B,)`` backed by the
    fused kernel (counterpart of ``build_objective_pallas``). On the card a
    call is three launches: the prep (constrain, apply, initial state and
    the per-run beta, :meth:`FusedPrep.kernel_args`), K1 (the solve and
    fold) and the mask (:func:`mask_values`): infeasible, NaN or Inf results
    become ``finfo(dtype).min``. ``dtype``/``device`` default to the base
    parameters'. On the card, outside autograd (grad on and ``thetas``
    requiring it), the whole call is replayed as a CUDA graph a device,
    dtype and shape of ``thetas`` (:class:`..utils.graphs.GraphCache`, at
    most :data:`VALUE_GRAPHS`, counter ``objective.graph``): the first call
    at a shape runs eagerly, the second captures the call on a static input
    (a cast as ``.to(dtype)`` is), and each replay copies ``thetas`` in and
    returns a clone of the graph's output, so that a result the caller
    keeps is never overwritten. A call is the tracer's span ``objective``, a
    replay ``objective.replay``; on an eager or capturing call its mask of
    infeasible, NaN or Inf rows is ``objective.mask``."""
    dtype = dtype or base_params.dtype
    dev = resolve_device(device or base_params.device)
    prep = FusedPrep(space, base_params, data, ts,
                     base_initial_state=base_initial_state,
                     constraint_mode=constraint_mode, dtype=dtype, device=dev)

    def value(thetas: torch.Tensor) -> torch.Tensor:
        args, kw, infeasible = prep.kernel_args(thetas)
        ll = fused_objective(*args, **kw, substeps=substeps, tableau=tableau)
        with trace.span("objective.mask"):
            return mask_values(ll, infeasible)

    def build(thetas):
        static_in = torch.empty(thetas.shape, dtype=dtype, device=thetas.device)
        return static_in, (lambda: value(static_in),)

    graphs = GraphCache("objective.graph", 1, VALUE_GRAPHS)

    def loglik_batch(thetas: torch.Tensor) -> torch.Tensor:
        with trace.span("objective"):
            graphed = thetas.is_cuda and not (torch.is_grad_enabled()
                                              and thetas.requires_grad)
            key = (thetas.device, thetas.dtype, tuple(thetas.shape))
            entry = graphs.get(key if graphed else None, thetas.device,
                               int(thetas.shape[0]), lambda: build(thetas))
            if entry is None:
                return value(thetas)
            with trace.span("objective.replay"):
                entry.held.copy_(thetas)
                entry.replay()
                return entry.outputs[0].clone()

    loglik_batch.prep = prep
    return loglik_batch
