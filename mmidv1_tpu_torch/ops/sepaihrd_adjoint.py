"""K2 and K3: the value and gradient of the fused SEPAIHRD objective.

Port of ``mmidv1_tpu/ops/sepaihrd_adjoint.py`` (``_fwd_call``, ``_bwd_call``,
``make_fused_objective_vjp``, ``build_objective_pallas_grad``). The kernels
are hand-written CUDA C++ for Hopper, ``csrc/sepaihrd_adjoint.cu`` (its header
says what bounds them and how they are laid out), built by :mod:`._build` and
called through ctypes:

- :func:`fused_forward_ckpt` (K2): the log-likelihood per chain, as
  :func:`.sepaihrd_fused.fused_objective`, plus the pre-reset day-start state
  every ``L_CHUNK`` days, ``ckpt (n_chunks, 10, 4, B)`` (R dropped);
- :func:`fused_adjoint` (K3): from the checkpoints and the cotangent ``g
  (B,)``, ``dLL/dy0 (11, 4, B)``, ``dLL/dagevec (8, 4, B)``, ``dLL/dscal (7,
  B)`` and ``dLL/dbeff (n_runs, B)``.

Both dispatch on the device of their inputs alone: CPU tensors go to the
plain PyTorch versions beside them, CUDA tensors to the kernels, with no
fallback from one to the other. :class:`FusedObjectiveFn` joins them into an
autograd function, and :func:`build_objective_fused_grad` into the batched
``value_and_grad`` engine of NUTS and MALA.

Ties: the kernel's fold adjoint gates a day's incidence cotangent by the
strict mask ``cv > 0``, as the Pallas adjoint does, where ``jax.grad`` of the
XLA objective would pass half at ``cv == 0``; the force of infection's
``max(x, 0)`` passes half at ``x == 0`` in both. The plain version of K3 is
``torch.autograd`` through the plain forward with the same two rules.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..calibration.objective import lowest
from ..calibration.param_space import REFLECT, ParameterSpace
from ..data.calibration_data import CalibrationData
from ..ode.tableaus import get_tableau
from ..params import SEPAIHRDParams
from .sepaihrd_fused import (N_AGES, _check_inputs, build_objective_fused,
                             check_schedule, check_tensors, host_consts,
                             op_count, plain_forward)

L_CHUNK = 24        # days per checkpoint (csrc/sepaihrd_adjoint.cu kChunk)
MAX_SUBSTEPS = 16   # kMaxSubsteps: K3 keeps one day's substep starts
_CARRIED = 10
_THREADS = 128      # kThreads


def num_chunks(n_intervals: int) -> int:
    return -(-n_intervals // L_CHUNK)


def _lib():
    from . import _build

    return _build.load("sepaihrd_adjoint")


def _raise_on(lib, err: int, what: str):
    if err != 0:
        lib.sepaihrd_adjoint_error_string.restype = ctypes.c_char_p
        lib.sepaihrd_adjoint_error_string.argtypes = [ctypes.c_int]
        msg = lib.sepaihrd_adjoint_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _strict_incidence(cv: torch.Tensor) -> torch.Tensor:
    """``max(cv, 0)`` in value (NaN kept, ``-inf`` becomes NaN), with the
    strict gradient gate ``cv > 0`` of K3's fold adjoint: 0 at ``cv == 0``."""
    return torch.where(cv > 0, cv, 0.0 * cv)


def fused_forward_ckpt(y0: torch.Tensor, agevec: torch.Tensor,
                       scal: torch.Tensor, beff: torch.Tensor,
                       obs: torch.Tensor, valid: torch.Tensor, M, *,
                       run_start, run_count, runup_offset: int,
                       substeps: int = 4, tableau: str = "dopri5"):
    """``(ll (B,), ckpt (n_chunks, 10, 4, B))``: the inputs and the
    log-likelihood of :func:`.sepaihrd_fused.fused_objective`, and the
    pre-reset day-start state of every ``L_CHUNK``-th day. CPU inputs run
    the plain version; CUDA inputs launch K2 on the current stream, or
    raise."""
    B, n_runs, T_obs = _check_inputs(y0, agevec, scal, beff, obs, valid, M,
                                     run_start, run_count, runup_offset,
                                     substeps)
    kw = dict(run_start=run_start, run_count=run_count,
              runup_offset=runup_offset, substeps=substeps, tableau=tableau)
    if y0.device.type == "cpu":
        return fused_forward_ckpt_reference(y0, agevec, scal, beff, obs, valid,
                                            M, **kw)
    if y0.device.type != "cuda":
        raise ValueError(f"unsupported device {y0.device}")
    lib = _lib()
    S, fsal, a, b, m, rs, rc = host_consts(tableau, substeps, M, run_start,
                                           run_count)
    n_chunks = num_chunks(int(sum(run_count)))
    out = torch.empty(B, dtype=y0.dtype, device=y0.device)
    ckpt = torch.empty((n_chunks, _CARRIED, N_AGES, B), dtype=y0.dtype,
                       device=y0.device)
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        fn = lib.sepaihrd_fwd_ckpt_f32 if y0.dtype == torch.float32 \
            else lib.sepaihrd_fwd_ckpt_f64
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
        err = fn(y0.data_ptr(), agevec.data_ptr(), scal.data_ptr(),
                 beff.data_ptr(), obs.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), ckpt.data_ptr(), B, T_obs, int(runup_offset),
                 int(substeps), S, fsal, a, b, m, n_runs, rs, rc, n_chunks,
                 stream)
    _raise_on(lib, err, "sepaihrd_fwd_ckpt")
    fused_forward_ckpt.launches += 1
    return out, ckpt


fused_forward_ckpt.launches = 0


def fused_forward_ckpt_reference(y0, agevec, scal, beff, obs, valid, M, *,
                                 run_start, run_count, runup_offset: int,
                                 substeps: int = 4, tableau: str = "dopri5"):
    """The plain PyTorch version of K2: K1's plain version plus the
    checkpoint stores, one eager op at a time."""
    return plain_forward(y0, agevec, scal, beff, obs, valid, M,
                         run_start=run_start, run_count=run_count,
                         runup_offset=runup_offset, substeps=substeps,
                         tableau=tableau, chunk=L_CHUNK,
                         incidence=_strict_incidence)


def _check_adjoint_inputs(agevec, scal, beff, obs, valid, ckpt, g, M,
                          run_start, run_count, runup_offset, substeps):
    tensors = dict(agevec=agevec, scal=scal, beff=beff, obs=obs, valid=valid,
                   ckpt=ckpt, g=g)
    check_tensors(tensors, "fused_adjoint")
    B, T_obs = agevec.shape[-1], obs.shape[0]
    if B < 1 or T_obs < 1:
        raise ValueError("need at least one chain and one observation row")
    check_schedule(M, run_start, run_count, runup_offset, substeps, T_obs)
    n_chunks = num_chunks(int(sum(run_count)))
    want = dict(agevec=(8, N_AGES, B), scal=(7, B), beff=(len(run_count), B),
                obs=(T_obs, 3, N_AGES), valid=(T_obs, 3, N_AGES),
                ckpt=(n_chunks, _CARRIED, N_AGES, B), g=(B,))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if not 1 <= int(substeps) <= MAX_SUBSTEPS:
        raise ValueError(f"the adjoint takes 1..{MAX_SUBSTEPS} substeps, "
                         f"got {substeps}")
    return B, n_chunks


def fused_adjoint(agevec: torch.Tensor, scal: torch.Tensor, beff: torch.Tensor,
                  obs: torch.Tensor, valid: torch.Tensor, ckpt: torch.Tensor,
                  g: torch.Tensor, M, *, run_start, run_count,
                  runup_offset: int, substeps: int = 4,
                  tableau: str = "dopri5"):
    """``(dy0 (11, 4, B), dagevec (8, 4, B), dscal (7, B), dbeff (n_runs,
    B))``: the cotangent ``g (B,)`` of the log-likelihood pulled back to the
    inputs of :func:`fused_forward_ckpt`, from its checkpoints. dy0's R row
    and its D/CumH/CumICU rows (reset before they are read) are 0. CPU
    inputs run the plain version; CUDA inputs launch K3, or raise."""
    B, n_chunks = _check_adjoint_inputs(agevec, scal, beff, obs, valid, ckpt,
                                        g, M, run_start, run_count,
                                        runup_offset, substeps)
    kw = dict(run_start=run_start, run_count=run_count,
              runup_offset=runup_offset, substeps=substeps, tableau=tableau)
    if agevec.device.type == "cpu":
        return fused_adjoint_reference(agevec, scal, beff, obs, valid, ckpt, g,
                                       M, **kw)
    if agevec.device.type != "cuda":
        raise ValueError(f"unsupported device {agevec.device}")
    lib = _lib()
    S, fsal, a, b, m, rs, rc = host_consts(tableau, substeps, M, run_start,
                                           run_count)
    dev, dtype = agevec.device, agevec.dtype
    n_threads = -(-N_AGES * B // _THREADS) * _THREADS
    scratch = torch.empty(((L_CHUNK + 1) * _CARRIED * n_threads,), dtype=dtype,
                          device=dev)
    dy0 = torch.empty((C.NUM_COMPARTMENTS, N_AGES, B), dtype=dtype, device=dev)
    dagevec = torch.empty((8, N_AGES, B), dtype=dtype, device=dev)
    dscal = torch.empty((7, B), dtype=dtype, device=dev)
    dbeff = torch.empty((len(run_start), B), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = lib.sepaihrd_adjoint_f32 if dtype == torch.float32 \
            else lib.sepaihrd_adjoint_f64
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        err = fn(agevec.data_ptr(), scal.data_ptr(), beff.data_ptr(),
                 obs.data_ptr(), valid.data_ptr(), ckpt.data_ptr(),
                 g.data_ptr(), dy0.data_ptr(), dagevec.data_ptr(),
                 dscal.data_ptr(), dbeff.data_ptr(), scratch.data_ptr(),
                 scratch.numel(), B, obs.shape[0], int(runup_offset),
                 int(substeps), S, fsal, a, b, m, len(run_start), rs, rc,
                 n_chunks, stream)
    _raise_on(lib, err, "sepaihrd_adjoint")
    fused_adjoint.launches += 1
    return dy0, dagevec, dscal, dbeff


fused_adjoint.launches = 0


def fused_adjoint_reference(agevec, scal, beff, obs, valid, ckpt, g, M, *,
                            run_start, run_count, runup_offset: int,
                            substeps: int = 4, tableau: str = "dopri5"):
    """The plain PyTorch version of K3: ``torch.autograd`` through the plain
    forward, re-run from the initial state in ``ckpt[0]`` with the cotangent
    ``g``. Its fold gate is K3's strict ``cv > 0`` (``_strict_incidence``),
    its force-of-infection gate ``torch.maximum``'s 1/2 at the tie, as K3."""
    B = agevec.shape[-1]
    start = ckpt[0]
    y0 = torch.cat([start[:7], torch.zeros_like(start[:1]), start[7:]])
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (y0, agevec, scal, beff)]
        ll, _ = plain_forward(*leaves, obs, valid, M, run_start=run_start,
                              run_count=run_count, runup_offset=runup_offset,
                              substeps=substeps, tableau=tableau,
                              incidence=_strict_incidence)
        grads = torch.autograd.grad(ll, leaves, grad_outputs=g.reshape(B))
    return tuple(gr.detach() for gr in grads)


def op_count_adjoint(tableau: str, substeps: int, n_intervals: int,
                     n_obs_days: int) -> dict:
    """Floating-point operations per chain, counted from the kernels' source
    as :func:`.sepaihrd_fused.op_count` is: per age lane, 41 per RHS, 95 per
    RHS transpose (``rhs_vjp``), 20 per non-zero stage or update coefficient
    in a forward substep, 20 per non-zero stage coefficient for the stage
    cotangent's axpy, 10 per non-zero update coefficient and 10 per stage
    for the cotangent's seed and sum, and 18 per observed day for the fold
    adjoint.

    ``"fwd"``: K2, which does K1's arithmetic (its checkpoint stores are
    bytes). ``"bwd"``: the least arithmetic of K3's function, one
    re-integration from the checkpoints plus the transpose of every substep;
    the bounds use it. ``"bwd_design"``: K3 as built, which on top of that
    recomputes each day's substep starts (``substeps - 1`` fresh substeps)
    and each substep's stage inputs (one more forward substep, its update
    excepted) to keep no stage values between phases."""
    tab = get_tableau(tableau)
    S = tab.stages
    nnz_a = int(np.count_nonzero(np.tril(tab.a, -1)))
    nnz_b = int(np.count_nonzero(tab.b))
    fwd = op_count(tableau, substeps, n_intervals, n_obs_days)
    rhs_per_day = 1 + substeps * (S - 1) if tab.fsal else substeps * S
    day = 41 * rhs_per_day + 20 * (nnz_a + nnz_b) * substeps       # phase 1
    transpose = S * (95 + 10) + 20 * nnz_a + 10 * nnz_b
    recompute = ((substeps - 1) * (41 * S + 20 * (nnz_a + nnz_b))
                 + substeps * (41 * S + 20 * nnz_a))
    fold = 18 * n_obs_days
    bwd = n_intervals * (day + substeps * transpose) + fold
    return {"fwd": fwd, "bwd": N_AGES * bwd,
            "bwd_design": N_AGES * (bwd + n_intervals * recompute)}


class FusedObjectiveFn(torch.autograd.Function):
    """``ll = f(y0, agevec, scal, beff)`` whose forward is K2 (keeping its
    checkpoints) and whose backward is K3: the counterpart of
    ``make_fused_objective_vjp``. ``obs``, ``valid``, ``M`` and ``spec``
    (the keyword arguments of :func:`fused_forward_ckpt`) get no gradient."""

    @staticmethod
    def forward(ctx, y0, agevec, scal, beff, obs, valid, M, spec):
        ll, ckpt = fused_forward_ckpt(y0, agevec, scal, beff, obs, valid, M,
                                      **spec)
        ctx.save_for_backward(agevec, scal, beff, obs, valid, ckpt)
        ctx.M, ctx.spec = M, spec
        return ll

    @staticmethod
    def backward(ctx, g):
        agevec, scal, beff, obs, valid, ckpt = ctx.saved_tensors
        dy0, dagevec, dscal, dbeff = fused_adjoint(
            agevec, scal, beff, obs, valid, ckpt, g.contiguous(), ctx.M,
            **ctx.spec)
        return dy0, dagevec, dscal, dbeff, None, None, None, None


def build_objective_fused_grad(space: ParameterSpace,
                               base_params: SEPAIHRDParams,
                               data: CalibrationData, ts, *,
                               base_initial_state=None, substeps: int = 4,
                               tableau: str = "dopri5",
                               constraint_mode: str = REFLECT,
                               dtype: Optional[torch.dtype] = None,
                               device=None):
    """Batched ``value_and_grad_batch(thetas (B, d)) -> (ll (B,), grad (B,
    d))`` backed by K2 and K3 (counterpart of ``build_objective_pallas_grad``),
    the gradient engine of NUTS and MALA. The prep (constrain, apply, initial
    state, per-run beta) is :class:`.sepaihrd_fused.FusedPrep` run under
    autograd, so the gradient chains through it. Chains are independent, so
    the gradient of ``ll.sum()`` is the per-chain gradient. Infeasible, NaN
    or Inf chains get ``finfo(dtype).min``; a NaN chain's gradient is NaN.
    ``.value_batch`` is the value alone, through K1; ``.calls`` counts the
    ``value_and_grad`` calls."""
    value_batch = build_objective_fused(
        space, base_params, data, ts, base_initial_state=base_initial_state,
        substeps=substeps, tableau=tableau, constraint_mode=constraint_mode,
        dtype=dtype, device=device)
    prep = value_batch.prep
    spec = dict(run_start=prep.run_start, run_count=prep.run_count,
                runup_offset=prep.runup_offset, substeps=substeps,
                tableau=tableau)

    def value_and_grad_batch(thetas: torch.Tensor):
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            (y0, agevec, scal, beff, obs, valid, M), _kw, infeasible = \
                prep.kernel_args(th)
            ll = FusedObjectiveFn.apply(y0, agevec, scal, beff, obs, valid, M,
                                        spec)
            bad = infeasible | torch.isnan(ll) | torch.isinf(ll)
            ll = torch.where(bad, torch.full_like(ll, lowest(prep.dtype)), ll)
            (grad,) = torch.autograd.grad(ll.sum(), th)
        value_and_grad_batch.calls += 1
        return ll.detach(), grad

    value_and_grad_batch.calls = 0
    value_and_grad_batch.value_batch = value_batch
    value_and_grad_batch.prep = prep
    return value_and_grad_batch
