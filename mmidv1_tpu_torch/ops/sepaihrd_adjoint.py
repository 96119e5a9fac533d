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
  B)`` and ``dLL/dbeff (n_runs, B)``. K3 is several kernels launched back
  to back, in one of two regimes that :func:`choose_regime` picks from the
  chain count and the card: all chunks swept at once and their affine maps
  composed (few chains; :func:`fused_adjoint_chunked_reference` is its
  plain model), or one sweep per chain (many chains).

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
from ..calibration.param_space import REFLECT, ParameterSpace
from ..data.calibration_data import CalibrationData
from ..ode.tableaus import get_tableau
from ..params import SEPAIHRDParams
from ..utils import trace
from ._build import SUFFIX, bind, launch, tableau_id
from .sepaihrd_fused import (N_AGES, build_objective_fused,
                             check_forward_inputs, check_regime,
                             check_schedule, check_tensors, dependent_stages,
                             host_consts, launch_forward, mask_values,
                             op_count, plain_days, plain_forward,
                             plain_forward_split, stage_use)

L_CHUNK = 24        # days per checkpoint (csrc/sepaihrd_adjoint.cu kChunk)
MAX_SUBSTEPS = 16   # K3's scratch holds the state after every substep
_CARRIED = 10
_SWEEPS = 29        # kSweeps: regime 1's particular + 7 x 4 homogeneous sweeps
_OUT_ROWS = 67      # kOutRows: rows of a chunk's affine map
SCRATCH_CAP = 1 << 30       # bytes of scratch one K3 call may hold
# regime 1 up to this many (chain, chunk) blocks an SM, by bytes a value
CHUNK_BLOCKS_PER_SM = {4: 50, 8: 37}


def num_chunks(n_intervals: int) -> int:
    return -(-n_intervals // L_CHUNK)


# K3's C arguments before the stream
_ADJOINT_ARGS = ((ctypes.c_void_p,) * 12 + (ctypes.c_longlong,)
                 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,) * 3
                 + (ctypes.c_int,) + (ctypes.c_void_p,) * 2
                 + (ctypes.c_int,) * 4 + (ctypes.POINTER(ctypes.c_int),))


def _strict_incidence(cv: torch.Tensor) -> torch.Tensor:
    """``max(cv, 0)`` in value (NaN kept, ``-inf`` becomes NaN), with the
    strict gradient gate ``cv > 0`` of K3's fold adjoint: 0 at ``cv == 0``."""
    return torch.where(cv > 0, cv, 0.0 * cv)


def fused_forward_ckpt(y0: torch.Tensor, agevec: torch.Tensor,
                       scal: torch.Tensor, beff: torch.Tensor,
                       obs: torch.Tensor, valid: torch.Tensor, M, *,
                       run_start, run_count, runup_offset: int,
                       substeps: int = 4, tableau: str = "dopri5",
                       regime: Optional[int] = None):
    """``(ll (B,), ckpt (n_chunks, 10, 4, B))``: the inputs and the
    log-likelihood of :func:`.sepaihrd_fused.fused_objective`, and the
    pre-reset day-start state of every ``L_CHUNK``-th day. CPU inputs run
    the plain version; CUDA inputs launch K2 on the current stream, or
    raise. ``regime`` forces K2's split (1) or wide (2) regime past
    :func:`.sepaihrd_fused.choose_forward_regime`, for tests and timing. A
    launch counts in the tracer's ``launches`` under ``("k2", regime,
    tableau, chains)``."""
    B, _n_runs, _T_obs = check_forward_inputs(y0, agevec, scal, beff, obs,
                                              valid, M, run_start, run_count,
                                              runup_offset, substeps)
    check_regime(regime)
    kw = dict(run_start=run_start, run_count=run_count,
              runup_offset=runup_offset, substeps=substeps, tableau=tableau)
    if y0.device.type == "cpu":
        return fused_forward_ckpt_reference(y0, agevec, scal, beff, obs, valid,
                                            M, **kw)
    if y0.device.type != "cuda":
        raise ValueError(f"unsupported device {y0.device}")
    ckpt = torch.empty((num_chunks(int(sum(run_count))), _CARRIED, N_AGES, B),
                       dtype=y0.dtype, device=y0.device)
    out = launch_forward("fused_forward_ckpt", y0, agevec, scal, beff, obs,
                         valid, M, **kw, ckpt=ckpt, regime=regime)
    return out, ckpt


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


def fused_forward_ckpt_split_reference(y0, agevec, scal, beff, obs, valid, M,
                                       *, run_start, run_count,
                                       runup_offset: int, substeps: int = 4,
                                       tableau: str = "dopri5"):
    """The plain model of K2's split regime
    (:func:`.sepaihrd_fused.plain_forward_split`): equal to
    :func:`fused_forward_ckpt_reference` bit for bit."""
    return plain_forward_split(y0, agevec, scal, beff, obs, valid, M,
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
    inputs run the plain version; CUDA inputs launch K3, or raise. A launch
    counts in the tracer's ``launches`` under ``("k3", regime, tableau,
    chains)`` and its ``__global__`` launches in ``k3.kernels`` under
    ``(regime,)``."""
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
    out, regime, n_kernels = _launch_adjoint(agevec, scal, beff, obs, valid,
                                             ckpt, g, M, **kw)
    trace.count("launches", ("k3", regime, tableau, B))
    trace.count("k3.kernels", (regime,), n_kernels)
    return out


def choose_regime(B: int, n_chunks: int, sm_count: int, elem: int,
                  chunked_scratch_bytes: int) -> int:
    """K3's regime for ``B`` chains of ``elem``-byte values on a card with
    ``sm_count`` SMs.

    Regime 1 (chunk-parallel) launches one block per (chain, chunk) that
    does 29 times the transpose arithmetic to cut the serial chain from all
    days to one chunk's. Its time grows with the number of blocks, regime
    2's (one lane group per chain, least arithmetic, one chain of all days)
    hardly with B, so regime 1 is taken while ``B * n_chunks <=
    CHUNK_BLOCKS_PER_SM[elem] * sm_count`` and its scratch (every stage
    input of every day) fits ``SCRATCH_CAP``. The constants come from
    ``chip_smoke.py``'s crossover timings on an H100 (PERF.md) at 14 chunks
    and 132 SMs: in float32 regime 1 still wins at B = 448 and loses at 512,
    in float64 it wins at 320 and loses at 384, and the constants put the
    switch where the two timed neighbours' lines cross, B <= 471 and
    B <= 348."""
    few = B * n_chunks <= CHUNK_BLOCKS_PER_SM[elem] * sm_count
    return 1 if few and chunked_scratch_bytes <= SCRATCH_CAP else 2


def _launch_adjoint(agevec, scal, beff, obs, valid, ckpt, g, M, *, run_start,
                    run_count, runup_offset: int, substeps: int = 4,
                    tableau: str = "dopri5", regime: Optional[int] = None):
    """Launch K3 on validated CUDA inputs: ``((dy0, dagevec, dscal, dbeff),
    regime, kernels launched)``. ``regime`` forces 1 or 2 past
    :func:`choose_regime`; only the card checks pass it."""
    need = bind("sepaihrd_adjoint", "sepaihrd_adjoint_scratch_len",
                (ctypes.c_int,) * 7, ctypes.c_longlong)
    S, _fsal, a, b, m, rs, rc = host_consts(tableau, substeps, M, run_start,
                                            run_count)
    dev, dtype = agevec.device, agevec.dtype
    B, n_runs, n_chunks = agevec.shape[-1], len(run_start), ckpt.shape[0]
    n_intervals = int(sum(run_count))
    elem = torch.finfo(dtype).bits // 8
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    if regime is None:
        regime = choose_regime(
            B, n_chunks, sm_count, elem,
            elem * need(1, B, int(substeps), S, n_intervals, n_runs, 1))
    # regime 2 holds the substep states of one wave of chunks at a time
    per_chunk = elem * L_CHUNK * int(substeps) * _CARRIED * N_AGES * B
    wave = max(1, min(n_chunks, SCRATCH_CAP // per_chunk))
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    scratch = new(need(regime, B, int(substeps), S, n_intervals, n_runs, wave))
    outs = (new(C.NUM_COMPARTMENTS, N_AGES, B), new(8, N_AGES, B), new(7, B),
            new(n_runs, B))
    n_kernels = ctypes.c_int(0)
    launch("sepaihrd_adjoint", dev, "sepaihrd_adjoint",
           f"sepaihrd_adjoint_{SUFFIX[elem]}", _ADJOINT_ARGS,
           *(t.data_ptr() for t in (agevec, scal, beff, obs, valid, ckpt, g)
             + outs + (scratch,)),
           scratch.numel(), B, obs.shape[0], int(runup_offset), int(substeps),
           tableau_id(tableau), a, b, m, n_runs, rs, rc, n_chunks,
           int(regime), wave, sm_count, ctypes.byref(n_kernels))
    return outs, int(regime), n_kernels.value


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


def fused_adjoint_chunked_reference(agevec, scal, beff, obs, valid, ckpt, g,
                                    M, *, run_start, run_count,
                                    runup_offset: int, substeps: int = 4,
                                    tableau: str = "dopri5"):
    """A plain PyTorch model of K3's chunk-parallel regime: the same four
    outputs as :func:`fused_adjoint_reference`, computed chunk by chunk with
    no cotangent carried between the chunks' sweeps.

    The backward sweep is affine in the cotangent ``lam`` that enters a
    chunk from the later one, and ``lam`` has 7 x 4 non-zero entries per
    chain (the D/CumH/CumICU rows are reset at every day boundary). So each
    chunk is pulled back on its own from its checkpoint, 1 + 28 times: once
    with ``lam = 0`` and the fold's cotangent ``g`` as source (the particular
    pull), and once per unit ``lam`` without source (the homogeneous pulls).
    A last pass walks the chunks from the last to the first, ``lam <- A_c
    lam + b_c``, and accumulates the parameter cotangents ``dq += G_c lam +
    h_c``; it runs in float64 whatever the inputs' type, as the kernel's.
    No lambda enters the last chunk, so its homogeneous pulls are not made
    (the kernel makes them and does not read them)."""
    B, n_runs = agevec.shape[-1], len(run_count)
    n, n_chunks = int(sum(run_count)), ckpt.shape[0]
    kw = dict(run_start=run_start, run_count=run_count,
              runup_offset=runup_offset, substeps=substeps, tableau=tableau,
              incidence=_strict_incidence)
    unit = torch.zeros((28, _CARRIED, N_AGES, B), dtype=agevec.dtype,
                       device=agevec.device)
    for j in range(28):
        unit[j, j // N_AGES, j % N_AGES] = 1.0

    def pull(out, leaves, grad_outputs, batched):
        shape = (28,) if batched else ()
        if not out.requires_grad:        # e.g. a chunk with no observed day
            return [torch.zeros(shape + t.shape, dtype=t.dtype,
                                device=t.device) for t in leaves]
        grads = torch.autograd.grad(out, leaves, grad_outputs=grad_outputs,
                                    retain_graph=True, allow_unused=True,
                                    is_grads_batched=batched)
        return [torch.zeros(shape + t.shape, dtype=t.dtype, device=t.device)
                if gr is None else gr.double() for gr, t in zip(grads, leaves)]

    chunks = []
    for c in range(n_chunks):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (ckpt[c], agevec, scal, beff)]
            ll, y_end, _ = plain_days(
                *leaves, obs, valid, M, **kw,
                days=(c * L_CHUNK, min((c + 1) * L_CHUNK, n)))
            chunks.append((pull(ll, leaves, g.reshape(B), False),
                           pull(y_end, leaves, unit, True)
                           if c < n_chunks - 1 else None))

    lam = torch.zeros((28, B), dtype=torch.float64, device=agevec.device)
    acc = [torch.zeros(shape, dtype=torch.float64, device=agevec.device)
           for shape in ((8, N_AGES, B), (7, B), (n_runs, B))]
    for particular, homogeneous in reversed(chunks):
        step = [h.double() if G is None else h.double()
                + torch.einsum("jb,j...b->...b", lam, G.double())
                for h, G in zip(particular, homogeneous or [None] * 4)]
        acc = [a + s for a, s in zip(acc, step[1:])]
        lam = step[0][:7].reshape(28, B)
    dy0 = torch.zeros((C.NUM_COMPARTMENTS, N_AGES, B), dtype=torch.float64,
                      device=agevec.device)
    dy0[:7] = lam.reshape(7, N_AGES, B)
    return tuple(t.to(agevec.dtype) for t in [dy0] + acc)


def op_count_adjoint(tableau: str, substeps: int, n_intervals: int,
                     n_obs_days: int, n_runs: int = 1) -> dict:
    """Floating-point operations per chain, counted from the kernels' source
    as :func:`.sepaihrd_fused.op_count` is: per age lane, 41 per RHS, 95 per
    RHS transpose (``rhs_vjp``), 20 per non-zero stage or update coefficient
    in a forward substep and 18 per observed day for the fold adjoint. A
    dead stage (:func:`.sepaihrd_fused.stage_use`) is neither evaluated nor
    transposed.

    ``"fwd"``: K2, which does K1's arithmetic (its checkpoint stores are
    bytes). ``"bwd"``: the least arithmetic of K3's function, one
    re-integration from the checkpoints plus the transpose of every live
    stage of every substep (10 rows a stage: 20 per non-zero stage
    coefficient for the stage cotangent's axpy, 10 per non-zero update
    coefficient and 10 per live stage for its seed and sum); the bounds use
    it. ``"bwd_design"``: K3 as built, by regime. Both re-integrate once
    (stage "days") and recompute each substep's stage inputs (the RHS of
    every stage a later stage input reads, and the stage axpys), and
    transpose with 7-row stage cotangents (14 per non-zero stage
    coefficient, 10 per non-zero update coefficient, 7 per live stage).
    Regime 2 does that once. Regime 1 computes each live stage's contact
    matvec (11 of the transpose's 95) once beside the stage inputs,
    transposes 29 times (one particular and 28 homogeneous sweeps) and
    composes the chunks' affine maps (57 per row of a chunk's map and per
    (chunk, run) segment, once per chain)."""
    tab = get_tableau(tableau)
    feeds, live, _evaluated = stage_use(tableau)
    n_feeds, n_live = sum(feeds), sum(live)
    nnz_a = int(np.count_nonzero(np.tril(tab.a, -1)))
    nnz_b = int(np.count_nonzero(tab.b))
    fwd = op_count(tableau, substeps, n_intervals, n_obs_days)
    day = (41 * dependent_stages(tableau, substeps, 1)
           + 20 * (nnz_a + nnz_b) * substeps)
    transpose = n_live * (95 + 10) + 20 * nnz_a + 10 * nnz_b
    fold = 18 * n_obs_days
    bwd = n_intervals * (day + substeps * transpose) + fold
    stage_inputs = 41 * n_feeds + 20 * nnz_a
    axpys7 = 7 * n_live + 14 * nnz_a + 10 * nnz_b
    n_chunks = num_chunks(n_intervals)
    compose = 57 * (n_chunks * _OUT_ROWS + n_chunks + n_runs - 1)

    def design(per_substep):
        return n_intervals * (day + substeps * per_substep) + fold

    chunked = stage_inputs + 11 * n_live + _SWEEPS * (84 * n_live + axpys7)
    return {"fwd": fwd, "bwd": N_AGES * bwd,
            "bwd_design": {1: N_AGES * design(chunked) + compose,
                           2: N_AGES * design(stage_inputs + 95 * n_live
                                              + axpys7)}}


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
            ll = mask_values(ll, infeasible)
            (grad,) = torch.autograd.grad(ll.sum(), th)
        value_and_grad_batch.calls += 1
        return ll.detach(), grad

    value_and_grad_batch.calls = 0
    value_and_grad_batch.value_batch = value_batch
    value_and_grad_batch.prep = prep
    return value_and_grad_batch
