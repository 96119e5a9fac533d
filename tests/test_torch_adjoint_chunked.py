"""The chunk-parallel adjoint (K3's regime for few chains) as a plain PyTorch
model, on the CPU.

``fused_adjoint_chunked_reference`` pulls every 24-day chunk back on its own,
once with the fold's cotangent as source and once per unit of the 7 x 4
cotangent that enters the chunk, and then composes the chunks' affine maps
from the last to the first. It must give what the serial sweep gives
(``fused_adjoint_reference``, autograd through the whole plain forward):

- float64: rtol 1e-9 with an absolute floor of 1e-9 x the chain's largest
  entry (the two differ by summation order only; measured ~1e-15);
- float32: each chain's gradient within 1e-3 in relative 2-norm (measured
  ~1e-7 at these sizes: the 28 columns of a chunk's map carry float32
  rounding each, and the composition runs in float64);

with and without run-up, with schedule run boundaries inside a chunk and on
every day, with a day whose raw incidence is exactly 0 (the strict fold gate)
and with a NaN chain. The whole ``value_and_grad`` with the chunked model in
K3's place is held against the JAX package's ``build_objective_pallas_grad``
(interpret mode) at the bars of tests/test_adjoint.py: LL rtol 1e-12,
gradient rtol/atol 1e-9.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.param_space import CLAMP, REFLECT
from mmidv1_tpu.ops import build_objective_pallas_grad

from mmidv1_tpu_torch.ops import build_objective_fused_grad
from mmidv1_tpu_torch.ops import sepaihrd_adjoint as adj
from mmidv1_tpu_torch.ops import sepaihrd_fused as sf

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_adjoint import short_spain  # noqa: E402,F401  (fixture)
from test_torch_kernels import _args, _objective  # noqa: E402

torch.set_num_threads(1)


def _problem(dtype, runup, B, tableau="dopri5", per_day=False):
    """Kernel inputs of the 35-day problem of tests/test_torch_kernels.py
    (55 intervals and 3 chunks with the 20-day run-up, 35 and 2 without;
    two schedule runs whose boundary lies inside a chunk), its checkpoints
    and a random cotangent."""
    ll, theta0 = _objective("cpu", dtype, runup)
    (y0, agevec, scal, beff, obs, valid, M), kw, _inf = _args(ll, theta0, B, B)
    kw = dict(kw, substeps=2, tableau=tableau)
    if per_day:                           # every day a schedule run of its own
        days = [r for r, c in enumerate(kw["run_count"]) for _ in range(c)]
        beff = beff[days].contiguous()
        kw = dict(kw, run_start=tuple(range(len(days))),
                  run_count=(1,) * len(days))
    g = torch.as_tensor(np.random.default_rng(B).uniform(0.5, 1.5, B),
                        dtype=dtype)
    return [y0, agevec, scal, beff, obs, valid, M], kw, g


def _both(inputs, kw, g):
    y0, agevec, scal, beff, obs, valid, M = inputs
    _ll, ck = adj.fused_forward_ckpt(*inputs, **kw)
    assert ck.shape[0] == adj.num_chunks(sum(kw["run_count"])) >= 2
    args = (agevec, scal, beff, obs, valid, ck, g, M)
    return (adj.fused_adjoint_chunked_reference(*args, **kw),
            adj.fused_adjoint_reference(*args, **kw), ck)


def _close(got, ref, dtype, chains):
    for name, a, b in zip(("dy0", "dagevec", "dscal", "dbeff"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype
        for c in chains:
            x = a[..., c].double().numpy().ravel()
            y = b[..., c].double().numpy().ravel()
            assert np.isfinite(x).all(), (name, c)
            if dtype == torch.float64:
                np.testing.assert_allclose(x, y, rtol=1e-9,
                                           atol=1e-9 * np.abs(y).max(),
                                           err_msg=f"{name} chain {c}")
            else:
                assert np.linalg.norm(x - y) <= 1e-3 * np.linalg.norm(y), \
                    (name, c)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("runup", [True, False])
@pytest.mark.parametrize("tableau", ["dopri5", "rk4"])
def test_chunked_adjoint_matches_serial(dtype, runup, tableau):
    inputs, kw, g = _problem(dtype, runup, 3, tableau)
    assert len(kw["run_count"]) == 2
    assert kw["run_start"][1] % adj.L_CHUNK != 0    # a boundary inside a chunk
    got, ref, _ck = _both(inputs, kw, g)
    _close(got, ref, dtype, range(3))
    assert (got[0][[7, 8, 9, 10]] == 0).all()       # R and the reset rows
    assert (got[0][:7] != 0).any() and (got[3] != 0).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunked_adjoint_with_a_run_per_day(dtype):
    """Every (chunk, run) segment is one day: the per-run d(beta) of the
    chunked model are the serial sweep's, and they sum to the two-run ones."""
    inputs, kw, g = _problem(dtype, True, 2, per_day=True)
    got, ref, _ck = _both(inputs, kw, g)
    _close(got, ref, dtype, range(2))
    two_runs, kw2, _g = _problem(dtype, True, 2)
    whole = adj.fused_adjoint_chunked_reference(
        *two_runs[1:6], _both(two_runs, kw2, g)[2], g, two_runs[6], **kw2)[3]
    days = [r for r, c in enumerate(kw2["run_count"]) for _ in range(c)]
    summed = torch.zeros_like(whole).index_add_(0, torch.as_tensor(days),
                                                got[3])
    np.testing.assert_allclose(summed.double().numpy(), whole.double().numpy(),
                               rtol=1e-9 if dtype == torch.float64 else 1e-3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunked_adjoint_keeps_the_strict_fold_gate(dtype):
    """Age 1 of chain 0 never hospitalises (h = 0): its daily CumH incidence
    is exactly 0 on every observed day, where the fold's cotangent is gated
    by cv > 0 in both versions."""
    inputs, kw, g = _problem(dtype, True, 2)
    inputs[1][3, 1, 0] = 0.0
    got, ref, ck = _both(inputs, kw, g)
    assert (ck[1:, 8, 1, 0] == 0).all()             # the tie is reached
    _close(got, ref, dtype, range(2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunked_adjoint_nan_chain_stays_nan(dtype):
    inputs, kw, g = _problem(dtype, True, 3)
    inputs[3][0, 1] = float("nan")                  # chain 1's first beta
    got, ref, _ck = _both(inputs, kw, g)
    for a, b in zip(got, ref):
        assert torch.isnan(a[..., 1]).any() and torch.isnan(b[..., 1]).any()
    assert torch.isnan(got[3][:, 1]).all()
    _close(got, ref, dtype, [0, 2])


@pytest.mark.parametrize("runup", [True, False])
def test_plain_days_chain_into_the_plain_forward(runup):
    """The chunked model's forward: ``plain_days`` over one chunk after the
    other, each from the checkpoint, gives the next checkpoint to the bit
    and log-likelihood parts that sum to the whole."""
    inputs, kw, _g = _problem(torch.float64, runup, 2)
    y0, agevec, scal, beff, obs, valid, M = inputs
    ll, ck = adj.fused_forward_ckpt(*inputs, **kw)
    n = sum(kw["run_count"])
    total = torch.zeros_like(ll)
    for c in range(ck.shape[0]):
        part, y_end, none = sf.plain_days(
            ck[c], agevec, scal, beff, obs, valid, M, **kw,
            incidence=adj._strict_incidence,
            days=(c * adj.L_CHUNK, min((c + 1) * adj.L_CHUNK, n)))
        assert none == []
        if c + 1 < ck.shape[0]:
            np.testing.assert_array_equal(y_end.numpy(), ck[c + 1].numpy())
        total = total + part
    np.testing.assert_allclose(total.numpy(), ll.numpy(), rtol=1e-13)


@pytest.mark.parametrize("mode", [REFLECT, CLAMP])
def test_value_and_grad_with_chunked_adjoint_matches_jax(short_spain, mode,  # noqa: F811
                                                         monkeypatch):
    """``build_objective_fused_grad`` with the chunked model as K3 against
    the Pallas gradient engine in interpret mode, on the problem of
    tests/test_adjoint.py (65 intervals, 3 chunks, cash_karp@3, chains on
    their bounds)."""
    p = short_spain
    kw = dict(substeps=3, tableau="cash_karp", constraint_mode=mode)
    ll_p, g_p = build_objective_pallas_grad(
        p["space"], p["params"], p["data"], p["ts"], dtype=jnp.float64,
        block_b=4, interpret=True, **kw)(jnp.asarray(p["thetas"]))
    calls = []

    def chunked(*args, **kwargs):
        calls.append(args[5].shape[0])
        return adj.fused_adjoint_chunked_reference(*args, **kwargs)

    monkeypatch.setattr(adj, "fused_adjoint_reference", chunked)
    vg = build_objective_fused_grad(p["tspace"], p["tparams"], p["tdata"],
                                    p["ts"], device="cpu", **kw)
    ll_t, g_t = vg(torch.as_tensor(p["thetas"]))
    assert calls == [3]                             # the model ran, 3 chunks
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_p), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p), rtol=1e-9,
                               atol=1e-9)


def test_choose_regime_follows_chains_and_scratch():
    """Few chains take the chunk-parallel regime, many the single sweep;
    the rule counts (chain, chunk) blocks against the card's SMs, by value
    size, and a scratch over the cap sends any size to the sweep."""
    for elem in (4, 8):
        limit = adj.CHUNK_BLOCKS_PER_SM[elem] * 132 // 14
        assert adj.choose_regime(64, 14, 132, elem, 1 << 20) == 1
        assert adj.choose_regime(limit, 14, 132, elem, 1 << 20) == 1
        assert adj.choose_regime(limit + 1, 14, 132, elem, 1 << 20) == 2
        assert adj.choose_regime(8192, 14, 132, elem, 1 << 20) == 2
        assert adj.choose_regime(64, 14, 132, elem, adj.SCRATCH_CAP + 1) == 2
        assert adj.choose_regime(64, 14, 16, elem, 1 << 20) == 2  # a small card
    # the sizes timed on an H100 (132 SMs) on either side of the crossover
    for elem, wins, loses in ((4, 448, 512), (8, 320, 384)):
        assert adj.choose_regime(wins, 14, 132, elem, 1 << 20) == 1
        assert adj.choose_regime(loses, 14, 132, elem, 1 << 20) == 2
