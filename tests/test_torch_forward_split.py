"""The forward kernels' split regime as a plain PyTorch model, on the CPU.

K1 and K2 run few chains with the model's cascade split over two warps: a
producer integrates S E P A I alone and hands over the stage inputs of I, a
consumer integrates H ICU D CumH CumICU from them, resets, folds and sums.
``plain_forward_split`` is that design in eager PyTorch. Every row sees the
same operations in the same order as in ``plain_forward``, so the two must
agree **bit for bit** (no tolerance): log-likelihood and every checkpoint,
float64 and float32, for rk4, cash_karp, dopri5 (FSAL) and fehlberg78, with
and without run-up, with chunk edges inside the days and on the last day, and
with a NaN chain, which must stay NaN and leave its neighbours' bits alone.

Through the unchanged wrappers, with the split model in the plain version's
place, the port still matches the JAX package at its bars: the objective
``jax.vmap(build_objective)`` and ``build_objective_pallas(interpret=True)``
at rtol 1e-12 in float64 (both sides run the same float64 arithmetic and
differ in summation order only; tests/test_torch_objective.py), the gradient
path ``build_objective_pallas_grad`` at rtol/atol 1e-9
(tests/test_torch_adjoint.py). The rule that picks a regime is pure Python
and is checked here too.
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
from mmidv1_tpu_torch.utils import trace

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_adjoint import short_spain  # noqa: E402,F401  (fixture)
from test_torch_kernels import _args, _objective  # noqa: E402
from test_torch_objective import (_check_all, _engines,  # noqa: E402,F401
                                  _thetas, setup)

torch.set_num_threads(1)
TABLEAUS = ["rk4", "cash_karp", "dopri5", "fehlberg78"]
# (observed days, run-up, chains, substeps)
CASES = [(30, True, 3, 2), (30, False, 8, 2), (50, True, 8, 1),
         (50, False, 3, 3)]


def _inputs(dtype, n_days, runup, B, substeps, tableau):
    """Kernel inputs of the problem of tests/test_torch_kernels.py at
    ``n_days`` observed days, thetas from a numpy seed."""
    ll, theta0 = _objective("cpu", dtype, runup, n_days)
    args, kw, _inf = _args(ll, theta0, B, 100 + B)
    return list(args), dict(kw, substeps=substeps, tableau=tableau)


def _edge_chunk(n):
    """A chunk length that puts a checkpoint edge on the last day's end."""
    return next(d for d in range(5, n + 1) if n % d == 0)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tableau", TABLEAUS)
@pytest.mark.parametrize("n_days,runup,B,substeps", CASES)
def test_split_model_equals_plain_forward_bit_for_bit(dtype, tableau, n_days,
                                                      runup, B, substeps):
    args, kw = _inputs(dtype, n_days, runup, B, substeps, tableau)
    n = sum(kw["run_count"])
    assert n == n_days - 1 + kw["runup_offset"]
    assert (kw["runup_offset"] > 0) == runup
    for chunk in (0, adj.L_CHUNK, _edge_chunk(n)):
        ll, ck = sf.plain_forward(*args, **kw, chunk=chunk)
        ll_s, ck_s = sf.plain_forward_split(*args, **kw, chunk=chunk)
        assert torch.isfinite(ll).all()
        _same_bits(ll_s, ll)
        if chunk:
            assert ck.shape == (-(-n // chunk), 10, 4, B)
            _same_bits(ck_s, ck)
        else:
            assert ck is None and ck_s is None
    assert n % adj.L_CHUNK != 0 and n % _edge_chunk(n) == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tableau", ["dopri5", "cash_karp"])
def test_split_references_equal_the_plain_versions(dtype, tableau):
    """K1's and K2's split models against the plain versions the wrappers
    run on the CPU (K2's with the strict incidence gate and L_CHUNK)."""
    args, kw = _inputs(dtype, 30, True, 3, 2, tableau)
    _same_bits(sf.fused_objective_split_reference(*args, **kw),
               sf.fused_objective(*args, **kw))
    ll, ck = adj.fused_forward_ckpt(*args, **kw)
    ll_s, ck_s = adj.fused_forward_ckpt_split_reference(*args, **kw)
    _same_bits(ll_s, ll)
    _same_bits(ck_s, ck)
    assert ck.shape[0] == adj.num_chunks(sum(kw["run_count"])) == 3


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("where", ["upstream", "downstream"])
def test_split_model_nan_chain_stays_nan(dtype, where):
    """A NaN in chain 1 (its first beta: the producer's rows; its gamma_H:
    the consumer's alone) comes out NaN and moves no other chain's bits."""
    args, kw = _inputs(dtype, 30, True, 3, 2, "dopri5")
    clean, ck_clean = sf.plain_forward_split(*args, **kw, chunk=adj.L_CHUNK)
    if where == "upstream":
        args[3][0, 1] = float("nan")
    else:
        args[2][5, 1] = float("nan")
    ll, ck = sf.plain_forward(*args, **kw, chunk=adj.L_CHUNK)
    ll_s, ck_s = sf.plain_forward_split(*args, **kw, chunk=adj.L_CHUNK)
    assert torch.isnan(ll_s[1]) and torch.isnan(ck_s[1:, :, :, 1]).any()
    _same_bits(ll_s, ll)
    _same_bits(ck_s, ck)
    _same_bits(ll_s[[0, 2]], clean[[0, 2]])
    _same_bits(ck_s[..., [0, 2]], ck_clean[..., [0, 2]])
    if where == "downstream":      # S E P A I never see the consumer's rows
        _same_bits(ck_s[:, :5], ck_clean[:, :5])


@pytest.mark.parametrize("runup", [True, False])
@pytest.mark.parametrize("B", [1, 7])
def test_objective_with_split_model_matches_jax(setup, runup, B,  # noqa: F811
                                                monkeypatch):
    """``build_objective_fused`` with the split model as K1's plain version
    against both JAX engines, float64, rtol 1e-12."""
    params, data, tdata, ts, space = setup
    if not runup:
        from mmidv1_tpu.calibration.objective import make_time_grid
        params = params.replace(runup_days=jnp.zeros_like(params.runup_days))
        ts = make_time_grid(0.0, data.n_data_points)
    calls = []

    def split(*args, **kw):
        calls.append(args[0].shape[-1])
        return sf.fused_objective_split_reference(*args, **kw)

    monkeypatch.setattr(sf, "fused_objective_reference", split)
    eng = _engines(params, data, tdata, ts, space)
    a = _check_all(eng, _thetas(space, params, B, 40 + B))
    assert calls == [B] and np.isfinite(a).all()


@pytest.mark.parametrize("mode", [REFLECT, CLAMP])
def test_value_and_grad_with_split_model_matches_jax(short_spain, mode,  # noqa: F811
                                                     monkeypatch):
    """``build_objective_fused_grad`` with the split model as K2's plain
    version against the Pallas gradient engine in interpret mode (65
    intervals, 3 chunks, cash_karp@3, chains on their bounds): LL rtol
    1e-12, gradient rtol/atol 1e-9."""
    p = short_spain
    kw = dict(substeps=3, tableau="cash_karp", constraint_mode=mode)
    ll_p, g_p = build_objective_pallas_grad(
        p["space"], p["params"], p["data"], p["ts"], dtype=jnp.float64,
        block_b=4, interpret=True, **kw)(jnp.asarray(p["thetas"]))
    calls = []

    def split(*args, **kwargs):
        out = adj.fused_forward_ckpt_split_reference(*args, **kwargs)
        calls.append(out[1].shape[0])
        return out

    monkeypatch.setattr(adj, "fused_forward_ckpt_reference", split)
    vg = build_objective_fused_grad(p["tspace"], p["tparams"], p["tdata"],
                                    p["ts"], device="cpu", **kw)
    ll_t, g_t = vg(torch.as_tensor(p["thetas"]))
    assert calls == [3]                             # the model ran, 3 chunks
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_p), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_p), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("sm_count", [132, 16])
def test_choose_forward_regime_follows_chains_and_card(sm_count):
    """Few chains an SM take the split regime, many the wide one; the switch
    scales with the card's SMs."""
    limit = sf.SPLIT_CHAINS_PER_SM * sm_count
    assert sf.choose_forward_regime(1, sm_count) == sf.SPLIT
    assert sf.choose_forward_regime(limit, sm_count) == sf.SPLIT
    assert sf.choose_forward_regime(limit + 1, sm_count) == sf.WIDE
    # the shapes the entry points run on an H100, and the bench's width
    assert sf.choose_forward_regime(64, 132) == sf.SPLIT
    assert sf.choose_forward_regime(1024, 132) == sf.SPLIT
    assert sf.choose_forward_regime(8192, 132) == sf.WIDE
    # the sizes timed on either side of the crossover there
    assert sf.choose_forward_regime(2048, 132) == sf.SPLIT
    assert sf.choose_forward_regime(3072, 132) == sf.WIDE


@pytest.mark.parametrize("regime", [0, 3, "split", 1.5])
def test_wrappers_reject_an_unknown_regime(regime):
    args, kw = _inputs(torch.float64, 30, True, 2, 2, "rk4")
    with pytest.raises(ValueError, match="regime"):
        sf.fused_objective(*args, **kw, regime=regime)
    with pytest.raises(ValueError, match="regime"):
        adj.fused_forward_ckpt(*args, **kw, regime=regime)


@pytest.mark.parametrize("regime", [None, sf.SPLIT, sf.WIDE])
def test_wrappers_on_the_cpu_run_the_plain_version_in_any_regime(regime):
    """A regime is the card's matter: CPU tensors run the plain version, no
    launch is counted."""
    args, kw = _inputs(torch.float64, 30, False, 2, 2, "rk4")
    before = trace.snapshot()["counters"].get("launches", {})
    _same_bits(sf.fused_objective(*args, **kw, regime=regime),
               sf.fused_objective_reference(*args, **kw))
    ll, ck = adj.fused_forward_ckpt(*args, **kw, regime=regime)
    ref = adj.fused_forward_ckpt_reference(*args, **kw)
    _same_bits(ll, ref[0])
    _same_bits(ck, ref[1])
    assert trace.snapshot()["counters"].get("launches", {}) == before


def test_launch_constants_are_made_once():
    """The host constants and the schedule check are kept per distinct
    (tableau, substeps, schedule, M): a second call gets the same arrays."""
    args, kw = _inputs(torch.float64, 30, True, 2, 2, "dopri5")
    M = args[6]
    spec = ("dopri5", 2, M, kw["run_start"], kw["run_count"])
    first = sf.host_consts(*spec)
    assert all(x is y for x, y in zip(first, sf.host_consts(*spec)))
    assert sf.host_consts("dopri5", 2, np.array(M) * 2.0, *spec[3:])[4] \
        is not first[4]
    S, fsal, a, b, m, rs, rc = first
    assert (S, fsal) == (7, 1) and list(rs) == list(kw["run_start"])
    np.testing.assert_array_equal(np.array(m).reshape(4, 4), np.asarray(M))
    assert a[7] == 0.5 * (1.0 / 5.0)            # h * a[1][0] of dopri5
    hits = sf._check_schedule.cache_info().hits
    for _ in range(2):
        sf.check_schedule(M, kw["run_start"], kw["run_count"],
                          kw["runup_offset"], 2, args[4].shape[0])
    assert sf._check_schedule.cache_info().hits >= hits + 1
    with pytest.raises(ValueError):
        sf.check_schedule(M, kw["run_start"], kw["run_count"],
                          kw["runup_offset"] + 1, 2, args[4].shape[0])


def test_chain_bound_counts():
    """8125 dependent stages at Spain size (325 days of dopri5@4, FSAL), and
    the chain in cycles a stage by value size: the loop from lam to lam is
    17 arithmetic instructions and a shuffle over two stages."""
    assert sf.dependent_stages("dopri5", 4, 325) == 325 * (1 + 4 * 6) == 8125
    assert sf.dependent_stages("cash_karp", 3, 325) == 325 * 3 * 6
    assert sf.chain_cycles(4) == (17 * 4 + 24) / 2 == 46
    assert sf.chain_cycles(8) == (17 * 8 + 24) / 2 == 80
