"""The CUDA kernels K1 (fused objective), K2 (forward with checkpoints) and
K3 (adjoint) against their plain PyTorch versions.

This file imports nothing of JAX, so the card (which has no JAX) can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The tests marked ``cuda`` build the kernel with nvcc and launch it; they skip
where there is no card. ``python3 chip_smoke.py`` runs the same comparison at
full Spain-2020 width. The unmarked tests check, on the CPU, what surrounds
the kernel: input validation, dispatch by device, and the op count.

Tolerances: in float64 the kernel and the plain version differ only by FMA
contraction and summation order, rtol 1e-10 over a 35-day solve; in float32
the day terms are also summed in another order, rtol 2e-5 at these small
sizes (chip_smoke.py holds the full width, where the log-likelihood is
~1.4e6 and every reading on an H100 was below 1e-6, to 5e-6). K3's
gradients: in float64 rtol 1e-9 with an absolute floor of 1e-9 x the
largest entry of the chain (entries that cancel to ~0 keep only absolute
accuracy); in float32 each chain's gradient within 1e-3 of the plain one in
relative 2-norm (a reverse sweep over 54 days accumulates f32 rounding in
another order on each side).

K1 and K2 have two regimes (split: producer and consumer warps; wide: one
thread per (chain, age)). Each is forced and held to the same tolerances;
the two do the same operations in the same order, so they are also held
against each other far below those (float64 rtol 1e-13, float32 1e-6;
chip_smoke.py counts the bits that differ at full width).

Every kernel is built once per tableau (rk4, cash_karp, rkf45, dopri5,
fehlberg78), the tableau's zero pattern compiled in, and skips a zero
coefficient as the plain version does. At the stiff input of
``tests/torch_stiff.py``, where an FMA by zero would turn the state NaN, each
kernel in each regime equals the plain version at the same tolerances.
"""

import os
import sys

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch import make_params
from mmidv1_tpu_torch.calibration.objective import make_time_grid
from mmidv1_tpu_torch.calibration.param_space import REFLECT, ParameterSpace
from mmidv1_tpu_torch.data import CalibrationData
from mmidv1_tpu_torch.ops import build_objective_fused, sepaihrd_fused as sf
from mmidv1_tpu_torch.ops import sepaihrd_adjoint as adj
from mmidv1_tpu_torch.utils import trace

sys.path.insert(0, os.path.dirname(__file__))
import torch_stiff as stiff  # noqa: E402  (torch and NumPy only)
from reference_impl import spain_like_prm  # noqa: E402  (NumPy only)

torch.set_num_threads(1)
NAMES = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2", "kappa_2",
         "sigma"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run this file on the card, or python3 chip_smoke.py)")
    return torch.device("cuda")


def _new_launches(kernel, fn):
    """``(fn(), {(regime, tableau, chains): n})``: what ``fn`` added to the
    tracer's launches of ``kernel`` (``"k1"``, ``"k2"`` or ``"k3"``)."""
    before = trace.counts("launches", (kernel,))
    out = fn()
    return out, {k: n - before.get(k, 0)
                 for k, n in trace.counts("launches", (kernel,)).items()
                 if n != before.get(k, 0)}


def _objective(device, dtype, runup=True, n_days=35):
    """The tests/test_pallas.py problem (35 days, substeps=2, 8 names)."""
    prm = spain_like_prm()
    keys = ("beta", "beta_end_times", "beta_values", "kappa_end_times",
            "kappa_values", "a", "p", "h", "icu", "d_H", "d_ICU", "h_infec",
            "theta", "sigma", "gamma_p", "gamma_A", "gamma_I", "gamma_H",
            "gamma_ICU", "d_community", "seed_exposed")
    params = make_params(N=prm["N"], M_baseline=prm["M"],
                         runup_days=prm["runup_days"] if runup else 0.0,
                         **{k: prm[k] for k in keys}, dtype=dtype, device=device)
    rng = np.random.default_rng(9)
    obs = rng.poisson(6.0, size=(n_days, 4)).astype(float)
    obs_icu = obs * 0.2
    obs_icu[5, 2] = np.nan
    obs_d = obs * 0.1
    obs_d[7, 0] = -3.0
    data = CalibrationData.from_arrays(
        new_confirmed=obs, new_hospitalizations=obs, new_icu=obs_icu,
        new_deaths=obs_d, population_by_age=prm["N"],
        initial_cumulative_confirmed=[800.0] * 4,
        initial_cumulative_deaths=[4.0] * 4,
        initial_cumulative_hospitalizations=[25.0] * 4,
        initial_cumulative_icu=[5.0] * 4)
    bounds = {n: (0.01, 2.0) for n in NAMES}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(NAMES, bounds, {n: 0.05 for n in NAMES},
                                  params, dtype=dtype, device=device)
    ts = make_time_grid(prm["runup_days"] if runup else 0.0, n_days)
    ll = build_objective_fused(space, params, data, ts, substeps=2,
                               constraint_mode=REFLECT, dtype=dtype,
                               device=device)
    return ll, space.extract(params)


def _args(ll, theta0, B, seed):
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(0.05 * rng.standard_normal((B, theta0.numel())),
                            dtype=theta0.dtype, device=theta0.device)
    return ll.prep.kernel_args(theta0[None, :] + noise)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("tableau", ["dopri5", "cash_karp", "rkf45", "rk4",
                                     "fehlberg78"])
def test_kernel_matches_plain_version(cuda, dtype, rtol, tableau):
    for runup in (True, False):
        ll, theta0 = _objective(cuda, dtype, runup)
        for B in (1, 5, 37, 300):
            args, kw, _inf = _args(ll, theta0, B, B)
            kw = dict(kw, substeps=2, tableau=tableau)
            before = trace.total("launches", ("k1",))
            k = sf.fused_objective(*args, **kw)
            torch.cuda.synchronize()
            assert trace.total("launches", ("k1",)) == before + 1
            r = sf.fused_objective_reference(*args, **kw)
            assert torch.isfinite(k).all()
            np.testing.assert_allclose(k.double().cpu().numpy(),
                                       r.double().cpu().numpy(), rtol=rtol)


@pytest.mark.cuda
def test_kernel_rejects_mixed_inputs(cuda):
    ll, theta0 = _objective(cuda, torch.float32)
    args, kw, _inf = _args(ll, theta0, 4, 0)
    with pytest.raises(ValueError):
        sf.fused_objective(args[0].cpu(), *args[1:], **kw)
    with pytest.raises(ValueError):
        sf.fused_objective(args[0].double(), *args[1:], **kw)


def test_wrapper_dispatches_by_device_and_validates():
    """CPU tensors run the plain version (no launch is counted); malformed
    inputs raise before anything runs."""
    ll, theta0 = _objective("cpu", torch.float64)
    args, kw, _inf = _args(ll, theta0, 3, 1)
    before = trace.total("launches", ("k1",))
    out = sf.fused_objective(*args, **kw, substeps=2)
    assert trace.total("launches", ("k1",)) == before
    np.testing.assert_array_equal(
        out.numpy(), sf.fused_objective_reference(*args, **kw, substeps=2).numpy())
    y0, M = args[0], args[6]
    bad = [((y0.float(),) + args[1:], kw),                  # mixed dtypes
           ((y0[:, :, :2],) + args[1:], kw),               # wrong chain count
           ((y0.transpose(0, 1).contiguous().transpose(0, 1),) + args[1:], kw),
           (args[:6] + (np.eye(3),), kw),                   # contact matrix
           (args, dict(kw, run_count=kw["run_count"][:-1])),
           (args, dict(kw, runup_offset=kw["runup_offset"] + 1))]
    for a, k in bad:
        with pytest.raises((ValueError, TypeError)):
            sf.fused_objective(*a, **k, substeps=2)
    with pytest.raises(TypeError):
        sf.fused_objective(*(t.to(torch.int64) for t in args[:6]), M, **kw)


def test_op_count_tracks_tableau_work():
    n = sf.op_count("dopri5", 4, 325, 306)
    # 4 lanes x 325 intervals x (41 x 25 RHS + 20 x 25 axpys x 4) + folds
    assert n == 4 * (325 * (41 * 25 + 20 * 25 * 4) + 18 * 306)
    assert sf.op_count("cash_karp", 3, 325, 306) < n


def _per_chain_close(got, ref, dtype, what):
    """Gradient tensors (..., B): per chain, f64 rtol 1e-9 with an absolute
    floor of 1e-9 x max|ref|; f32 relative 2-norm <= 1e-3."""
    got = got.double().cpu().numpy().reshape(-1, got.shape[-1])
    ref = ref.double().cpu().numpy().reshape(-1, ref.shape[-1])
    assert np.isfinite(got).all(), what
    for b in range(ref.shape[1]):
        g, r = got[:, b], ref[:, b]
        if dtype == torch.float64:
            np.testing.assert_allclose(g, r, rtol=1e-9,
                                       atol=1e-9 * np.abs(r).max(),
                                       err_msg=f"{what} chain {b}")
        else:
            assert np.linalg.norm(g - r) <= 1e-3 * np.linalg.norm(r), \
                (what, b, np.linalg.norm(g - r) / np.linalg.norm(r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("tableau", ["dopri5", "cash_karp", "rkf45", "rk4",
                                     "fehlberg78"])
def test_forward_ckpt_matches_plain_version(cuda, dtype, rtol, tableau):
    """K2: the log-likelihood (also against K1) and the checkpoints."""
    for runup in (True, False):
        ll, theta0 = _objective(cuda, dtype, runup)
        for B in (1, 5, 37):
            args, kw, _inf = _args(ll, theta0, B, B)
            kw = dict(kw, substeps=2, tableau=tableau)
            before = trace.total("launches", ("k2",))
            k, ck = adj.fused_forward_ckpt(*args, **kw)
            torch.cuda.synchronize()
            assert trace.total("launches", ("k2",)) == before + 1
            r, rck = adj.fused_forward_ckpt_reference(*args, **kw)
            assert ck.shape == rck.shape == (adj.num_chunks(
                sum(kw["run_count"])), 10, 4, B)
            np.testing.assert_allclose(k.double().cpu().numpy(),
                                       r.double().cpu().numpy(), rtol=rtol)
            rck = rck.double().cpu().numpy()
            np.testing.assert_allclose(ck.double().cpu().numpy(), rck,
                                       rtol=rtol, atol=rtol * np.abs(rck).max())
            k1 = sf.fused_objective(*args, **kw)
            np.testing.assert_allclose(k.double().cpu().numpy(),
                                       k1.double().cpu().numpy(), rtol=rtol)


def _forward(kernel, regime, args, kw):
    """K1 (``(ll, None)``) or K2 (``(ll, ckpt)``) forced into ``regime``
    through its wrapper, the launch counted by regime."""
    fn = sf.fused_objective if kernel == "K1" else adj.fused_forward_ckpt
    out, new = _new_launches(kernel.lower(), lambda: fn(*args, **kw,
                                                        regime=regime))
    torch.cuda.synchronize()
    assert new == {(regime, kw["tableau"], args[0].shape[-1]): 1}
    return (out, None) if kernel == "K1" else out


def _close_forward(got, ref, rtol):
    np.testing.assert_allclose(got[0].double().cpu().numpy(),
                               ref[0].double().cpu().numpy(), rtol=rtol)
    if got[1] is not None:
        rck = ref[1].double().cpu().numpy()
        assert got[1].shape == ref[1].shape
        for row in range(rck.shape[1]):             # compartment by compartment
            np.testing.assert_allclose(
                got[1][:, row].double().cpu().numpy(), rck[:, row], rtol=rtol,
                atol=rtol * np.abs(rck[:, row]).max(), err_msg=f"row {row}")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("regime", [sf.SPLIT, sf.WIDE])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("tableau", ["dopri5", "cash_karp", "rkf45", "rk4",
                                     "fehlberg78"])
def test_forward_regimes_match_plain_version(cuda, kernel, regime, dtype, rtol,
                                             tableau):
    """Each regime of K1 and K2 forced: B = 1, B not a multiple of a warp's
    8 chains, several blocks; run-up and none; 55 intervals (3 chunks, the
    last of 7 days) and 34."""
    for runup in (True, False):
        ll, theta0 = _objective(cuda, dtype, runup)
        for B in (1, 5, 37, 300):
            args, kw, _inf = _args(ll, theta0, B, B)
            kw = dict(kw, substeps=2, tableau=tableau)
            got = _forward(kernel, regime, args, kw)
            assert torch.isfinite(got[0]).all()
            _close_forward(got, adj.fused_forward_ckpt_reference(*args, **kw),
                           rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13),
                                        (torch.float32, 1e-6)])
@pytest.mark.parametrize("tableau,substeps", [("dopri5", 4), ("cash_karp", 3),
                                              ("rk4", 1), ("fehlberg78", 2)])
def test_forward_regimes_agree_and_keep_a_nan_chain(cuda, kernel, dtype, rtol,
                                                    tableau, substeps):
    """Split against wide, and a NaN chain (its first beta): NaN from both
    regimes, every other chain's bits as without it."""
    ll, theta0 = _objective(cuda, dtype, True, 50)
    args, kw, _inf = _args(ll, theta0, 21, 4)
    kw = dict(kw, substeps=substeps, tableau=tableau)
    clean = {r: _forward(kernel, r, args, kw) for r in (sf.SPLIT, sf.WIDE)}
    _close_forward(clean[sf.SPLIT], clean[sf.WIDE], rtol)
    args[3][0, 9] = float("nan")
    keep = [c for c in range(21) if c != 9]
    for regime, ref in clean.items():
        got = _forward(kernel, regime, args, kw)
        assert torch.isnan(got[0][9]) and torch.isfinite(got[0][keep]).all()
        assert torch.equal(got[0][keep], ref[0][keep])
        if got[1] is not None:
            assert torch.isnan(got[1][1:, :5, :, 9]).all()
            assert torch.equal(got[1][..., keep], ref[1][..., keep])


@pytest.mark.cuda
def test_forward_rule_picks_and_counts(cuda):
    """No regime given: the rule's pick runs and is counted, also at the
    split regime's largest ring (fehlberg78 in float64)."""
    ll, theta0 = _objective(cuda, torch.float64)
    args, kw, _inf = _args(ll, theta0, 12, 2)
    kw = dict(kw, substeps=2, tableau="fehlberg78")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    picked = sf.choose_forward_regime(12, sms)
    ref = adj.fused_forward_ckpt_reference(*args, **kw)
    for kernel, fn in (("K1", sf.fused_objective), ("K2", adj.fused_forward_ckpt)):
        got, new = _new_launches(kernel.lower(), lambda: fn(*args, **kw))
        assert new == {(picked, "fehlberg78", 12): 1}
        _close_forward((got, None) if kernel == "K1" else got, ref, 1e-10)


def _adjoint(regime, agevec, scal, beff, obs, valid, ck, g, M, kw):
    """K3 through its wrapper (``regime`` None: the rule picks, and the call
    is counted) or forced into a regime through the launcher."""
    if regime is None:
        got, new = _new_launches("k3", lambda: adj.fused_adjoint(
            agevec, scal, beff, obs, valid, ck, g, M, **kw))
        ((regime, tableau, B), n), = new.items()
        assert n == 1 and regime in (1, 2)
        assert (tableau, B) == (kw["tableau"], g.shape[0])
        return got
    got, used, n_kernels = adj._launch_adjoint(agevec, scal, beff, obs, valid,
                                               ck, g, M, regime=regime, **kw)
    assert used == regime and n_kernels >= 2
    return got


def _check_adjoint(cuda, dtype, tableau, regime, runup, n_days, B):
    ll, theta0 = _objective(cuda, dtype, runup, n_days)
    (y0, agevec, scal, beff, obs, valid, M), kw, _inf = _args(ll, theta0, B, B)
    kw = dict(kw, substeps=2, tableau=tableau)
    _k, ck = adj.fused_forward_ckpt(y0, agevec, scal, beff, obs, valid, M, **kw)
    g = torch.as_tensor(np.random.default_rng(B).uniform(0.5, 1.5, B),
                        dtype=dtype, device=cuda)
    got = _adjoint(regime, agevec, scal, beff, obs, valid, ck, g, M, kw)
    torch.cuda.synchronize()
    ref = adj.fused_adjoint_reference(agevec, scal, beff, obs, valid, ck, g, M,
                                      **kw)
    for name, a, b in zip(("dy0", "dagevec", "dscal", "dbeff"), got, ref):
        assert a.shape == b.shape
        _per_chain_close(a, b, dtype, f"{tableau} {name} B={B}")
    assert (got[0][[7, 8, 9, 10]] == 0).all()   # R; reset rows
    return ck.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("regime", [None, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tableau", ["dopri5", "cash_karp", "rkf45", "rk4",
                                     "fehlberg78"])
def test_adjoint_matches_plain_version(cuda, dtype, tableau, regime):
    """K3: all four gradient outputs against autograd through the plain
    forward, with and without run-up, for a random cotangent, in the regime
    the rule picks and in each regime forced."""
    for runup in (True, False):
        for B in (1, 5, 37):
            _check_adjoint(cuda, dtype, tableau, regime, runup, 35, B)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", [1, 2])
@pytest.mark.parametrize("runup,n_days,chunks", [(True, 30, 3), (False, 20, 1)])
def test_adjoint_ragged_and_single_chunk(cuda, regime, runup, n_days, chunks):
    """50 intervals (the last chunk holds 2 days) and 20 (one chunk only)."""
    for dtype in (torch.float64, torch.float32):
        assert _check_adjoint(cuda, dtype, "dopri5", regime, runup, n_days,
                              7) == chunks


@pytest.mark.cuda
@pytest.mark.parametrize("regime", [None, 1, 2])
def test_adjoint_sums_beta_per_run(cuda, regime):
    """K3's per-run d(beta) equals the sum over the run's days of the
    per-day d(beta) (one schedule run per day), in every regime."""
    ll, theta0 = _objective(cuda, torch.float64)
    (y0, agevec, scal, beff, obs, valid, M), kw, _inf = _args(ll, theta0, 6, 3)
    kw = dict(kw, substeps=2, tableau="dopri5")
    _k, ck = adj.fused_forward_ckpt(y0, agevec, scal, beff, obs, valid, M, **kw)
    g = torch.ones(6, dtype=torch.float64, device=cuda)
    dbeff = _adjoint(regime, agevec, scal, beff, obs, valid, ck, g, M, kw)[3]
    days = [r for r, c in enumerate(kw["run_count"]) for _ in range(c)]
    n = len(days)
    kw_day = dict(kw, run_start=tuple(range(n)), run_count=(1,) * n)
    dday = _adjoint(regime, agevec, scal, beff[days].contiguous(), obs, valid,
                    ck, g, M, kw_day)[3]
    summed = torch.zeros_like(dbeff).index_add_(0, torch.as_tensor(
        days, device=cuda), dday)
    np.testing.assert_allclose(dbeff.cpu().numpy(), summed.cpu().numpy(),
                               rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-5)])
def test_kernels_match_plain_at_the_stiff_input(cuda, dtype, rtol):
    """The stiff input (``tests/torch_stiff.py``): dopri5's discarded last
    stage overflows on the last interval. K1 and K2 in each regime, and K3
    in each regime, equal their plain versions there, every value finite;
    the objective is finite, not ``finfo.min``."""
    ll, thetas = stiff.stiff_objective(dtype, cuda)
    args, kw, _inf = ll.prep.kernel_args(thetas)
    kw = dict(kw, substeps=stiff.SUBSTEPS, tableau=stiff.TABLEAU)
    ref = adj.fused_forward_ckpt_reference(*args, **kw)
    assert torch.isfinite(ref[0]).all() and torch.isfinite(ref[1]).all()
    for kernel in ("K1", "K2"):
        for regime in (sf.SPLIT, sf.WIDE):
            got = _forward(kernel, regime, args, kw)
            assert torch.isfinite(got[0]).all(), (kernel, regime)
            _close_forward(got, ref, rtol)
    assert (ll(thetas) > -1e30).all()
    y0, agevec, scal, beff, obs, valid, M = args
    g = torch.ones(thetas.shape[0], dtype=dtype, device=cuda)
    want = adj.fused_adjoint_reference(agevec, scal, beff, obs, valid, ref[1],
                                       g, M, **kw)
    for regime in (1, 2):
        got = _adjoint(regime, agevec, scal, beff, obs, valid, ref[1], g, M, kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("dy0", "dagevec", "dscal", "dbeff"), got, want):
            _per_chain_close(a, b, dtype, f"stiff {name} regime {regime}")
