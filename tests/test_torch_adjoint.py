"""The port's gradient path against the JAX package, in float64 on the CPU.

- ``build_objective_fused_grad`` (K2/K3's plain versions through
  ``FusedObjectiveFn``, since the inputs lie on the CPU) against both
  ``build_objective_pallas_grad(interpret=True)`` and ``jax.value_and_grad``
  of ``build_objective``, on the tests/test_adjoint.py problem (real config,
  45 observed days, cash_karp@3): LL rtol 1e-12, gradient rtol/atol 1e-9 —
  the bars the Pallas adjoint meets against XLA.
- ``torch.autograd`` of the eager objective against ``jax.grad`` with a
  coordinate on a bound: a clamp's gradient at a tie is split 1/2 : 1/2 by
  ``jnp.clip`` / ``jnp.maximum``, so the port must split it too (rtol 1e-12).
- K3's plain version against autograd of K1's plain version, and its per-run
  beta sums against a one-run-per-day schedule.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.objective import build_objective, make_time_grid
from mmidv1_tpu.calibration.param_space import CLAMP, REFLECT, ParameterSpace
from mmidv1_tpu.data import (CalibrationData, read_param_bounds,
                             read_params_to_calibrate, read_proposal_sigmas,
                             read_sepaihrd_parameters)
from mmidv1_tpu.data.contact_matrix import read_matrix_from_csv
from mmidv1_tpu.ops import build_objective_pallas_grad

from mmidv1_tpu_torch.calibration.objective import \
    build_objective as t_build_objective
from mmidv1_tpu_torch.calibration.nuts import value_and_grad_of
from mmidv1_tpu_torch.data import CalibrationData as TCalibrationData
from mmidv1_tpu_torch.ops import build_objective_fused_grad
from mmidv1_tpu_torch.ops import sepaihrd_adjoint as adj
from mmidv1_tpu_torch.ops import sepaihrd_fused as sf
from mmidv1_tpu_torch.utils import trace

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402
from test_torch_objective import _data_pair  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def short_spain():
    """tests/test_adjoint.py's problem: the real configuration, 45 observed
    days (crossing the run-up boundary and two schedule breaks), 4 chains
    near the initial guess; chain 3 has beta_1 exactly on its lower bound
    and chain 2 theta exactly on its upper bound."""
    cfg = os.path.join(REPO, "data", "configuration")
    csv = os.path.join(REPO, "data", "processed", "processed_data.csv")
    data = CalibrationData.from_csv(csv, "2020-03-01", "2020-04-14")
    tdata = TCalibrationData.from_csv(csv, "2020-03-01", "2020-04-14")
    M = read_matrix_from_csv(os.path.join(REPO, "data", "contacts.csv"), 4, 4)
    params = read_sepaihrd_parameters(
        os.path.join(cfg, "initial_guess.txt"), 4,
        N=data.population_by_age, M_baseline=M, dtype=jnp.float64)
    space = ParameterSpace.create(
        read_params_to_calibrate(os.path.join(cfg, "params_to_calibrate.txt")),
        read_param_bounds(os.path.join(cfg, "param_bounds.txt")),
        read_proposal_sigmas(os.path.join(cfg, "proposal_sigmas.txt")),
        params)
    ts = make_time_grid(float(np.asarray(params.runup_days)),
                        data.n_data_points)
    theta0 = np.asarray(space.extract(params))
    rng = np.random.default_rng(0)
    thetas = theta0[None] + 0.02 * np.asarray(space.sigmas) * \
        rng.standard_normal((4, space.dim))
    thetas[3, space.names.index("beta_1")] = float(space.lower[0])
    i = space.names.index("theta")
    thetas[2, i] = float(space.upper[i])
    tparams = to_torch_params(params)
    return dict(space=space, params=params, data=data, tdata=tdata, ts=ts,
                thetas=thetas, tparams=tparams,
                tspace=to_torch_space(space, tparams))


@pytest.mark.parametrize("mode", [REFLECT, CLAMP])
def test_value_and_grad_matches_jax(short_spain, mode):
    p = short_spain
    kw = dict(substeps=3, tableau="cash_karp", constraint_mode=mode)
    loglik = build_objective(p["space"], p["params"], p["data"], p["ts"],
                             dtype=jnp.float64, **kw)
    thetas = jnp.asarray(p["thetas"])
    ll_x, g_x = jax.jit(jax.vmap(jax.value_and_grad(loglik)))(thetas)
    ll_p, g_p = build_objective_pallas_grad(
        p["space"], p["params"], p["data"], p["ts"], dtype=jnp.float64,
        block_b=4, interpret=True, **kw)(thetas)
    vg = build_objective_fused_grad(p["tspace"], p["tparams"], p["tdata"],
                                    p["ts"], device="cpu", **kw)
    ll_t, g_t = vg(torch.as_tensor(p["thetas"]))
    assert vg.calls == 1
    assert torch.isfinite(g_t).all() and (g_t != 0).any(dim=1).all()
    for ll_j, g_j in ((ll_x, g_x), (ll_p, g_p)):
        np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-12)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-9,
                                   atol=1e-9)
    # the value alone goes through K1's path and agrees
    np.testing.assert_allclose(
        vg.value_batch(torch.as_tensor(p["thetas"])).numpy(), ll_t.numpy(),
        rtol=1e-12)


@pytest.fixture(scope="module")
def small(spain_params):
    """tests/test_torch_calibration.py's problem (35 days, substeps 2)."""
    prm, params = spain_params
    data, tdata = _data_pair(prm, 35)
    ts = make_time_grid(prm["runup_days"], 35)
    names = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2",
             "kappa_2", "sigma"]
    bounds = {n: (0.01, 2.0) for n in names}
    bounds["seed_exposed"] = (1.0, 500.0)
    space = ParameterSpace.create(names, bounds, {n: 0.05 for n in names},
                                  params)
    tparams = to_torch_params(params)
    return dict(space=space, params=params, data=data, tdata=tdata, ts=ts,
                tparams=tparams, tspace=to_torch_space(space, tparams))


@pytest.mark.parametrize("mode,on_bound", [(CLAMP, True), (CLAMP, False),
                                           (REFLECT, True), (REFLECT, False)])
def test_eager_objective_grad_matches_jax_at_ties(small, mode, on_bound):
    """torch.autograd of the eager objective == jax.grad, with beta_1
    exactly on its lower bound (a clamp tie) or inside the box. Before the
    clamps were written as maximum/minimum, CLAMP on the bound gave exactly
    twice the JAX gradient."""
    p = small
    theta = np.array(p["space"].extract(p["params"]), dtype=np.float64)
    theta[0] = 0.01 if on_bound else 0.3
    j = jax.grad(build_objective(p["space"], p["params"], p["data"], p["ts"],
                                 substeps=2, constraint_mode=mode))(
        jnp.asarray(theta))
    te = t_build_objective(p["tspace"], p["tparams"], p["tdata"], p["ts"],
                           substeps=2, constraint_mode=mode, device="cpu")
    ll, g = value_and_grad_of(te)(torch.as_tensor(theta)[None, :])
    assert np.isfinite(float(ll[0]))
    np.testing.assert_allclose(g[0].numpy(), np.asarray(j), rtol=1e-12)


def _kernel_args(p, B, seed, runup=True):
    ll = sf.build_objective_fused(p["tspace"], p["tparams"], p["tdata"],
                                  p["ts"], substeps=2, constraint_mode=REFLECT,
                                  device="cpu")
    theta0 = p["tspace"].extract(p["tparams"])
    rng = np.random.default_rng(seed)
    th = theta0[None, :] + torch.as_tensor(
        0.05 * rng.standard_normal((B, theta0.numel())))
    args, kw, _inf = ll.prep.kernel_args(th)
    return args, dict(kw, substeps=2, tableau="dopri5")


def test_plain_adjoint_matches_autograd_of_plain_objective(small):
    """K3's plain version == autograd through K1's plain version (the two
    differ only in the fold's gradient gate at cv == 0, which these inputs
    never reach); dy0's R and reset rows are zero."""
    B = 3
    (y0, agevec, scal, beff, obs, valid, M), kw = _kernel_args(small, B, 1)
    ll, ck = adj.fused_forward_ckpt(y0, agevec, scal, beff, obs, valid, M,
                                    **kw)
    n_int = sum(kw["run_count"])
    assert ck.shape == (adj.num_chunks(n_int), 10, 4, B)
    np.testing.assert_array_equal(ck[0].numpy(), y0[sf._CARRIED].numpy())
    np.testing.assert_array_equal(
        ll.numpy(), sf.fused_objective(y0, agevec, scal, beff, obs, valid, M,
                                       **kw).numpy())
    g = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    got = adj.fused_adjoint(agevec, scal, beff, obs, valid, ck, g, M, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (y0, agevec, scal, beff)]
    ref = torch.autograd.grad(
        sf.fused_objective_reference(*leaves, obs, valid, M, **kw), leaves,
        grad_outputs=g)
    for a, b, shape in zip(got, ref, [(11, 4, B), (8, 4, B), (7, B),
                                      (len(kw["run_count"]), B)]):
        assert a.shape == shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))
    assert (got[0][[7, 8, 9, 10]] == 0).all()
    assert (got[0][:7] != 0).any() and (got[3] != 0).all()


def test_plain_adjoint_sums_beta_per_run(small):
    """d(beta) per schedule run == the sum over its days of the per-day
    d(beta) of a one-run-per-day schedule."""
    (y0, agevec, scal, beff, obs, valid, M), kw = _kernel_args(small, 2, 2)
    _ll, ck = adj.fused_forward_ckpt(y0, agevec, scal, beff, obs, valid, M,
                                     **kw)
    g = torch.ones(2, dtype=torch.float64)
    dbeff = adj.fused_adjoint(agevec, scal, beff, obs, valid, ck, g, M, **kw)[3]
    days = [r for r, c in enumerate(kw["run_count"]) for _ in range(c)]
    n = len(days)
    dday = adj.fused_adjoint(agevec, scal, beff[days].contiguous(), obs, valid,
                             ck, g, M, **dict(kw, run_start=tuple(range(n)),
                                              run_count=(1,) * n))[3]
    summed = torch.zeros_like(dbeff).index_add_(0, torch.as_tensor(days), dday)
    np.testing.assert_allclose(dbeff.numpy(), summed.numpy(), rtol=1e-12)


def test_adjoint_wrappers_dispatch_and_validate(small):
    """CPU tensors run the plain versions (no launch counted); malformed
    inputs raise before anything runs."""
    (y0, agevec, scal, beff, obs, valid, M), kw = _kernel_args(small, 2, 3)
    launches = lambda: (trace.total("launches", ("k2",)),
                        trace.total("launches", ("k3",)))
    before = launches()
    _ll, ck = adj.fused_forward_ckpt(y0, agevec, scal, beff, obs, valid, M,
                                     **kw)
    g = torch.ones(2, dtype=torch.float64)
    adj.fused_adjoint(agevec, scal, beff, obs, valid, ck, g, M, **kw)
    assert launches() == before
    bad = [dict(g=g[:1]), dict(ckpt=ck[1:]), dict(g=g.float()),
           dict(agevec=agevec.transpose(1, 2).contiguous().transpose(1, 2))]
    base = dict(agevec=agevec, scal=scal, beff=beff, obs=obs, valid=valid,
                ckpt=ck, g=g)
    for change in bad:
        a = dict(base, **change)
        with pytest.raises((ValueError, TypeError)):
            adj.fused_adjoint(a["agevec"], a["scal"], a["beff"], a["obs"],
                              a["valid"], a["ckpt"], a["g"], M, **kw)
    with pytest.raises(ValueError):
        adj.fused_adjoint(agevec, scal, beff, obs, valid, ck, g, M,
                          **dict(kw, substeps=adj.MAX_SUBSTEPS + 1))
    with pytest.raises(ValueError):
        adj.fused_forward_ckpt(y0, agevec, scal, beff[:1], obs, valid, M, **kw)


def test_op_count_adjoint_tracks_tableau_work():
    c = adj.op_count_adjoint("dopri5", 4, 325, 306)
    assert c["fwd"] == sf.op_count("dopri5", 4, 325, 306)
    # the function: a phase 1 day (FSAL: 25 RHS, 25 coefficients x 4
    # substeps) and 4 transposed substeps (6 live stages x (95 + 10), 20
    # stage and 5 update coefficients; the last stage of dopri5 is dead:
    # b_6 = 0 and no stage reads it) per day, 18 per observed day
    day = 41 * 25 + 20 * 25 * 4
    per_lane = 325 * (day + 4 * (6 * 105 + 20 * 20 + 10 * 5)) + 18 * 306
    assert c["bwd"] == 4 * per_lane
    # as built, by regime: the stage inputs again per substep (6 RHS, 20
    # stage coefficients) and 7-row transposes of the 6 live stages (6 x
    # (95 + 7), 14 per stage and 10 per update coefficient) once (regime
    # 2); or the stage inputs with their 6 contact matvecs (11 each) and 29
    # transposes without them (regime 1), plus the 14 chunk maps of 67 rows
    # and the 20 (chunk, run) segments
    stage_inputs = 41 * 6 + 20 * 20
    axpys7 = 7 * 6 + 14 * 20 + 10 * 5
    design = {1: 325 * (day + 4 * (stage_inputs + 6 * 95 + axpys7)) + 18 * 306,
              29: 325 * (day + 4 * (stage_inputs + 6 * 11
                                    + 29 * (6 * 84 + axpys7))) + 18 * 306}
    c7 = adj.op_count_adjoint("dopri5", 4, 325, 306, n_runs=7)
    assert c7["bwd"] == c["bwd"]
    assert c7["bwd_design"] == {2: 4 * design[1],
                                1: 4 * design[29] + 57 * (14 * 67 + 14 + 6)}
    assert 2 < c["bwd"] / c["fwd"] < 3 < c7["bwd_design"][2] / c["fwd"] < 4
    assert 14 < c7["bwd_design"][1] / c["bwd"] < 29
    cheap = adj.op_count_adjoint("cash_karp", 3, 325, 306)
    assert cheap["bwd"] < c["bwd"]
    assert all(cheap["bwd_design"][r] < c["bwd_design"][r] for r in (1, 2))
