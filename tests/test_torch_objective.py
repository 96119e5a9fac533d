"""The PyTorch port's objective against the JAX package, in float64 on the CPU.

Mirrors tests/test_pallas.py (35 days, substeps=2, 8 names): the port's
``build_objective_fused`` (through the kernel's plain version, since the
inputs lie on the CPU) and its eager ``build_objective`` must each match both
``jax.vmap(build_objective)`` and ``build_objective_pallas(interpret=True)``
at rtol 1e-12 — the bar the Pallas kernel itself meets against XLA; both
sides run the same float64 arithmetic and differ only in summation order.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.objective import build_objective, make_time_grid
from mmidv1_tpu.calibration.param_space import REFLECT, ParameterSpace
from mmidv1_tpu.data import CalibrationData
from mmidv1_tpu.ops import build_objective_pallas

from mmidv1_tpu_torch.calibration.objective import \
    build_objective as t_build_objective
from mmidv1_tpu_torch.data import CalibrationData as TCalibrationData
from mmidv1_tpu_torch.ops import build_objective_fused

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data_pair(prm, n_days):
    rng = np.random.default_rng(9)
    obs = rng.poisson(6.0, size=(n_days, 4)).astype(float)
    obs_icu = obs * 0.2
    obs_icu[5, 2] = np.nan        # exercise invalid-observation skipping
    obs_d = obs * 0.1
    obs_d[7, 0] = -3.0
    kw = dict(new_confirmed=obs, new_hospitalizations=obs, new_icu=obs_icu,
              new_deaths=obs_d, population_by_age=prm["N"],
              initial_cumulative_confirmed=[800.0] * 4,
              initial_cumulative_deaths=[4.0] * 4,
              initial_cumulative_hospitalizations=[25.0] * 4,
              initial_cumulative_icu=[5.0] * 4)
    return CalibrationData.from_arrays(**kw), TCalibrationData.from_arrays(**kw)


@pytest.fixture(scope="module")
def setup(spain_params):
    prm, params = spain_params
    n_days = 35
    data, tdata = _data_pair(prm, n_days)
    ts = make_time_grid(prm["runup_days"], n_days)
    names = ["beta_1", "beta_2", "theta", "seed_exposed", "p_0", "h_2",
             "kappa_2", "sigma"]
    bounds = {n: (0.01, 2.0) for n in names}
    bounds["seed_exposed"] = (1.0, 500.0)
    sigmas = {n: 0.05 for n in names}
    space = ParameterSpace.create(names, bounds, sigmas, params)
    return params, data, tdata, ts, space


def _engines(params, data, tdata, ts, space, **kw):
    """(jax xla, jax pallas, port fused, port eager) batched objectives."""
    tparams = to_torch_params(params)
    tspace = to_torch_space(space, tparams)
    jx = jax.vmap(build_objective(space, params, data, ts, substeps=2,
                                  constraint_mode=REFLECT, **kw))
    jp = build_objective_pallas(space, params, data, ts, substeps=2,
                                constraint_mode=REFLECT, interpret=True,
                                block_b=8, **kw)
    tf = build_objective_fused(tspace, tparams, tdata, ts, substeps=2,
                               constraint_mode=REFLECT, device="cpu", **kw)
    te = t_build_objective(tspace, tparams, tdata, ts, substeps=2,
                           constraint_mode=REFLECT, device="cpu", **kw)
    return jx, jp, tf, te


def _check_all(engines, thetas):
    jx, jp, tf, te = engines
    a = np.asarray(jx(jnp.asarray(thetas)))
    b = np.asarray(jp(jnp.asarray(thetas)))
    c = tf(torch.as_tensor(thetas)).numpy()
    d = te(torch.as_tensor(thetas)).numpy()
    for port in (c, d):
        np.testing.assert_allclose(port, a, rtol=1e-12)
        np.testing.assert_allclose(port, b, rtol=1e-12)
    return a


def _thetas(space, params, B, seed):
    theta0 = np.asarray(space.extract(params))
    rng = np.random.default_rng(seed)
    return theta0[None, :] + 0.05 * rng.standard_normal((B, space.dim))


def test_objective_matches_jax_with_runup(setup):
    params, data, tdata, ts, space = setup
    eng = _engines(params, data, tdata, ts, space)
    a = _check_all(eng, _thetas(space, params, 16, 1))
    assert np.isfinite(a).all()


def test_objective_matches_jax_no_runup(setup):
    """runup_offset == 0 branch (anchored row 0 contributes)."""
    params, data, tdata, ts, space = setup
    params0 = params.replace(runup_days=jnp.zeros_like(params.runup_days))
    ts0 = make_time_grid(0.0, data.n_data_points)
    eng = _engines(params0, data, tdata, ts0, space)
    _check_all(eng, _thetas(space, params0, 4, 2))


@pytest.mark.parametrize("B", [7, 1, 5])
def test_objective_matches_jax_batch_sizes(setup, B):
    params, data, tdata, ts, space = setup
    eng = _engines(params, data, tdata, ts, space)
    _check_all(eng, _thetas(space, params, B, B))


def test_objective_infeasible_masked(setup):
    """Multiplier-branch infeasibility returns lowest() like the JAX paths."""
    params, data, tdata, ts, _space = setup
    p2 = params.replace(seed_exposed=jnp.zeros_like(params.seed_exposed),
                        E0_multiplier=jnp.asarray(1e9, params.dtype))
    space2 = ParameterSpace.create(["beta_1", "theta"],
                                   {"beta_1": (0.01, 2.0),
                                    "theta": (0.01, 1.0)},
                                   {"beta_1": 0.05, "theta": 0.05}, p2)
    jx, jp, tf, te = _engines(p2, data, tdata, ts, space2)
    thetas = np.asarray(space2.extract(p2))[None, :].repeat(2, axis=0)
    for out in (np.asarray(jx(jnp.asarray(thetas))),
                np.asarray(jp(jnp.asarray(thetas))),
                tf(torch.as_tensor(thetas)).numpy(),
                te(torch.as_tensor(thetas)).numpy()):
        assert (out < -1e30).all()


def test_spain_map_anchor_float64():
    """The committed MAP on the initial-guess grid (dopri5@4, reflect) gives
    the committed float64 log-likelihood through the port's fused objective
    (results/spain2020/run_metadata.json: best_logl_float64)."""
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    from mmidv1_tpu_torch.data import read_sepaihrd_parameters

    pipe = load_spain_pipeline(REPO, dtype=torch.float64, device="cpu")
    calib = read_sepaihrd_parameters(
        os.path.join(REPO, "results", "spain2020", "calibrated_parameters.txt"),
        4, N=pipe.data.population_by_age, M_baseline=pipe.params.M_baseline.numpy(),
        dtype=torch.float64, device="cpu")
    ll = build_objective_fused(pipe.space, pipe.params, pipe.data, pipe.ts,
                               substeps=4, constraint_mode=REFLECT,
                               device="cpu")
    got = float(ll(pipe.space.extract(calib)[None, :])[0])
    np.testing.assert_allclose(got, 1432889.7908967654, rtol=1e-10)


def test_port_imports_without_jax():
    """Every module of the port loads without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mmidv1_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.startswith('jax') or\n"
        "       m == 'mmidv1_tpu' or m.startswith('mmidv1_tpu.')]\n"
        "assert not bad, bad\n"
        "print('imported', sum(m.startswith('mmidv1_tpu_torch') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("script", [
    "chip_smoke.py", "report_anchor.py",
    "mmidv1_tpu_torch/cli/benchmark_main.py",
    "mmidv1_tpu_torch/cli/production_campaign.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts and entry points the card runs import nothing of JAX or of
    the JAX package, at the top or inside a function."""
    import ast
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "mmidv1_tpu")]
    assert not bad, bad
    assert "report_anchor_jax" not in names


@pytest.mark.parametrize("runup", [20.0, 0.0])
def test_period_runs_match_jax(spain_params, runup):
    """The static schedule runs handed to the kernel are the Pallas ones."""
    from mmidv1_tpu.ops import sepaihrd_pallas as jpallas
    from mmidv1_tpu_torch.ops import sepaihrd_fused as sf

    _prm, params = spain_params
    ts = make_time_grid(runup, 306)
    bet = np.asarray(params.beta_end_times)
    ket = np.asarray(params.kappa_end_times)
    runs = sf.period_runs_for_grid(ts, bet, ket)
    assert runs == jpallas.period_runs_for_grid(ts, bet, ket)
    assert sum(r[3] for r in runs) == len(ts) - 1
    if runup:
        # Spain size: 7 runs, run 0 straddles the run-up boundary (edge run)
        start, count = runs[0][2], runs[0][3]
        assert len(runs) == 7 and start < 19 < start + count
