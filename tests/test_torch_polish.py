"""The port's MAP polish, exact Hessian and mass tools against the JAX
package, float64 on the host (K2 / K3's plain versions), Spain grid cut at
30 days, rk4@1:

- ``map_polish.hessian_products`` and one L-BFGS-B round driven by the
  port's K2 / K3 value_and_grad equal the same functions driven by JAX's
  ``value_and_grad(build_objective)``: LL rtol 1e-10, std 1e-6;
- ``_logit_posterior``'s value, gradient and exact Hessian equal
  ``jax.hessian`` of ``scripts/make_capped_mass.py``'s ``logp_y`` at two
  points (power k = 1 and 8 mixed): rtol 1e-8, floored at 1e-8 max|H|;
- the energy probe's leapfrog equals the same leapfrog on JAX's gradient,
  fed the same momenta: dH rtol 1e-8;
- ``make_capped_mass.cap_scale`` meets its cap; the tools run end to end.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.nuts import logit_transform as jax_logit
from mmidv1_tpu.calibration.objective import build_objective
from mmidv1_tpu.calibration.param_space import REFLECT
from mmidv1_tpu.cli.common import load_spain_pipeline

from mmidv1_tpu_torch.calibration.objective import \
    build_objective as t_build_objective
from mmidv1_tpu_torch.cli import (curvature_probe, energy_error_probe,
                                  make_capped_mass, map_polish)
from mmidv1_tpu_torch.calibration.nuts import logit_transform, logit_vag_z
from mmidv1_tpu_torch.cli._logit_posterior import exact_hessian, make_logp_y
from mmidv1_tpu_torch.cli.common import \
    load_spain_pipeline as load_torch_pipeline
from mmidv1_tpu_torch.ops import build_objective_fused_grad

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITSEED = os.path.join(REPO, "results", "spain2020_nuts_logitseed",
                         "samples.npz")
LAPLACE = os.path.join(REPO, "results", "spain2020", "laplace_mass.npz")
KW = dict(substeps=1, tableau="rk4", constraint_mode=REFLECT)
SMALL = ["--device", "cpu", "--num-days", "30", "--tableau", "rk4",
         "--substeps", "1"]


@pytest.fixture(scope="module")
def problem():
    pipe = load_spain_pipeline(REPO, dtype=jnp.float64, num_days=30)
    tpipe = load_torch_pipeline(REPO, num_days=30, dtype=torch.float64,
                                device="cpu")
    jll = build_objective(pipe.space, pipe.params, pipe.data, pipe.ts,
                          dtype=jnp.float64, **KW)
    tll = t_build_objective(tpipe.space, tpipe.params, tpipe.data, tpipe.ts,
                            dtype=torch.float64, device="cpu", **KW)
    tvg = build_objective_fused_grad(tpipe.space, tpipe.params, tpipe.data,
                                     tpipe.ts, dtype=torch.float64,
                                     device="cpu", **KW)
    lo = tpipe.space.lower.numpy()
    hi = tpipe.space.upper.numpy()
    np.testing.assert_array_equal(lo, np.asarray(pipe.space.lower))
    return dict(pipe=pipe, tpipe=tpipe, jll=jll, tll=tll, tvg=tvg, lo=lo,
                hi=hi, sig=tpipe.space.sigmas.numpy())


def jax_rows(jll):
    vg = jax.jit(jax.vmap(jax.value_and_grad(jll)))
    return lambda th: tuple(np.asarray(a) for a in vg(jnp.asarray(th)))


def test_hessian_products_and_a_polish_round_match_jax(problem):
    p = problem
    engines = {"port": map_polish.engine_rows(p["tvg"], "cpu"),
               "jax": (jax_rows(p["jll"]), None)}
    jr = engines["jax"][0]
    engines["jax"] = (jr, lambda th: (float(jr(np.asarray(th)[None])[0][0]),
                                      jr(np.asarray(th)[None])[1][0]))
    theta = np.load(LAPLACE)["theta_map"].astype(np.float64)
    out = {}
    for name, (rows, vg1) in engines.items():
        v, g = vg1(theta)
        std, free, cov, n, _s = map_polish.hessian_products(
            rows, theta, g, p["lo"], p["hi"], p["sig"])
        out[name] = dict(v=v, g=g, std=std, free=free, cov=cov, n=n)
    # the round in the same whitening on both engines: L-BFGS-B's path
    # follows every digit of its scaling, so only the gradients may differ
    for name, (rows, vg1) in engines.items():
        theta1, v1, _gw, _nev = map_polish.polish_round(
            vg1, theta, out["jax"]["std"], p["lo"], p["hi"], maxiter=3)
        out[name].update(theta1=theta1, v1=v1)
    a, b = out["port"], out["jax"]
    np.testing.assert_allclose(a["v"], b["v"], rtol=1e-10)
    np.testing.assert_array_equal(a["free"], b["free"])
    assert a["n"] == b["n"] > 0 and 0 < a["free"].sum() < 62
    np.testing.assert_allclose(a["std"], b["std"], rtol=1e-6)
    np.testing.assert_allclose(a["cov"], b["cov"], rtol=1e-6,
                               atol=1e-6 * np.abs(b["cov"]).max())
    np.testing.assert_allclose(a["v1"], b["v1"], rtol=1e-10)
    assert a["v1"] >= a["v"]
    assert np.max(np.abs(a["theta1"] - b["theta1"])
                  / (p["hi"] - p["lo"])) <= 1e-6


def test_hessian_products_one_sided_at_a_bound():
    """A free coordinate on its bound takes the one-sided stencil, a pinned
    one its decay length: on a quadratic both give the exact curvature."""
    d = 3
    A = np.array([[-4.0, 1.0, 0.0], [1.0, -3.0, 0.5], [0.0, 0.5, -2.0]])
    lo, hi = np.zeros(d), np.ones(d)
    c = np.array([0.5, -0.3, 0.8])

    def rows(th):
        th = np.atleast_2d(th)
        dx = th - c
        return 0.5 * np.einsum("bi,ij,bj->b", dx, A, dx), dx @ A
    # p1 on its lower bound, pushed out (pinned); p2 on its upper bound,
    # pulled in (free, one-sided)
    theta = np.array([0.5, 0.0, 1.0])
    g0 = rows(theta)[1][0]
    assert g0[1] < 0 and g0[2] < 0
    std, free, cov, n, _s = map_polish.hessian_products(
        rows, theta, g0, lo, hi, np.full(d, 0.1))
    assert free.tolist() == [True, False, True] and n == 3
    Hf = A[np.ix_(free, free)]
    np.testing.assert_allclose(cov, np.linalg.inv(-Hf), rtol=1e-6)
    assert std[1] == min(1.0 / abs(g0[1]), 0.05)


def test_logit_posterior_hessian_matches_jax_hessian(problem):
    p = problem
    lo, hi = p["lo"], p["hi"]
    X = np.load(LOGITSEED)["samples"].astype(np.float64)
    flat = X.reshape(-1, 62)
    u_hi = np.quantile((flat - lo) / (hi - lo), 0.995, axis=0)
    power = np.where(u_hi < 0.8, 8.0, 1.0)
    assert 0 < (power == 8.0).sum() < 62
    w = np.maximum(hi - lo, 1e-30)
    lo_j, w_j, k_j = jnp.asarray(lo), jnp.asarray(w), jnp.asarray(power)

    def logp_y(y):                          # scripts/make_capped_mass.py:101
        u = jnp.exp(jax.nn.log_sigmoid(k_j * y) / k_j)
        jac = jnp.sum(jnp.log(w_j) + jax.nn.log_sigmoid(k_j * y) / k_j +
                      jax.nn.log_sigmoid(-k_j * y))
        return p["jll"](lo_j + w_j * u) + jac

    jvg = jax.jit(jax.value_and_grad(logp_y))
    jhess = jax.jit(jax.hessian(logp_y))
    tlogp = make_logp_y(p["tll"], p["tpipe"].space.lower,
                        p["tpipe"].space.upper, torch.as_tensor(power))
    for c in (0, 17):
        y = logit_transform(X[-1, c], lo, hi, power=power)
        np.testing.assert_allclose(y, jax_logit(X[-1, c], lo, hi,
                                                power=power), rtol=1e-15)
        v, g, H = exact_hessian(tlogp, torch.as_tensor(y))
        jv, jg = jvg(jnp.asarray(y))
        jH = np.asarray(jhess(jnp.asarray(y)))
        np.testing.assert_allclose(v.item(), float(jv), rtol=1e-10)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8,
                                   atol=1e-8 * np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(H.numpy(), jH, rtol=1e-8,
                                   atol=1e-8 * np.abs(jH).max())
        assert np.abs(jH).max() > 0


def test_energy_probe_leapfrog_matches_jax(problem):
    p = problem
    lo, hi = p["lo"], p["hi"]
    X = np.load(LOGITSEED)["samples"].astype(np.float64)
    power = np.where(np.arange(62) % 3 == 0, 8.0, 1.0)
    mu = logit_transform(X[0, :8], lo, hi, power=power).mean(axis=0)
    S = np.diag(np.full(62, 0.3))
    z0 = np.linalg.solve(
        S, (logit_transform(X[-1, :3], lo, hi, power=power) - mu).T).T
    r0 = np.random.default_rng(4).standard_normal(z0.shape)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    tvag = logit_vag_z(p["tvg"], t(lo), t(hi - lo), t(mu), t(S), t(power))
    dh = energy_error_probe.trajectory_dh(tvag, t(z0), 2e-3, 4, t(r0))

    jrows = jax.jit(jax.vmap(jax.value_and_grad(p["jll"])))
    k, w = jnp.asarray(power), jnp.asarray(hi - lo)

    def jvag(z):                   # scripts/energy_error_probe.py:111-123
        ys = jnp.asarray(mu)[None, :] + z @ jnp.asarray(S).T
        u = jnp.exp(jax.nn.log_sigmoid(k * ys) / k)
        sig_m = jax.nn.sigmoid(-k * ys)
        lp, g = jrows(jnp.asarray(lo)[None, :] + w[None, :] * u)
        jac = jnp.sum(jnp.log(w)) + jnp.sum(jax.nn.log_sigmoid(k * ys) / k
                                            + jax.nn.log_sigmoid(-k * ys), -1)
        gy = g * (w[None, :] * u * sig_m) + (sig_m - k * jax.nn.sigmoid(k * ys))
        return lp + jac, gy @ jnp.asarray(S)

    z, r = jnp.asarray(z0), jnp.asarray(r0)
    lp0, g = jvag(z)
    h0 = lp0 - 0.5 * jnp.sum(r * r, -1)
    for _ in range(4):
        r = r + 0.5 * 2e-3 * g
        z = z + 2e-3 * r
        _lp, g = jvag(z)
        r = r + 0.5 * 2e-3 * g
    lp1, _g = jvag(z)
    jdh = np.asarray(lp1 - 0.5 * jnp.sum(r * r, -1) - h0)
    np.testing.assert_allclose(dh.numpy(), jdh, rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(lp0)).max())


def test_cap_scale_meets_the_cap():
    rng = np.random.default_rng(1)
    B = rng.normal(size=(6, 6))
    H = -(B @ B.T) * 50.0
    S = np.linalg.cholesky(np.eye(6) + 0.1 * np.ones((6, 6)))
    S2, n, worst = make_capped_mass.cap_scale(S, [H], 0.5)
    assert n > 0 and worst <= 0.25 * (1 + 1e-9)
    lam = np.linalg.eigvalsh(S2.T @ (-H) @ S2)
    assert lam.max() <= 0.25 * (1 + 1e-9)


def test_tools_run_end_to_end(tmp_path):
    """map_polish, curvature_probe, make_capped_mass and the energy probe on
    the host at 30 days: their files, in the JAX scripts' layouts."""
    out = tmp_path / "polish"
    assert map_polish.main(SMALL + ["--rounds", "1", "--maxiter", "2",
                                    "--out", str(out)]) == 0
    lap = np.load(out / "laplace_mass.npz")
    assert sorted(lap.files) == sorted(["names", "theta_map", "std", "free",
                                        "cov_free", "ll_map", "grad_map"])
    assert lap["cov_free"].shape[0] == int(lap["free"].sum())
    assert (lap["std"] > 0).all() and np.isfinite(lap["std"]).all()
    meta = json.loads((out / "polish_metadata.json").read_text())
    assert meta["algorithm"] == "lbfgsb_laplace_whitened"
    assert meta["rounds"][-1]["ll"] >= meta["rounds"][0]["ll"] - 1e-6
    assert sorted(meta) == sorted(["algorithm", "substeps", "tableau",
                                   "rounds", "final_ll_float64", "n_free",
                                   "pinned"])
    npy = tmp_path / "theta.npy"
    np.save(npy, lap["theta_map"])
    assert map_polish.main(SMALL + ["--init", str(npy), "--rounds", "0",
                                    "--out", str(tmp_path / "p0")]) == 0
    assert float(np.load(tmp_path / "p0" / "laplace_mass.npz")["ll_map"]) \
        == float(lap["ll_map"])

    rep = tmp_path / "curv.json"
    # as in the script, --points 3 takes the best chain and the last of the
    # spread (its first is the best again)
    assert curvature_probe.main(SMALL + ["--trace", LOGITSEED, "--points",
                                         "3", "--out", str(rep)]) == 0
    r = json.loads(rep.read_text())
    assert len(r["points"]) == 2 and set(r["masses"]) == {"pooled", "within"}
    assert all(m["eps_stable"] > 0 for m in r["masses"].values())
    mass = tmp_path / "capped.npz"
    assert make_capped_mass.main(SMALL + ["--trace", LOGITSEED, "--points",
                                          "1", "--power", "auto", "--out",
                                          str(mass)]) == 0
    z = np.load(mass)
    assert sorted(z.files) == ["mu", "names", "power", "scale"]
    # the probe runs dopri5@4, as the script does
    rows = energy_error_probe.run(SMALL[:4] + [
        "--trace", LOGITSEED, "--chains", "3", "--steps", "2", "--eps",
        "1e-3", "--mass-file", str(mass)])
    assert rows[0]["finite"] == 3 and 0 < rows[0]["accept"] <= 1


@pytest.mark.slow
def test_polish_and_curvature_tools_equal_the_scripts_on_the_full_grid(
        tmp_path):
    """``map_polish --rounds 0`` and ``curvature_probe --points 1`` on the
    full grid (dopri5@4), the port on the host against the JAX scripts,
    field by field."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import curvature_probe as j_curv
    import map_polish as j_polish
    npy = tmp_path / "theta.npy"
    np.save(npy, np.load(LAPLACE)["theta_map"])
    for main, out in ((j_polish.main, "jax"), (map_polish.main, "port")):
        argv = ["--init", str(npy), "--rounds", "0", "--out",
                str(tmp_path / out)]
        assert main(argv + (["--device", "cpu"] if out == "port" else [])) \
            == 0
    a = np.load(tmp_path / "port" / "laplace_mass.npz")
    b = np.load(tmp_path / "jax" / "laplace_mass.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_allclose(a["ll_map"], b["ll_map"], rtol=1e-10)
    np.testing.assert_array_equal(a["free"], b["free"])
    np.testing.assert_allclose(a["grad_map"], b["grad_map"], rtol=1e-8,
                               atol=1e-8 * np.abs(b["grad_map"]).max())
    np.testing.assert_allclose(a["std"], b["std"], rtol=1e-6)
    ma = json.loads((tmp_path / "port" / "polish_metadata.json").read_text())
    mb = json.loads((tmp_path / "jax" / "polish_metadata.json").read_text())
    assert sorted(ma) == sorted(mb) and ma["pinned"] == mb["pinned"]

    reps = {}
    for main, out in ((j_curv.main, "jax"), (curvature_probe.main, "port")):
        path = tmp_path / f"curv_{out}.json"
        argv = ["--trace", LOGITSEED, "--points", "1", "--out", str(path)]
        assert main(argv + (["--device", "cpu"] if out == "port" else [])) \
            == 0
        reps[out] = json.loads(path.read_text())
    a, b = reps["port"], reps["jax"]
    assert a["points"][0]["chain"] == b["points"][0]["chain"]
    for k in ("eig_min", "eig_max"):
        np.testing.assert_allclose(a["points"][0][k], b["points"][0][k],
                                   rtol=1e-8)
    for m in b["masses"]:
        for k in ("eps_stable", "whitened_width"):
            np.testing.assert_allclose(a["masses"][m][k], b["masses"][m][k],
                                       rtol=1e-8)
