"""The port's serovalid artifact chain and artifact promotion against the JAX
package's scripts, on the host:

- ``make_laplace_trace`` at its defaults writes the JAX script's file in
  every bit (the committed ``laplace_trace.npz`` came from an older NumPy
  and no longer matches either, so the script's output in a temporary
  directory is the reference);
- ``refresh_artifact`` on a synthetic campaign writes the JAX script's
  files: ``posterior_samples.npz`` in every bit, ``run_metadata.json``
  equal, the MAP adopted or kept alike, and the serovalid refusal;
- the composed serovalid value_and_grad (``add_sero_term`` over K2 / K3's
  plain versions, REFLECT, as ``nuts_campaign --serovalid`` and
  ``serovalid_pipeline`` build it) equals ``jax.value_and_grad(ll + pen)``
  at rtol 1e-9 (float64, grid cut at day 70);
- ``serovalid_pipeline``'s free-block Laplace Hessian (exact, reverse over
  reverse) equals ``jax.jacfwd(jax.grad(joint_free))`` of the script at
  rtol 1e-8, and the pipeline writes the script's files and keys;
- ``serovalid_posterior_summary`` matches the JAX script on the same 8
  draws: sero quantiles rtol 1e-5 (float32 solves of two engines), the
  inside-CI fraction and the logl quantiles exactly.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import serovalid as jsv
from mmidv1_tpu.calibration.objective import build_objective
from mmidv1_tpu.calibration.param_space import REFLECT
from mmidv1_tpu.cli.common import load_spain_pipeline

from mmidv1_tpu_torch.calibration import serovalid as tsv
from mmidv1_tpu_torch.calibration.objective import \
    build_objective as t_build_objective
from mmidv1_tpu_torch.cli import (make_laplace_trace, refresh_artifact,
                                  serovalid_pipeline,
                                  serovalid_posterior_summary)
from mmidv1_tpu_torch.cli.common import \
    load_spain_pipeline as load_torch_pipeline
from mmidv1_tpu_torch.ops import build_objective_fused_grad

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
SV = os.path.join(REPO, "results", "spain2020_serovalid")
KW = dict(substeps=1, tableau="rk4", constraint_mode=REFLECT)


def _script(name):
    sys.path.insert(0, SCRIPTS)
    try:
        return __import__(name)
    finally:
        sys.path.remove(SCRIPTS)


def test_laplace_trace_equals_the_script(tmp_path):
    """The script runs from the shell, in its own process: float32 bounds
    without this test process's float64 default."""
    jax_out, port_out = tmp_path / "jax.npz", tmp_path / "port.npz"
    subprocess.run([sys.executable, os.path.join(SCRIPTS,
                                                 "make_laplace_trace.py"),
                    "--out", str(jax_out)], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=300,
                   capture_output=True)
    assert make_laplace_trace.main(["--out", str(port_out)]) == 0
    a, b = np.load(port_out), np.load(jax_out)
    assert a.files == b.files == ["samples", "names"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert a["samples"].shape == (64, 64, 62)
    assert port_out.read_bytes() == jax_out.read_bytes()


def _campaign(d, serovalid=False, best=2.0, T=20, B=4):
    d.mkdir()
    rng = np.random.default_rng(0)
    names = [f"p{i}" for i in range(3)]
    np.savez(d / "samples.npz", samples=rng.normal(size=(T, B, 3)),
             logps=rng.normal(size=(T, B)), names=np.asarray(names))
    meta = {"sampler": "nuts_test", "engine": "cuda", "chains": B,
            "iterations": T, "warmup": 2, "substeps": 4, "tableau": "dopri5",
            "wall_seconds": 12.5, "best_logl_float64": best, "seed": 0,
            "device": "cuda/card",
            "diagnostics": {"max_rhat": 1.01, "max_rank_rhat": 1.02,
                            "min_ess": 500.0, "min_ess_per_sec": 40.0}}
    if serovalid:
        meta["serovalid"] = {"sero_se": 0.0028}
    (d / "campaign_metadata.json").write_text(json.dumps(meta))
    (d / "calibrated_parameters.txt").write_text("campaign MAP\n")


@pytest.mark.parametrize("case", ["adopted", "kept", "serovalid_artifact",
                                  "few_draws"])
def test_refresh_artifact_equals_the_script(tmp_path, case):
    outs = {}
    for engine in ("jax", "port"):
        root = tmp_path / engine
        root.mkdir()
        camp = root / "camp"
        _campaign(camp, serovalid=case == "serovalid_artifact",
                  best=0.5 if case == "kept" else 2.0)
        art = root / ("art_serovalid" if case == "serovalid_artifact"
                      else "art")
        art.mkdir()
        (art / "run_metadata.json").write_text(json.dumps(
            {"best_logl_float64": 1.0, "note": "kept"}))
        (art / "calibrated_parameters.txt").write_text("artifact MAP\n")
        argv = [str(camp), "--artifact", str(art), "--draws",
                "200" if case == "few_draws" else "30", "--seed", "5"]
        main = (_script("refresh_artifact").main if engine == "jax"
                else refresh_artifact.main)
        assert main(argv) == 0
        outs[engine] = art
    a, b = outs["port"], outs["jax"]
    za, zb = np.load(a / "posterior_samples.npz"), \
        np.load(b / "posterior_samples.npz")
    assert za.files == zb.files
    for k in za.files:
        assert za[k].dtype == zb[k].dtype
        np.testing.assert_array_equal(za[k], zb[k])
    ma = json.loads((a / "run_metadata.json").read_text())
    mb = json.loads((b / "run_metadata.json").read_text())
    # the source line names the campaign directory, equal here by name
    assert ma == mb
    assert (a / "calibrated_parameters.txt").read_text() == \
        (b / "calibrated_parameters.txt").read_text()
    assert ((a / "calibrated_parameters.txt").read_text() ==
            "campaign MAP\n") == (case in ("adopted", "few_draws"))
    assert za["samples"].shape == ((80, 3) if case == "few_draws"
                                   else (30, 3))


def test_refresh_artifact_refuses_a_serovalid_campaign(tmp_path):
    for main in (_script("refresh_artifact").main, refresh_artifact.main):
        camp = tmp_path / f"camp_{len(list(tmp_path.iterdir()))}"
        _campaign(camp, serovalid=True)
        art = tmp_path / "spain2020"
        art.mkdir(exist_ok=True)
        (art / "run_metadata.json").write_text("{}")
        with pytest.raises(SystemExit, match="serovalid"):
            main([str(camp), "--artifact", str(art)])
        assert not (art / "posterior_samples.npz").exists()
    # a missing campaign MAP fails before anything is written
    camp = tmp_path / "nomap"
    _campaign(camp)
    os.remove(camp / "calibrated_parameters.txt")
    with pytest.raises(FileNotFoundError):
        refresh_artifact.main([str(camp), "--artifact", str(art)])
    assert not (art / "posterior_samples.npz").exists()


@pytest.fixture(scope="module")
def problem():
    pipe = load_spain_pipeline(REPO, dtype=jnp.float64, num_days=71)
    tpipe = load_torch_pipeline(REPO, num_days=71, dtype=torch.float64,
                                device="cpu")
    jrel, _ = jsv.relax_bounds(pipe.space)
    trel, _ = tsv.relax_bounds(tpipe.space)
    lap = np.load(os.path.join(SV, "laplace_serovalid.npz"))
    rng = np.random.default_rng(2)
    sig = tpipe.space.sigmas.numpy()
    thetas = lap["theta_map"][None] + 0.02 * sig * rng.normal(size=(3, 62))
    return dict(pipe=pipe, tpipe=tpipe, jrel=jrel, trel=trel, lap=lap,
                thetas=thetas)


def test_composed_serovalid_gradient_matches_jax(problem):
    p = problem
    pipe, tp = p["pipe"], p["tpipe"]
    jll = build_objective(p["jrel"], pipe.params, pipe.data, pipe.ts,
                          dtype=jnp.float64, **KW)
    jpen = jsv.make_sero_penalty(p["jrel"], pipe.params, pipe.data, pipe.ts,
                                 dtype=jnp.float64, **KW)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda th: jll(th) + jpen(th))))(jnp.asarray(p["thetas"]))
    stream = build_objective_fused_grad(p["trel"], tp.params, tp.data, tp.ts,
                                        dtype=torch.float64, device="cpu",
                                        **KW)
    tpen = tsv.make_sero_penalty(p["trel"], tp.params, tp.data, tp.ts, **KW)
    tv, tg = tsv.add_sero_term(stream, tpen)(torch.as_tensor(p["thetas"]))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9)
    g = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), g, rtol=1e-9,
                               atol=1e-9 * np.abs(g).max())


def test_free_block_laplace_hessian_matches_jax(problem):
    p = problem
    pipe, tp = p["pipe"], p["tpipe"]
    th = p["lap"]["theta_map"].astype(np.float64)
    free = [int(i) for i in p["lap"]["free"][:12]]
    jll = build_objective(p["jrel"], pipe.params, pipe.data, pipe.ts,
                          dtype=jnp.float64, **KW)
    jpen = jsv.make_sero_penalty(p["jrel"], pipe.params, pipe.data, pipe.ts,
                                 se=2e-4, dtype=jnp.float64, **KW)
    th_j, idx = jnp.asarray(th), jnp.asarray(free)

    def joint_free(z):                # scripts/serovalid_pipeline.py:305-316
        x = th_j.at[idx].set(z)
        return jll(x) + jpen(x)

    jH = np.asarray(jax.jacfwd(jax.grad(joint_free))(th_j[idx]))
    jH = 0.5 * (jH + jH.T)
    tll = t_build_objective(p["trel"], tp.params, tp.data, tp.ts,
                            dtype=torch.float64, device="cpu", **KW)
    tpen = tsv.make_sero_penalty(p["trel"], tp.params, tp.data, tp.ts,
                                 se=2e-4, **KW)
    H = serovalid_pipeline.free_block_hessian(
        lambda x: tll(x) + tpen(x), torch.as_tensor(th), free)
    np.testing.assert_allclose(H, jH, rtol=1e-8, atol=1e-8 * np.abs(jH).max())


def test_serovalid_pipeline_writes_the_script_files(tmp_path):
    meta = serovalid_pipeline.run([
        "--device", "cpu", "--num-days", "70", "--tableau", "rk4",
        "--substeps", "1", "--maxiter", "2", "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted([
        "param_bounds_serovalid.txt", "calibrated_parameters.txt",
        "serovalid_metadata.json", "laplace_serovalid.npz"])
    with open(os.path.join(SV, "serovalid_metadata.json")) as f:
        committed = json.load(f)
    assert sorted(meta) == sorted(committed)
    for row in ("unconstrained_relaxed_map", "constrained_map"):
        assert sorted(meta[row]) == sorted(committed[row])
    assert meta["bounds"]["relaxed_parameters"] == \
        committed["bounds"]["relaxed_parameters"]
    lap = np.load(tmp_path / "laplace_serovalid.npz")
    ref = np.load(os.path.join(SV, "laplace_serovalid.npz"))
    assert sorted(lap.files) == sorted(ref.files)
    assert lap["free"].dtype == ref["free"].dtype
    assert lap["cov_free"].shape == (lap["free"].size,) * 2
    assert np.all(np.linalg.eigvalsh(lap["cov_free"]) > 0)
    # the bounds do not depend on the window: the committed file, byte for
    # byte
    assert (tmp_path / "param_bounds_serovalid.txt").read_bytes() == open(
        os.path.join(SV, "param_bounds_serovalid.txt"), "rb").read()


def test_posterior_summary_matches_the_script(tmp_path):
    outs = {}
    for engine in ("jax", "port"):
        art = tmp_path / engine
        shutil.copytree(SV, art)
        argv = ["--artifact", str(art), "--replay-draws", "8", "--batch", "4"]
        if engine == "jax":
            assert _script("serovalid_posterior_summary").main(
                argv + ["--platform", "cpu"]) == 0
        else:
            assert serovalid_posterior_summary.main(argv + ["--device",
                                                            "cpu"]) == 0
        with open(art / "run_metadata.json") as f:
            outs[engine] = json.load(f)["posterior_summary"]
    a, b = outs["port"], outs["jax"]
    assert sorted(a) == sorted(b) and a["n_replayed"] == b["n_replayed"] == 8
    for k in b["sero_day64"]:
        np.testing.assert_allclose(a["sero_day64"][k], b["sero_day64"][k],
                                   rtol=1e-5)
    assert a["sero_inside_ci_frac"] == b["sero_inside_ci_frac"]
    assert a["logl"] == b["logl"] and a["ene_covid_mean"] == b[
        "ene_covid_mean"]


@pytest.mark.slow
def test_serovalid_pipeline_equals_the_script_on_the_full_grid(tmp_path):
    """``serovalid_pipeline --maxiter 1 --skip-laplace`` on the full grid,
    the port on the host against the JAX script: every row of the
    metadata."""
    argv = ["--maxiter", "1", "--skip-laplace"]
    assert _script("serovalid_pipeline").main(
        argv + ["--out", str(tmp_path / "jax")]) == 0
    meta = serovalid_pipeline.run(argv + ["--device", "cpu", "--out",
                                          str(tmp_path / "port")])
    with open(tmp_path / "jax" / "serovalid_metadata.json") as f:
        ref = json.load(f)
    assert sorted(meta) == sorted(ref)
    for row in ("reference_bounds_map", "unconstrained_relaxed_map",
                "constrained_map"):
        for k in ("ll_poisson_float64", "sero_day64"):
            np.testing.assert_allclose(meta[row][k], ref[row][k], rtol=1e-9)
    for k in ("overall_attack_rate", "overall_ifr", "total_deaths", "R0"):
        np.testing.assert_allclose(meta[k], ref[k], rtol=1e-8)
    assert (tmp_path / "port" / "param_bounds_serovalid.txt").read_bytes() \
        == (tmp_path / "jax" / "param_bounds_serovalid.txt").read_bytes()
