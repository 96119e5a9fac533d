"""The port's production NUTS campaign (``cli/nuts_campaign``) on the host.

- every ``--mass`` mode's ``mu`` / ``scale`` / ``power`` (and start and
  whitening) equal ``scripts/nuts_campaign.py:309-400``'s NumPy recipe,
  computed here with the JAX package's ``logit_transform``: rtol 1e-12;
- the pre-final stages' seeds differ from each other and from the final
  stage's;
- a campaign killed after 2 of 4 segments, with a third partial file
  written without its state, and resumed equals the uninterrupted campaign
  in every bit (the extra partial is dropped); the gate returns 3;
- the guards of ``tests/test_scripts.py:488-506``, and a hole in the trace;
- the live monitor stops on a constructed converged trace, only after its
  streak, and not on an unconverged one;
- the stage ladder and the diagonal modes run.

At 30 days and rk4@1 with 4 chains (K2 / K3's plain versions).
"""

import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration.nuts import logit_transform as jax_logit
from mmidv1_tpu_torch.cli import nuts_campaign as nc
from mmidv1_tpu_torch.cli.common import load_spain_pipeline

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(REPO, "results")
LOGITSEED = os.path.join(RES, "spain2020_nuts_logitseed", "samples.npz")
LAPLACE = os.path.join(RES, "spain2020", "laplace_mass.npz")
POSTERIOR = os.path.join(RES, "spain2020", "posterior_samples.npz")
TINY = ["--device", "cpu", "--num-days", "30", "--tableau", "rk4",
        "--substeps", "1", "--chains", "4", "--depth", "2", "--warmup", "2",
        "--mass", "logit-dense", "--trace", LOGITSEED, "--warm", LOGITSEED]


def script_mass(mode, lo, hi, theta0, power="1", mass_file=None):
    """``scripts/nuts_campaign.py:309-400`` in NumPy (the JAX transform):
    ``(mu, scale, power, theta0, sigmas)``."""
    d = lo.size
    if mode == "posterior":
        post = np.load(POSTERIOR)
        std = post["samples"].std(axis=0, ddof=1).astype(np.float64)
        return None, None, None, theta0, np.maximum(std, 1e-12)
    if mode in ("laplace", "laplace-dense"):
        lap = np.load(LAPLACE)
        std = np.maximum(lap["std"].astype(np.float64), 1e-12)
        if mode == "laplace":
            return None, None, None, lap["theta_map"], std
        cov = np.diag(std ** 2)
        cov[np.ix_(lap["free"], lap["free"])] = lap["cov_free"]
        return (lap["theta_map"], np.linalg.cholesky(cov), None,
                lap["theta_map"], None)
    if mode == "empirical-dense":
        flat = np.load(LOGITSEED)["samples"].reshape(-1, d).astype(np.float64)
        cov_emp = np.cov(flat, rowvar=False)
        diag = np.diag(np.maximum(np.diag(cov_emp), 1e-24))
        cov = 0.9 * cov_emp + 0.1 * diag
        th = np.load(LAPLACE)["theta_map"]
        return th, np.linalg.cholesky(cov), None, th, None
    if mode == "logit-dense":
        flat = np.load(LOGITSEED)["samples"].reshape(-1, d).astype(np.float64)
        if power == "auto":
            u_hi = np.quantile((flat - lo) / (hi - lo), 0.995, axis=0)
            power_k = np.where(u_hi < 0.8, 8.0, 1.0)
        else:
            power_k = np.full(d, float(power))
        y_tr = jax_logit(flat, lo, hi, power=power_k)
        cov_emp = np.cov(y_tr, rowvar=False)
        diag = np.diag(np.maximum(np.diag(cov_emp), 1e-24))
        cov = 0.9 * cov_emp + 0.1 * diag
        cov = cov + np.diag(np.maximum(0.25 ** 2 - np.diag(cov), 0.0))
        return y_tr.mean(axis=0), np.linalg.cholesky(cov), power_k, None, None
    if mode == "logit-file":
        mf = np.load(mass_file)
        return mf["mu"], mf["scale"], mf["power"], None, None
    return None, None, None, theta0, None


@pytest.fixture(scope="module")
def box():
    pipe = load_spain_pipeline(REPO, dtype=torch.float32, device="cpu")
    lo = pipe.space.lower.numpy().astype(np.float64)
    hi = pipe.space.upper.numpy().astype(np.float64)
    theta0 = pipe.space.extract(pipe.params).numpy().astype(np.float64)
    return list(pipe.space.names), lo, hi, theta0


@pytest.mark.parametrize("mode,power", [
    ("laplace-dense", "1"), ("laplace", "1"), ("posterior", "1"),
    ("sigmas", "1"), ("empirical-dense", "1"), ("logit-dense", "1"),
    ("logit-dense", "auto"), ("logit-dense", "3"), ("logit-file", "1")])
def test_mass_modes_equal_the_script_recipe(box, tmp_path, mode, power):
    names, lo, hi, theta0 = box
    mass_file = None
    if mode == "logit-file":
        rng = np.random.default_rng(3)
        mass_file = str(tmp_path / "mass.npz")
        np.savez(mass_file, mu=rng.normal(size=62),
                 scale=np.tril(rng.normal(size=(62, 62))),
                 power=np.where(rng.random(62) < 0.5, 8.0, 1.0),
                 names=np.asarray(names))
    args = argparse.Namespace(mass=mode, power=power, trace=LOGITSEED,
                              laplace=LAPLACE, posterior=POSTERIOR,
                              mass_file=mass_file)
    got = nc.build_mass(args, names, lo, hi, theta0)
    want = script_mass(mode, lo, hi, theta0, power, mass_file)
    for field, g, w in zip(nc.Mass._fields, got, want):
        if w is None:
            assert g is None, field
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=field)
    if mode == "logit-dense" and power == "auto":
        assert 0 < (got.power == 8.0).sum() < 62


def test_mass_inputs_are_checked(box, tmp_path):
    names, lo, hi, theta0 = box
    np.savez(tmp_path / "bad.npz", samples=np.zeros((2, 2, 62)),
             names=np.asarray(names[::-1]))
    args = argparse.Namespace(mass="logit-dense", power="1",
                              trace=str(tmp_path / "bad.npz"),
                              laplace=LAPLACE, posterior=POSTERIOR,
                              mass_file=None)
    with pytest.raises(SystemExit, match="names"):
        nc.build_mass(args, names, lo, hi, theta0)
    with pytest.raises(SystemExit, match="needs --trace"):
        nc.build_mass(argparse.Namespace(**dict(vars(args), trace=None)),
                      names, lo, hi, theta0)


def test_stage_seeds_differ():
    seeds = [nc.stage_seed(0, s) for s in range(4)] + [0]
    assert len(set(seeds)) == 5
    assert nc.stage_seed(7, 1) == nc.stage_seed(7, 1) != nc.stage_seed(8, 1)


def test_warm_ensemble_tiles_and_cuts():
    last = np.load(LOGITSEED)["samples"][-1]
    np.testing.assert_array_equal(nc.warm_ensemble(LOGITSEED, 4), last[:4])
    tiled = nc.warm_ensemble(LOGITSEED, 600)
    assert tiled.shape == (600, 62)
    np.testing.assert_array_equal(tiled[256:512], last)


def _same_dir(a, b, files):
    for name in files:
        with np.load(a / name) as za, np.load(b / name) as zb:
            assert za.files == zb.files, name
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (name, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=name + k)
    assert (a / "posterior_trace.csv").read_bytes() == \
        (b / "posterior_trace.csv").read_bytes()


def test_killed_and_resumed_campaign_equals_uninterrupted(tmp_path, capsys):
    full, killed = tmp_path / "full", tmp_path / "killed"
    assert nc.main(TINY + ["--iterations", "8", "--segments", "4",
                           "--out", str(full)]) == 0
    assert nc.main(TINY + ["--iterations", "4", "--segments", "2",
                           "--out", str(killed)]) == 0
    # the crash window: a third segment's partial landed, its state did not
    shutil.copy(killed / "partial_samples_0001.npz",
                killed / "partial_samples_0002.npz")
    capsys.readouterr()
    rc = nc.main(TINY + ["--iterations", "8", "--segments", "4", "--resume",
                         "--require-rhat", "1.0", "--out", str(killed)])
    out = capsys.readouterr().out
    assert rc == 3 and "CONVERGENCE GATE FAILED" in out
    assert "dropping 2 uncheckpointed draws" in out
    _same_dir(full, killed, [f"partial_samples_{s:04d}.npz" for s in range(4)]
              + ["nuts_state.npz", "samples.npz", "active_mass.npz"])
    meta = json.loads((killed / "campaign_metadata.json").read_text())
    ref = json.loads((full / "campaign_metadata.json").read_text())
    assert meta["iterations"] == 8 and meta["sampler"] == "nuts_logit-dense"
    for k in ("best_logl_float64", "posterior_burn"):
        assert meta[k] == ref[k], k
    for k in ("max_rhat", "max_rank_rhat", "min_ess", "per_parameter"):
        assert meta["diagnostics"][k] == ref["diagnostics"][k], k
    assert meta["wall_seconds"] > 0 and meta["device"] == "cpu/cpu"
    assert sorted(ref) == sorted(
        ["sampler", "engine", "chains", "iterations", "warmup",
         "max_tree_depth", "substeps", "tableau", "wall_seconds",
         "value_and_grads_per_sec_incl_host", "mean_accept",
         "mean_tree_depth", "best_logl_float64", "diagnostics",
         "posterior_burn", "seed", "device"])
    with open(full / "calibrated_parameters.txt") as f:
        assert f"{ref['best_logl_float64']:.8e}" in f.read()

    # a hole (a missing middle partial) cannot be reconstructed
    os.remove(killed / "partial_samples_0001.npz")
    with pytest.raises(SystemExit):
        nc.main(TINY + ["--iterations", "10", "--segments", "5", "--resume",
                        "--out", str(killed)])


def test_resume_guards(tmp_path):
    """``tests/test_scripts.py:488-506``: whitened modes, a missing
    checkpoint, a checkpoint without its partial trace."""
    with pytest.raises(SystemExit):
        nc.main(["--resume", "--mass", "laplace", "--device", "cpu",
                 "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        nc.main(["--resume", "--mass", "laplace-dense", "--device", "cpu",
                 "--out", str(tmp_path)])
    (tmp_path / "nuts_state.npz").write_bytes(b"")
    with pytest.raises(SystemExit):
        nc.main(["--resume", "--mass", "laplace-dense", "--device", "cpu",
                 "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        nc.main(["--stages", "2", "--mass", "laplace", "--device", "cpu"])
    with pytest.raises(SystemExit):
        nc.main(["--stages", "2", "--stage-iterations", "3", "--warmup", "5",
                 "--device", "cpu"])


def _monitor(**kw):
    args = argparse.Namespace(**dict(dict(
        warmup=0, posterior_burn_iters=0, posterior_burn_frac=0.5,
        require_rhat=1.1, stop_when_converged=2), **kw))
    return nc.LiveMonitor([f"p{j}" for j in range(3)], args)


def test_live_monitor_stops_on_a_converged_trace(capsys):
    rng = np.random.default_rng(0)
    mon = _monitor()
    seg = lambda: rng.standard_normal((100, 8, 3))
    assert mon.update(seg(), 100) is False      # 100 burned: under the bar
    assert mon.update(seg(), 200) is False      # streak 1
    assert mon.update(seg(), 300) is True       # streak 2: stop
    assert "EARLY STOP" in capsys.readouterr().out
    # chains at distinct offsets never stop, and a bad segment resets
    mon = _monitor()
    shifted = lambda: rng.standard_normal((100, 8, 3)) + \
        np.arange(8)[None, :, None] * 5.0
    assert not any(mon.update(shifted(), 100 * (i + 1)) for i in range(4))
    mon = _monitor(stop_when_converged=3)
    assert mon.update(seg(), 100) is False
    assert mon.update(seg(), 200) is False and mon.streak == 1
    mon.xs = [x + np.arange(8)[None, :, None] * 5.0 for x in mon.xs]
    assert mon.update(seg(), 300) is False and mon.streak == 0
    # no gate, no stop
    mon = _monitor(require_rhat=0.0)
    assert not any(mon.update(seg(), 100 * (i + 1)) for i in range(4))


def test_burn_window_policies():
    assert nc.burn_window(100, 10, 0, 0.5) == (55, "50% of 90")
    assert nc.burn_window(100, 10, 30, 0.5)[0] == 40
    assert nc.burn_window(100, 10, 500, 0.5)[0] == 10 + 81   # 90 % cap


@pytest.mark.parametrize("extra", [
    ["--mass", "laplace-dense", "--stages", "2", "--stage-iterations", "3"],
    ["--mass", "sigmas"], ["--mass", "laplace"]])
def test_stage_ladder_and_diagonal_modes_run(tmp_path, extra):
    argv = ["--device", "cpu", "--num-days", "30", "--tableau", "rk4",
            "--substeps", "1", "--chains", "4", "--depth", "1", "--warmup",
            "1", "--iterations", "3", "--segments", "1", "--out",
            str(tmp_path)] + extra
    assert nc.main(argv) == 0
    meta = json.loads((tmp_path / "campaign_metadata.json").read_text())
    assert meta["sampler"] == f"nuts_{extra[1]}"
    assert np.isfinite(meta["best_logl_float64"])
    z = np.load(tmp_path / "samples.npz")
    assert z["samples"].shape == (2, 4, 62) and np.isfinite(z["logps"]).all()
    # only the dense modes checkpoint their final stage
    assert (tmp_path / "nuts_state.npz").exists() == ("--stages" in extra)


@pytest.mark.parametrize("module", [
    "nuts_campaign", "map_polish", "refresh_artifact", "make_laplace_trace",
    "_logit_posterior", "curvature_probe", "make_capped_mass",
    "energy_error_probe", "serovalid_pipeline", "serovalid_posterior_summary"])
def test_recipe_modules_import_no_jax_and_no_scripts(module):
    """The recipe's modules import nothing of JAX, of the JAX package or of
    ``scripts/``, at the top or inside a function."""
    import ast
    path = os.path.join(REPO, "mmidv1_tpu_torch", "cli", module + ".py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names
           if m.split(".")[0] in ("jax", "mmidv1_tpu", "scripts")]
    assert not bad, bad
