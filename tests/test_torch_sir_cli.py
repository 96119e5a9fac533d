"""The port's five SIR entry points and the dispatcher, on the CPU at small
sizes, against the JAX mains where they are deterministic.

This test process runs JAX with x64 enabled (``tests/conftest.py``), so the
JAX mains compute in float64 here; the port's run ``--x64 --device cpu``, and
their CSVs must have identical headers and values at rtol 1e-9.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch.cli import COMMANDS
from mmidv1_tpu_torch.cli.__main__ import main as dispatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "data", "configuration", "sir_input_parameters.txt")


def _read(path):
    with open(path) as f:
        header, *rows = f.read().splitlines()
    return header, np.array([[float(v) for v in r.split(",")] for r in rows])


def _project(tmp_path):
    """A project root with the real age-SIR inputs."""
    (tmp_path / "data" / "processed").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "data", "contacts.csv"),
                tmp_path / "data" / "contacts.csv")
    shutil.copy(os.path.join(REPO, "data", "processed", "processed_data.csv"),
                tmp_path / "data" / "processed" / "processed_data.csv")
    return str(tmp_path)


def test_dispatcher_help_and_exit_codes(capsys):
    """``tests/test_cli.py:130`` on the port's dispatcher."""
    assert dispatch([]) == 1
    assert dispatch(["--help"]) == 0
    assert dispatch(["no_such_command"]) == 1
    out = capsys.readouterr().out
    from mmidv1_tpu.cli import COMMANDS as JCOMMANDS
    assert list(COMMANDS) == list(JCOMMANDS)
    for name in JCOMMANDS:
        assert f"  {name}\n" in out
    for spec in COMMANDS.values():
        module = spec[0] if isinstance(spec, tuple) else spec
        assert module.startswith("mmidv1_tpu_torch.cli.")
    assert "calibrate_spain" not in str(COMMANDS)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the raise on a host without a card")
@pytest.mark.parametrize("command", [c for c in COMMANDS if "sir" in c])
def test_sir_entry_points_need_the_card_by_default(tmp_path, command):
    """Without ``--device cpu`` each SIR entry point asks for the card, and
    raises on a host without one before it reads or writes anything."""
    out = tmp_path / "never-written"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dispatch([command, "--output-dir", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("command,variant,csv", [
    ("sir_model", "deterministic", "sir_result.csv"),
    ("sir_pop_var", "popvar", "sir_variable_population_result.csv")])
def test_scalar_mains_match_jax(tmp_path, capsys, command, variant, csv):
    from mmidv1_tpu.cli.sir_mains import main as jmain

    assert jmain([variant, "--params", CONFIG, "--project-root",
                  str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr().out
    assert dispatch([command, "--params", CONFIG, "--x64", "--device", "cpu",
                     "--output-dir", str(tmp_path / "torch")]) == 0
    tout = capsys.readouterr().out
    jh, a = _read(tmp_path / "jax" / "data" / "output" / csv)
    th, b = _read(tmp_path / "torch" / csv)
    assert th == jh == "t,S,I,R"
    assert b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=1e-9)
    # the printout (sir_pop_var's equilibria) without the log lines
    printed = lambda out: [ln for ln in out.splitlines() if "[INFO]" not in ln]
    assert printed(tout) == printed(jout)


def test_stochastic_main_invariants(tmp_path, capsys):
    from mmidv1_tpu.cli.sir_mains import main as jmain

    cfg = tmp_path / "p.txt"
    cfg.write_text("N 500\nbeta 0.5\ngamma 0.1\nS0 490\nI0 10\nR0 0\n"
                   "t_start 0\nt_end 12\nh 0.05\nnumSimulations 7\n")
    assert jmain(["stochastic", "--params", str(cfg), "--project-root",
                  str(tmp_path / "jax")]) == 0
    assert dispatch(["sir_stochastic", "--params", str(cfg), "--device", "cpu",
                     "--output-dir", str(tmp_path / "torch"), "--seed",
                     "3"]) == 0
    capsys.readouterr()
    jdir, tdir = tmp_path / "jax" / "data" / "output", tmp_path / "torch"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert len(os.listdir(tdir)) == 7 + 1
    jh, a = _read(jdir / "stochastic_sir_stats.csv")
    th, s = _read(tdir / "stochastic_sir_stats.csv")
    assert th == jh and s.shape == a.shape == (241, 13)
    np.testing.assert_array_equal(s[:, 0], a[:, 0])
    mean, median, p05, p95 = (s[:, 1 + 3 * k:4 + 3 * k] for k in range(4))
    assert (p05 <= median).all() and (median <= p95).all()
    np.testing.assert_allclose(mean.sum(axis=1), 500.0, rtol=1e-5)
    for k in range(7):
        h, sim = _read(tdir / f"stochastic_sir_sim_{k}.csv")
        assert h == "t,S,I,R" and sim.shape == (241, 4)
        assert (sim[:, 1:] >= 0).all()
        np.testing.assert_allclose(sim[:, 1:].sum(axis=1), 500.0, rtol=0,
                                   atol=1e-3)


def test_age_structured_main_matches_jax(tmp_path, capsys):
    """The adaptive baseline and the intervention demo, float64 on both
    sides; the intervention flattens the peak."""
    from mmidv1_tpu.cli.sir_age_structured_main import main as jmain

    root = _project(tmp_path)
    assert jmain(["--days", "40", "--project-root", root]) == 0
    jout = capsys.readouterr().out
    assert dispatch(["sir_age_structured_main", "--days", "40", "--x64",
                     "--device", "cpu", "--project-root", root,
                     "--output-dir", str(tmp_path / "torch")]) == 0
    tout = capsys.readouterr().out
    peak = lambda out, k: float(out.split(f"peak_infected_{k}")[1].split()[0])
    base, interv = peak(tout, "baseline"), peak(tout, "intervention")
    assert base > interv > 0
    assert (base, interv) == (peak(jout, "baseline"), peak(jout, "intervention"))
    for csv in ("sir_age_baseline_results.csv",
                "sir_age_intervention_results.csv"):
        jh, a = _read(tmp_path / "data" / "output" / csv)
        th, b = _read(tmp_path / "torch" / csv)
        assert th == jh and b.shape == a.shape == (41, 13)
        np.testing.assert_allclose(b, a, rtol=1e-9)


def test_calibration_demo_writes_both_csvs(tmp_path, capsys):
    """``tests/test_cli.py:213-238`` on the port (float32, as from the
    shell): the two CSVs in the JAX formats."""
    root = _project(tmp_path)
    assert dispatch(["sir_age_structured_calibration_demo", "--device", "cpu",
                     "--project-root", root, "--hill-iters", "3",
                     "--mcmc-iters", "6", "--burn-in", "2", "--chains", "4",
                     "--num-days", "12"]) == 0
    assert "Best Objective Value:" in capsys.readouterr().out
    out = tmp_path / "data" / "calibration_output"
    h, samples = _read(out / "mcmc_samples.csv")
    assert h == ("sample_index,objective_value,q,scale_C_total,gamma_0,"
                 "gamma_1,gamma_2,gamma_3")
    assert samples.shape == (6 * 4, 8) and np.isfinite(samples).all()
    np.testing.assert_array_equal(samples[:, 0], np.arange(24))
    sim = (out / "simulated_incidence_best_fit.csv").read_text().splitlines()
    assert sim[0] == ("Time,simulated_I_0_30,simulated_I_30_60,"
                      "simulated_I_60_80,simulated_I_80_plus")
    assert len(sim) == 13   # 12 days + header
    vals = [float(v) for v in sim[1].split(",")[1:]]
    assert all(v >= 0 for v in vals)
