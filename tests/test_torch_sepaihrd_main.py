"""The PyTorch port's primary executable against the JAX package's, on the
CPU at a tiny size, and the copied NumPy helpers it writes with.

``sepaihrd_main`` of each package runs with the same arguments (30 observed
days, 8 chains, ``--scale 0.002``, 2 substeps, 4 PPC draws, float64): both
return 0 and write the same set of files. The calibration's numbers differ
(the random streams differ), so those files are held by their headers and
shapes; the baseline simulation is deterministic and is held by its values. ``fileutils`` and
``save_results_csv`` are copies: equal results and identical bytes.
"""

import os

import numpy as np
import pytest
import torch

from mmidv1_tpu.models import results as jres
from mmidv1_tpu.utils import fileutils as jfu

from mmidv1_tpu_torch.models import results as tres
from mmidv1_tpu_torch.utils import exceptions as texc
from mmidv1_tpu_torch.utils import fileutils as tfu

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--num-days", "30", "--chains", "8", "--scale", "0.002",
        "--substeps", "2", "--ppc-samples", "4", "--x64", "--project-root", REPO]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both mains once, with their printed lines."""
    import contextlib
    import io

    from mmidv1_tpu.cli.sepaihrd_main import main as jmain
    from mmidv1_tpu_torch.cli.sepaihrd_main import main as tmain

    out = {}
    for name, fn, extra in (("jax", jmain, ["--platform", "cpu"]),
                            ("port", tmain, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(ARGS + extra + ["--output-dir", str(d)])
        out[name] = dict(rc=rc, dir=str(d), files=_files(str(d)),
                         lines=buf.getvalue().strip().splitlines())
    return out


def test_main_writes_the_same_files_as_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert j["rc"] == 0 and t["rc"] == 0
    assert t["files"] == j["files"]
    for rel in ("sepaihrd_age_baseline_results.csv",
                "calibrated_parameters.txt",
                "sepaihrd_age_calibrated_results.csv",
                "mcmc_aggregated/metrics_summary.csv",
                "posterior_predictive/daily_deaths_median.csv",
                "scenarios/scenario_comparison.csv"):
        assert rel in t["files"], rel
    # every CSV has the JAX file's header and row count
    for rel in t["files"]:
        if not rel.endswith(".csv"):
            continue
        with open(os.path.join(t["dir"], rel)) as f:
            tl = f.read().splitlines()
        with open(os.path.join(j["dir"], rel)) as f:
            jl = f.read().splitlines()
        assert tl[0] == jl[0] and len(tl) == len(jl), rel


def test_main_prints_the_same_last_two_lines(runs):
    for name in ("jax", "port"):
        lines = runs[name]["lines"]
        assert lines[-2].startswith("best_loglikelihood ")
        assert lines[-1].startswith("R0 ")
        assert np.isfinite(float(lines[-2].split()[1]))
        assert float(lines[-1].split()[1]) > 0


def test_main_baseline_simulation_matches_jax(runs):
    """The baseline run at the initial guess is deterministic: the same
    float64 solve on both sides, CSV to CSV (10 significant digits written,
    so rtol 1e-9)."""
    a, b = (np.loadtxt(os.path.join(runs[n]["dir"],
                                    "sepaihrd_age_baseline_results.csv"),
                       delimiter=",", skiprows=1) for n in ("port", "jax"))
    assert a.shape == b.shape == (50, 45)
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300)


def test_main_needs_the_card_unless_told_otherwise():
    """The default device is the card; without one the entry point raises
    instead of running on the host."""
    from mmidv1_tpu_torch.cli.sepaihrd_main import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(ARGS)


def test_fileutils_copy_matches_jax(tmp_path):
    assert tfu.get_project_root(REPO) == jfu.get_project_root(REPO) == REPO
    assert tfu.get_project_root(os.path.join(REPO, "mmidv1_tpu_torch", "ops")) \
        == REPO
    assert tfu.join_paths("a", "b", "c.csv") == jfu.join_paths("a", "b", "c.csv")
    d = str(tmp_path / "x" / "y")
    assert tfu.ensure_directory_exists(d) == jfu.ensure_directory_exists(d) == d
    assert os.path.isdir(d)
    assert tfu.get_output_path("f.csv", "out", root=str(tmp_path)) == \
        jfu.get_output_path("f.csv", "out", root=str(tmp_path))
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(texc.FileIOException):
        tfu.ensure_directory_exists(str(blocker / "sub"))


def test_results_copy_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    traj = rng.uniform(0, 1e6, (7, 11, 4))
    ts = np.arange(-3.0, 4.0)
    comps = ("S", "E", "P", "A", "I", "H", "ICU", "R", "D", "CumH", "CumICU")
    assert tres.state_names(comps, 4) == jres.state_names(comps, 4)
    np.testing.assert_array_equal(tres.compartment_data(traj, comps, "ICU"),
                                  jres.compartment_data(traj, comps, "ICU"))
    tres.save_results_csv(str(tmp_path / "t.csv"), ts, traj, comps)
    jres.save_results_csv(str(tmp_path / "j.csv"), ts, traj, comps)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    for bad in (lambda: tres.compartment_data(traj, comps, "X"),
                lambda: tres.save_results_csv(str(tmp_path / "b.csv"), ts[:3],
                                              traj, comps),
                lambda: tres.save_results_csv(str(tmp_path / "b.csv"), ts,
                                              traj, comps[:5])):
        with pytest.raises(texc.InvalidResultException):
            bad()
