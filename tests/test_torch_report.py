"""The PyTorch port's post-calibration report against the JAX package's, in
float64 on the CPU.

Both ``generate_full_report`` run on the same 16 draws of the 62-name
Spain-2020 space (30 observed days, 2 substeps, batches of 8, 4 PPC draws).
They must write the same set of files, and every number must agree at rtol
1e-9: in memory, and in the CSV text up to one unit of the last printed
digit (both sides round the same values to the same format). The replay is
the same float64 solve on both sides; the metrics sum in other orders
(rtol 1e-10 in ``test_torch_analysis.py``), and the quantiles and pooling
are the same NumPy code.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.analysis import generate_full_report as jreport
from mmidv1_tpu.cli.common import load_spain_pipeline

from mmidv1_tpu_torch.analysis import generate_full_report as treport
from mmidv1_tpu_torch.cli.common import \
    load_spain_pipeline as load_torch_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, REPO)
import report_anchor as ra  # noqa: E402
from report_anchor import compare_file  # noqa: E402
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402

torch.set_num_threads(1)
KW = dict(num_samples_for_ppc=4, batch_size=8, substeps=2, seed=3)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    pipe = load_spain_pipeline(REPO, dtype=jnp.float64, num_days=30)
    tparams = to_torch_params(pipe.params)
    tspace = to_torch_space(pipe.space, tparams)
    tdata = load_torch_pipeline(REPO, num_days=30, dtype=torch.float64,
                                device="cpu").data
    rng = np.random.default_rng(17)
    sig = np.asarray(pipe.space.sigmas)
    samples = np.asarray(pipe.theta0)[None, :] + \
        0.05 * sig * rng.standard_normal((16, sig.size))
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    j = jreport(samples, pipe.space, pipe.params, pipe.data, pipe.ts, jdir,
                **KW)
    t = treport(samples, tspace, tparams, tdata, pipe.ts, tdir, **KW)
    return dict(j=j, t=t, jdir=jdir, tdir=tdir)


def test_report_writes_the_same_files(reports):
    files = _files(reports["tdir"])
    assert files == _files(reports["jdir"])
    assert len(files) == 36 + 2 + 2 + 1 + 1 + 2 + 1   # 2 batches of 8
    assert "mcmc_batches/batch_1.csv" in files


def test_report_csv_numbers_match_jax(reports):
    for rel in _files(reports["tdir"]):
        err, where, n = compare_file(os.path.join(reports["tdir"], rel),
                                     os.path.join(reports["jdir"], rel))
        assert n > 0 and err <= 1e-9, (rel, err, where)


def _close(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _close(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{what}[{i}]")
    elif isinstance(a, str):
        assert a == b, what
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-9,
                                   atol=1e-300, err_msg=what)


@pytest.mark.parametrize("key", ["summary", "ppc", "rt_bands", "sero_bands",
                                 "ene_covid", "scenarios", "n_draws"])
def test_report_results_match_jax(reports, key):
    _close(reports["t"][key], reports["j"][key], key)


def test_anchor_bar_for_every_group():
    assert set(ra.GROUP_RTOL) == set(ra.GROUPS)
    assert max(ra.GROUP_RTOL.values()) <= 1e-3


@pytest.mark.parametrize("group,pattern,rel", [
    ("rt_trajectories", "rt_trajectories/*.csv", 1e-4),
    ("metrics_summary", "mcmc_aggregated/metrics_summary.csv", 1e-4),
    ("posterior_predictive", "posterior_predictive/*.csv", 2e-3),
])
def test_anchor_flags_a_group_above_its_bar(tmp_path, group, pattern, rel):
    """The committed tree against itself reads 0 in every group; one value
    moved by ``rel`` (relative, well beyond the last printed digit) puts its
    group, and only it, above its bar."""
    import glob
    import shutil
    ref = ra.COMMITTED
    got = tmp_path / "tree"
    for g in ra.GROUPS.values():
        for pat in g:
            for f in glob.glob(os.path.join(ref, pat)):
                dst = got / os.path.relpath(f, ref)
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(f, dst)
    same = ra.compare_trees(str(got))
    assert all(r["max_err"] == 0.0 for r in same.values())
    assert ra.over_bar(same) == {}
    target = sorted(glob.glob(str(got / pattern)))[0]
    with open(target) as f:
        lines = f.read().splitlines()
    cells = lines[1].split(",")
    j = max(i for i, c in enumerate(cells)
            if c.replace(".", "").replace("-", "").replace("e", "").isdigit()
            and float(c) != 0.0)
    cells[j] = repr(float(cells[j]) * (1 + rel))
    lines[1] = ",".join(cells)
    with open(target, "w") as f:
        f.write("\n".join(lines) + "\n")
    assert set(ra.over_bar(ra.compare_trees(str(got)))) == {group}
