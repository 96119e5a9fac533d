"""The port's ``cli/mala_rematch.py`` on the host (the kernels' plain
versions), against ``scripts/mala_rematch.py``:

- ``main`` at 4 chains and 6 steps on a 20-day window writes the script's
  JSON: the same keys, one row a sampler in the script's order, every
  number finite;
- its ESS rate is the script's formula (the chains thinned to at most 256,
  ``mmidv1_tpu.analysis.diagnostics.summarize``) on one fixed array;
- the last slice's modules import nothing of JAX, the JAX package,
  ``scripts/`` or pandas.
"""

import json
import os

import numpy as np
import pytest

from mmidv1_tpu.analysis.diagnostics import summarize as jax_summarize
from mmidv1_tpu_torch.cli import mala_rematch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_writes_the_scripts_json(tmp_path):
    out = tmp_path / "rematch.json"
    assert mala_rematch.main(["--device", "cpu", "--num-days", "20",
                              "--chains", "4", "--steps", "6", "--burn", "2",
                              "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    with open(os.path.join(REPO, "results", "mala_rematch.json")) as f:
        ref = json.load(f)                   # written by the JAX script
    assert list(got) == list(ref)
    assert list(got["config"]) == list(ref["config"])
    assert got["config"] == dict(chains=4, steps=6, burn=2, substeps=3,
                                 tableau="cash_karp")
    assert len(got["rows"]) == len(ref["rows"]) == 5
    for g, r in zip(got["rows"], ref["rows"]):
        assert list(g) == list(r)
        assert all(np.isfinite(v) for k, v in g.items() if k != "sampler")
        assert 0.0 <= g["acceptance"] <= 1.0
    names = [r["sampler"] for r in got["rows"]]
    assert names[0] == "ensemble AM-MH (K1 objective)"
    assert names[1].startswith("MALA RM-adapted (eps->")
    assert names[2:] == [r["sampler"] for r in ref["rows"][2:]]


def test_ess_per_sec_is_the_scripts_formula():
    rng = np.random.default_rng(7)
    B, T, burn, wall = 600, 40, 10, 3.5
    samples = np.cumsum(rng.normal(size=(T, B, 5)), axis=0) * 0.1 \
        + rng.normal(size=(T, B, 5))
    names = [f"p{j}" for j in range(5)]
    # scripts/mala_rematch.py:107-112
    sub = samples[burn:, ::max(1, samples.shape[1] // 256), :]
    d = jax_summarize(np.asarray(sub), names)
    ess = min(v["ess"] for v in d.values())
    rh = max(v["rhat"] for v in d.values())
    got = mala_rematch.ess_per_sec(samples, wall, burn, names)
    np.testing.assert_allclose(got, (ess, ess / wall, rh), rtol=1e-12)
    assert sub.shape[1] == 300


@pytest.mark.parametrize("module", [
    "utils/native.py", "cli/data_visualization.py", "cli/mala_rematch.py",
    "cli/_sero_probe.py", "cli/sero_profile_probe.py",
    "cli/sero_ridge_scan.py", "cli/sero_sensitivity.py",
    "cli/sero_force_profile.py"])
def test_last_slice_imports_no_jax(module):
    """The last slice's modules import nothing of JAX, of the JAX package
    or of ``scripts/``, at the top or inside a function."""
    import ast
    with open(os.path.join(REPO, "mmidv1_tpu_torch", module)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names
           if m.split(".")[0] in ("jax", "mmidv1_tpu", "scripts", "pandas")]
    assert not bad, bad
