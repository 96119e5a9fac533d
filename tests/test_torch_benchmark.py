"""The port's ``sepaihrd_objective_benchmark`` on the host at a tiny size:
every key the JAX package's bench prints, each finite, plus the min and max
beside each micro median."""

import ast
import json
import math
import os

from mmidv1_tpu_torch.cli import benchmark_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--num-days", "30", "--tableau", "rk4",
        "--substeps", "1", "--batch", "8", "--chains", "8", "--iterations",
        "2", "--repeats", "2"]


def _jax_keys():
    """The result keys of ``mmidv1_tpu/cli/benchmark_main.py``: its initial
    ``results`` dict and every ``results["..."] =``."""
    with open(os.path.join(REPO, "mmidv1_tpu", "cli", "benchmark_main.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "results" and \
                        isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys}
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "results":
                    keys.add(tgt.slice.value)
    return keys


def test_bench_all_modes_json_has_jax_keys(capsys):
    assert benchmark_main.main(TINY + ["--mode", "all", "--json"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    want = _jax_keys()
    assert len(want) >= 20 and "micro_evals_per_sec_inscan" in want
    assert want <= set(res), want - set(res)
    for k, v in res.items():
        if isinstance(v, float):
            assert math.isfinite(v), k
    for base in ("micro_evals_per_sec", "micro_us_per_eval",
                 "micro_evals_per_sec_inscan", "micro_us_per_eval_inscan"):
        assert res[base + "_min"] <= res[base] <= res[base + "_max"], base
    assert res["device"] == "cpu/cpu" and res["n_params"] == 62
    assert res["pso_evals"] == 8 * (2 + 2)
    assert 0.0 <= res["mcmc_mean_acceptance"] <= 1.0
    assert res["hillmcmc_best_logl"] >= res["hillmcmc_hill_best_logl"]


def test_bench_micro_profile_and_text_output(tmp_path, capsys):
    prof = str(tmp_path / "prof")
    assert benchmark_main.main(TINY + ["--mode", "micro", "--x64",
                                       "--profile", prof]) == 0
    out = capsys.readouterr().out
    assert "dtype: float64" in out and "micro_evals_per_sec_inscan:" in out
    assert os.path.exists(os.path.join(prof, "micro_trace.json"))
