"""The benchmark's files: everything ``BENCHMARK.json`` names is found by
its name, and every name, unit and line keeps to the contract's alphabet
and lengths."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"][1] == "h100_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert NAME.match(cfg["name"])
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["source"].startswith("https://")
    path = os.path.join(ROOT, cfg["file"])
    assert cfg["file"] == f"h100_bench/configs/{cfg['name']}.json"
    with open(path) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"] == []
    assert body["source"] == cfg["source"]
    for key in ("tableau", "substeps", "dtype", "observed_days", "runup_days",
                "schedule_runs", "data", "map", "posterior_cov"):
        assert key in body
    assert os.path.isdir(os.path.join(HERE, body["data"], "data", "configuration"))
    for line in (cfg["source"], cfg["why"]):
        assert 1 <= len(line) <= 200 and "\n" not in line and "\t" not in line
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert NAME.match(cell) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    with open(os.path.join(HERE, "cells", f"{cell}.json")) as f:
        body = json.load(f)
    assert (body["name"], body["config"], body["traffic"], body["why"]) == \
        (cell, w["config"], w["traffic"], w["why"])
    assert os.path.exists(os.path.join(HERE, "samplers", f"{body['sampler']}.py"))
    assert set(body["limits"]) >= {"value_gap", "value_gap_p99",
                                   "floor_mismatch", "unmoved_share"}
    reported = [m for m in METRICS if "workloads" not in m or cell in m["workloads"]]
    assert {"setup_s", "draws_per_s"} <= {m["name"] for m in reported}
    assert any(m in BENCH["per_layer"] for m in reported)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    keys = {"name", "unit", "better", "source", "workloads"}
    keys |= {"layer", "moves"} if metric in BENCH["per_layer"] else {"bound"}
    assert set(metric) <= keys and set(metric) >= keys - {"workloads"}
    assert metric["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(HERE, "metrics", f"{metric['name']}.py"))
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["per_layer"]:
        assert metric["moves"] == "draws_per_s"
        assert 1 <= len(metric["layer"]) <= 200
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
        with open(os.path.join(HERE, "metrics", f"{metric['name']}.json")) as f:
            assert json.load(f)["patterns"]


def test_file_names():
    """Every file under the benchmark is named from a name's characters."""
    for dirpath, _dirs, files in os.walk(HERE):
        if "__pycache__" in dirpath:
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
