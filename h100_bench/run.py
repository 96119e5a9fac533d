"""The benchmark of ``mmidv1_tpu_torch`` on the NVIDIA H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it loads the cell's configuration and the frozen
Spain-2020 tree, builds the program's kernels (only the first run in a
checkout compiles: nvcc's libraries are keyed by a hash of their sources in
``mmidv1_tpu_torch/build/``), warms up, measures for ``--seconds`` (to the
first whole unit after it), then checks the window's final states against
the plain reference and prints one JSON line. With ``--trace 1`` a traced
window of the cell's ``trace_units`` units follows the timed one and the
line carries the per-layer metrics instead of the end-to-end ones.

Everything belonging to one cell, configuration or metric is a file found
by its name: ``cells/<cell>.json``, ``configs/<config>.json``,
``samplers/<sampler>.py``, ``metrics/<metric>.py``; which metrics a cell
reports comes from ``BENCHMARK.json``. A run without a CUDA card fails.
"""

import time

T_PROCESS = time.perf_counter()         # set-up is counted from here

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mmidv1_tpu")


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(workload: str):
    cell = load_json("cells", f"{workload}.json")
    config = load_json("configs", f"{cell['config']}.json")
    return cell, config


def metrics_of(bench: dict, workload: str, group: str):
    """The metrics of ``group`` (``end_to_end`` or ``per_layer``) that
    ``workload`` reports."""
    return [m for m in bench[group]
            if "workloads" not in m or workload in m["workloads"]]


class Record:
    """What the metric readers take."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", overrides: dict = None, sabotage=None,
            extra=None) -> dict:
    """One run of ``workload``: ``{"correct", "attempted", "failed",
    "metrics", "device", ...}`` as the result line has it (``metrics``
    from the readers, by name). ``overrides`` replaces cell and
    configuration keys (the CPU rehearsal's small sizes, with the
    configuration's ``observed_days`` cut by ``num_days``); ``sabotage(driver)``
    may break the timed path underneath (the harness's own tests);
    ``extra(final, config, cell, device, num_days)`` adds its dict under ``"extra"``
    after the check (the control's readings, ``control.py``). On the host
    ``metrics`` stays empty and the readers' values go under
    ``"rehearsal"``: a host number is no card's."""
    import torch

    sys.path.insert(0, ROOT)
    from h100_bench import check, program
    from h100_bench.window import Window

    cell, config = cell_files(workload)
    overrides = dict(overrides or {})
    num_days = overrides.pop("num_days", None)
    cell.update(overrides)
    if num_days is not None:
        config = dict(config, observed_days=num_days)
    dev = torch.device(device)
    sampler = load_module(os.path.join(HERE, "samplers", f"{cell['sampler']}.py"),
                          f"h100_bench.samplers.{cell['sampler']}")
    if dev.type == "cuda":
        program.build_kernels(sampler.KERNEL_LIBS)
    setup = program.Setup(config, dev, num_days=num_days)
    win = Window(seconds=seconds, trace=trace, trace_units=int(cell["trace_units"]),
                 device=dev, t_process=T_PROCESS)
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
        driver = sampler.Driver(setup, cell, seed, win, tmp)
        if sabotage is not None:
            sabotage(driver)
        driver.run()
    if not win.closed:
        raise RuntimeError("the runner ended before the window closed")
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = None
    if win.profiler is not None:
        from h100_bench.trace import summarize
        summary = summarize(win.profiler)
    win.profiler = None
    final = driver.final()
    final = {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
             for k, v in final.items()}
    driver.free()
    del driver, setup
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, after the window and with the program's state freed
    limits = cell["limits"]
    ref = check.reference_for(config, os.path.join(HERE, config["data"]),
                              device=dev, num_days=num_days)
    vr = check.values(ref, final["x"], int(cell["ref_block"]))
    del ref
    nums, n_bad = check.numbers(final, vr, limits)
    correct, _failed, checks = check.judge(nums, limits)

    rec = Record(cell=cell, config=config, chains=int(cell["chains"]),
                 timed=win.timed, traced=win.traced, trace=summary,
                 setup_s=win.setup_s, cuda=dev.type == "cuda")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, workload, group):
        reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                             f"h100_bench.metrics.{m['name']}")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(final["x"].shape[0]),
           "failed": n_bad, "metrics": {}, "device": {}}
    if dev.type != "cuda":
        # the rehearsal's readings, under no metric's name
        out["rehearsal"] = {name: m["value"] for name, m in metrics.items()}
    else:
        out["metrics"] = metrics
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                         "count": 1, "memory_peak_bytes": int(mem_peak)}
        if summary is not None:
            out["device"].update(busy_s=summary.busy_s(), window_s=summary.window_s)
            out["breakdown"] = {"device_ops": summary.top_ops(),
                                "idle_gaps": summary.idle_gaps()}
    out["window"] = {"units": win.timed.units, "iterations": win.timed.iterations,
                     "seconds": win.timed.seconds}
    if extra is not None:
        out["extra"] = extra(final, config, cell, dev, num_days)
    out["checks"] = checks
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell, _config = cell_files(args.workload)
    import torch
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"h100_bench: the run loaded {found}", file=sys.stderr)
        return 3
    out["power_limit"] = power_limit()
    out["checks"] = out.pop("checks")            # the compared numbers come last
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
