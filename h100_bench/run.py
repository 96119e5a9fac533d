"""The benchmark of ``mmidv1_tpu_torch`` on the NVIDIA H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of a cell on one chip is one process: it loads the cell's
configuration and the frozen Spain-2020 tree, builds the program's kernels
(only the first run in a checkout compiles: nvcc's libraries are keyed by
a hash of their sources in ``mmidv1_tpu_torch/build/``), warms up,
measures for ``--seconds`` (to the first whole unit after it), then checks
the window's final states against the plain reference and prints one JSON
line. With ``--trace 1`` a traced window of the cell's ``trace_units``
units follows the timed one and the line carries the per-layer metrics
instead of the end-to-end ones.

A cell whose ``chips`` is W > 1 runs as one process a rank
(``ranks.py``): this process is rank 0, builds the kernels, starts ranks
1 … W−1 with the same arguments, and every rank starts its process group
as users do (``parallel.multihost.initialize``: ``nccl`` on cards, ``gloo``
on the host). Each rank's driver runs its share of the cell's chains on
its own card, one window spans them all (``window.py``), and after it rank
0 gathers every rank's final rows, checks all of them against the
reference and alone prints the line: ``device.count`` W, the fullest
rank's memory peak with each rank's beside it. A rank that fails ends the
run with no line. A cell with one chip takes none of this: no process
group, no child, no collective.

Everything belonging to one cell, configuration or metric is a file found
by its name: ``cells/<cell>.json``, ``configs/<config>.json``,
``samplers/<sampler>.py``, ``metrics/<metric>.py``; which metrics a cell
reports comes from ``BENCHMARK.json``. A run without a CUDA card fails.

For the harness's own tests, ``--device cpu`` rehearses on the host
(``gloo`` ranks), ``--overrides`` takes the JSON of ``execute``'s
``overrides`` and ``--driver`` a sampler driver's file in place of the
cell's.
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


def cell_files(workload: str, overrides: dict = None):
    """The cell's and its configuration's files, with ``overrides`` in
    place of their keys (a key the cell lacks and the configuration has is
    the configuration's) and ``num_days`` cutting the configuration's
    ``observed_days``: ``(cell, config, num_days)``."""
    cell = load_json("cells", f"{workload}.json")
    config = load_json("configs", f"{cell['config']}.json")
    overrides = dict(overrides or {})
    num_days = overrides.pop("num_days", None)
    for k, v in overrides.items():
        (config if k in config and k not in cell else cell)[k] = v
    if num_days is not None:
        config["observed_days"] = num_days
    return cell, config, num_days


def sampler_of(cell: dict, driver: str = None):
    """The module of the cell's sampler driver (``samplers/<sampler>.py``),
    or of the file ``driver``."""
    path = driver or os.path.join(HERE, "samplers", f"{cell['sampler']}.py")
    name = os.path.splitext(os.path.basename(path))[0]
    return load_module(path, f"h100_bench.samplers.{name}")


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
            extra=None, driver: str = None) -> dict:
    """One run of ``workload``: ``{"correct", "attempted", "failed",
    "metrics", "device", ...}`` as the result line has it (``metrics``
    from the readers, by name). ``overrides`` replaces cell and
    configuration keys (the CPU rehearsal's small sizes, with the
    configuration's ``observed_days`` cut by ``num_days``); ``sabotage(driver)``
    may break the timed path underneath (the harness's own tests);
    ``extra(final, config, cell, device, num_days)`` adds its dict under ``"extra"``
    after the check (the control's readings, ``control.py``); ``driver`` is
    a sampler driver's file in place of the cell's (its module's ``extra``,
    where it has one, stands in for a missing ``extra``). On the host
    ``metrics`` stays empty and the readers' values go under
    ``"rehearsal"``: a host number is no card's.

    In a process group of W > 1 ranks (started by :func:`main`) every rank
    calls this; rank 0 returns the line and the others None."""
    import torch

    sys.path.insert(0, ROOT)
    from h100_bench import check, program
    from h100_bench.window import Window

    cell, config, num_days = cell_files(workload, overrides)
    chips = int(cell.get("chips", 1))
    dev = torch.device(device)
    if chips > 1 and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    sampler = sampler_of(cell, driver)
    if extra is None:
        extra = getattr(sampler, "extra", None)
    if dev.type == "cuda":
        program.build_kernels(sampler.KERNEL_LIBS)
    setup = program.Setup(config, dev, num_days=num_days)
    mesh = setup.mesh
    if mesh.world_size != chips:
        raise RuntimeError(f"the cell asks for {chips} chip(s); the process "
                           f"group has {mesh.world_size} rank(s)")
    win = Window(seconds=seconds, trace=trace, trace_units=int(cell["trace_units"]),
                 device=dev, t_process=T_PROCESS, mesh=mesh)
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
        runner = sampler.Driver(setup, cell, seed, win, tmp)
        if sabotage is not None:
            sabotage(runner)
        runner.run()
    if not win.closed:
        raise RuntimeError("the runner ended before the window closed")
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = None
    if win.profiler is not None:
        from h100_bench.trace import summarize
        summary = summarize(win.profiler)
    win.profiler = None
    final = runner.final()
    final = {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
             for k, v in final.items()}
    runner.free()
    del runner, setup
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    by_rank = None
    if chips > 1:
        import torch.distributed as dist
        from h100_bench import ranks

        final, by_rank = ranks.gather(final, dict(
            units=win.timed.units, iterations=win.timed.iterations,
            calls=win.timed.calls, memory_peak_bytes=int(mem_peak)))
        dist.destroy_process_group()
        if mesh.rank != 0:
            return None
        if len({(r["units"], r["iterations"]) for r in by_rank}) != 1:
            raise RuntimeError(f"the ranks left the runner at different units: {by_rank}")
        # the harness's count of the work is every rank's; the device-trace
        # readers keep rank 0's own (traced) calls beside rank 0's trace
        calls = {}
        for r in by_rank:
            for B, n in r["calls"].items():
                calls[B] = calls.get(B, 0) + n
        win.timed.calls = calls

    # the reference, after the window and with the program's state freed
    limits = cell["limits"]
    ref = check.reference_for(config, os.path.join(HERE, config["data"]),
                              device=dev, num_days=num_days)
    vr = check.values(ref, final["x"], int(cell["ref_block"]))
    del ref
    nums, n_bad = check.numbers(final, vr, limits)
    correct, _failed, checks = check.judge(nums, limits)

    rec = Record(cell=cell, config=config, chains=int(cell["chains"]), chips=chips,
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
        if chips > 1:
            out["device"] = {"count": chips}
    else:
        out["metrics"] = metrics
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                         "count": chips, "memory_peak_bytes": int(mem_peak)}
        if chips > 1:
            peaks = [r["memory_peak_bytes"] for r in by_rank]
            out["device"].update(memory_peak_bytes=max(peaks),
                                 memory_peak_bytes_by_rank=peaks)
        if summary is not None:
            # rank 0's trace alone
            out["device"].update(busy_s=summary.busy_s(), window_s=summary.window_s)
            out["breakdown"] = {"device_ops": summary.top_ops(),
                                "idle_gaps": summary.idle_gaps()}
    out["window"] = {"units": win.timed.units, "iterations": win.timed.iterations,
                     "seconds": win.timed.seconds}
    if chips > 1:
        out["window"]["units_by_rank"] = [r["units"] for r in by_rank]
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
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=argparse.SUPPRESS)
    p.add_argument("--overrides", type=json.loads, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--driver", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    cell, _config, _days = cell_files(args.workload, args.overrides)
    import torch
    chips = int(cell.get("chips", 1))
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        print(f"h100_bench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run_args = (args.workload, args.seed, args.seconds, bool(args.trace))
    run_kw = dict(device=args.device, overrides=args.overrides, driver=args.driver)
    if chips == 1:
        out = execute(*run_args, **run_kw)
    else:
        import datetime

        sys.path.insert(0, ROOT)
        from h100_bench import program, ranks
        from mmidv1_tpu_torch.parallel import multihost

        timeout = ranks.timeout_s(args.seconds)
        group = dict(device=args.device, timeout=datetime.timedelta(seconds=timeout))
        if ranks.child_rank() is not None:
            ranks.watch_parent()
            multihost.initialize(**group)
            execute(*run_args, **run_kw)
            return forbidden_loaded()
        if args.device == "cuda":       # before any other rank starts
            program.build_kernels(sampler_of(cell, args.driver).KERNEL_LIBS)
        with ranks.Launch(chips, os.path.abspath(__file__), argv) as launch:
            multihost.initialize(**group)
            out = execute(*run_args, **run_kw)
            codes = launch.wait(timeout)
        if any(c != 0 for c in codes):
            print(f"h100_bench: ranks 1-{chips - 1} exited with {codes}",
                  file=sys.stderr)
            return 1
    code = forbidden_loaded()
    if code:
        return code
    out["power_limit"] = power_limit()
    out["checks"] = out.pop("checks")            # the compared numbers come last
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def forbidden_loaded() -> int:
    """3 (and what it found, on standard error) where this process has
    loaded JAX or the JAX package, else 0."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"h100_bench: the run loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
