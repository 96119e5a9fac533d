"""A cell's traced run with the program's own tracer on.

    python3 h100_bench/program_trace.py --workload <cell> --seed <n> --seconds <s>

The run is ``run.py --trace 1``'s with the program's tracer
(``mmidv1_tpu_torch.utils.trace``) switched on by the window
(:class:`ProgramWindow`): reset and on when the timed window opens, its
snapshot kept on the timed phase (``Phase.program``) when it closes; reset
and on with ``profile=True`` when the traced window opens, so that every
program span is a ``record_function("mmid.<name>")`` range in the profile,
its snapshot kept on the traced phase, and off after it. The breakdown's
idle gaps go to the innermost span of either kind (``bench.*`` or
``mmid.*``) that holds a gap's midpoint (:func:`innermost_gaps`).

The result line is run.py's, with ``program``: the readers of the snapshot
(``PROGRAM_METRICS``, files under ``metrics/``), the tracer's K1 launches
in the timed window beside the harness's own count of the objective's
calls, both by chain count, every idle gap by span, and both snapshots.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from h100_bench import run, trace as bench_trace, window as bench_window  # noqa: E402
from h100_bench.trace import TraceSummary  # noqa: E402

PROGRAM_METRICS = ("prep_host_ms", "launch_host_ms", "draws_host_ms",
                   "sampler_self_ms", "checkpoint_bytes")
HARNESS_SUMMARIZE = bench_trace.summarize    # :func:`execute` puts ours in its place


def tracer():
    from mmidv1_tpu_torch.utils import trace
    return trace


class ProgramWindow(bench_window.Window):
    """The benchmark's window, switching the program's tracer on in traced
    runs only."""

    def start(self):
        if self.trace:
            tracer().reset()
            tracer().enable()
        super().start()

    def _close(self, phase):
        super()._close(phase)
        if self.trace:
            phase.program = tracer().snapshot()

    def _start_trace(self):
        tracer().reset()
        tracer().enable(profile=self.cuda)
        super()._start_trace()

    def _stop_trace(self):
        super()._stop_trace()
        tracer().disable()


def innermost_gaps(summary: TraceSummary, spans, n=10):
    """The device's idle time between operations inside the window, summed
    by the innermost of ``spans`` ((name, start, end) ns; ``bench.window``
    left out) that holds each gap's midpoint, ``sampler`` where none does.
    Innermost: of the spans holding the midpoint, the last to start."""
    busy = summary.union()
    w0, w1 = summary.window
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    order = sorted((s, -e, name) for name, s, e in spans
                   if name != "bench.window")
    tot, stack, i = {}, [], 0
    for s, e in gaps:                    # gaps are in time order
        mid = (s + e) // 2
        while i < len(order) and order[i][0] <= mid:
            stack.append(order[i])
            i += 1
        while stack and -stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "sampler"
        tot[name] = tot.get(name, 0) + e - s
    return [[name, ns * 1e-9] for name, ns in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class ProgramSummary(TraceSummary):
    """The traced window with the program's ``mmid.*`` ranges, its idle
    gaps booked to the innermost span. A range also marks the device's
    timeline (a user annotation over the kernels it launched): that copy is
    no device operation."""

    def __init__(self, base: TraceSummary, program_spans):
        ops = [op for op in base.device_ops if not op[0].startswith("mmid.")]
        super().__init__(ops, base.spans, base.window)
        self.program_spans = program_spans

    def idle_gaps(self, n=10):
        return innermost_gaps(self, self.spans + self.program_spans, n)


def summarize(profiler) -> ProgramSummary:
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in profiler.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CPU")
              and e.name().startswith("mmid.")]
    return ProgramSummary(HARNESS_SUMMARIZE(profiler), ranges)


def _plain(snap):
    """A snapshot with its counter keys joined into strings (JSON)."""
    if snap is None:
        return None
    return dict(snap, counters={
        name: {"|".join(map(str, k)): v for k, v in c.items()}
        for name, c in snap["counters"].items()})


def k1_launches(snap) -> dict:
    """The snapshot's K1 launches by chain count."""
    out = {}
    for (_regime, _tableau, chains), n in tracer().counts(
            "launches", ("k1",), snap).items():
        out[chains] = out.get(chains, 0) + n
    return out


def one_chip(workload: str, overrides: dict = None):
    """Raises ``ValueError`` for a cell of more than one chip: this script
    runs one process, and its window is not the ranks' (``run.py`` starts
    one process a rank)."""
    cell, _config, _days = run.cell_files(workload, overrides)
    chips = int(cell.get("chips", 1))
    if chips > 1:
        raise ValueError(f"program_trace.py runs one process; {workload} asks "
                         f"for {chips} chips, one process a rank: trace it with "
                         f"run.py --trace 1")


def execute(workload: str, seed: int, seconds: float, *, device: str = "cuda",
            overrides: dict = None) -> dict:
    """``run.execute(..., trace=True)`` with :class:`ProgramWindow` and
    :func:`summarize` in place of the harness's own, and the ``program``
    entry. On the host the readers' values go under ``rehearsal``. A cell
    of more than one chip is refused (:func:`one_chip`)."""
    one_chip(workload, overrides)
    windows, summaries = [], []

    class Window(ProgramWindow):
        def __init__(self, **kw):
            super().__init__(**kw)
            windows.append(self)

    def keep(profiler):
        summaries.append(summarize(profiler))
        return summaries[-1]

    saved = bench_window.Window, bench_trace.summarize
    bench_window.Window, bench_trace.summarize = Window, keep
    try:
        out = run.execute(workload, seed, seconds, True, device=device,
                          overrides=overrides)
    finally:
        bench_window.Window, bench_trace.summarize = saved
    win = windows[-1]
    rec = run.Record(timed=win.timed, traced=win.traced)
    values = {}
    for name in PROGRAM_METRICS:
        reader = run.load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                                 f"h100_bench.metrics.{name}")
        value = reader.read(rec)
        if value is not None:
            values[name] = value
    timed = getattr(win.timed, "program", None)
    launches = k1_launches(timed) if timed is not None else {}
    out["program"] = {
        "metrics" if win.cuda else "rehearsal": values,
        "k1_launches_by_chains": launches,
        "harness_calls_by_chains": dict(win.timed.calls),
        "launches_match_calls": launches == dict(win.timed.calls),
        "idle_gaps": summaries[-1].idle_gaps(n=64) if summaries else None,
        "timed": _plain(timed),
        "traced": _plain(getattr(win.traced, "program", None)),
    }
    out["checks"] = out.pop("checks")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    try:
        one_chip(args.workload)
    except ValueError as e:
        print(f"program_trace: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card", file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds)
    out["power_limit"] = run.power_limit()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
