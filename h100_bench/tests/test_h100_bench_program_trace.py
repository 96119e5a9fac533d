"""The program's own spans in a cell's run (``program_trace.py``): idle gaps
booked to the innermost enclosing span, the same as the harness's own
booking where only its ``bench.*`` spans are there; the readers of the
tracer's snapshot on a made-up window; a host rehearsal of both cells."""

import os
import random
import sys
import types

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))

from h100_bench import program_trace, run  # noqa: E402
from h100_bench.trace import TraceSummary  # noqa: E402
from h100_bench.window import Phase  # noqa: E402

SEED = 2 ** 33 + 17
SMALL = dict(chains=8, segment_steps=20, thinning=10, burn_in=10, num_days=15,
             ref_block=8)


def _reader(name):
    return run.load_module(os.path.join(HERE, "metrics", f"{name}.py"), f"p_{name}")


def test_gap_in_a_parent_after_its_child_is_the_parent():
    # busy 0-5, 40-45, 95-100; gaps 5-40 (mid 22) and 45-95 (mid 70)
    ops = [("k", 0, 5), ("k", 40, 45), ("k", 95, 100)]
    spans = [("bench.window", 0, 100), ("mmid.parent", 0, 100),
             ("mmid.child", 10, 30)]
    s = TraceSummary(ops, spans, (0, 100))
    got = dict(program_trace.innermost_gaps(s, spans))
    assert got == pytest.approx({"mmid.child": 35e-9, "mmid.parent": 50e-9})
    # the last-started rule books the second gap outside every span
    assert dict(s.idle_gaps())["sampler"] == pytest.approx(50e-9)


def test_gap_outside_every_span_and_equal_starts():
    # gaps 10-20 (in b), 38-39 (in a, after b), 70-100 (in none)
    ops = [("k", 0, 10), ("k", 20, 38), ("k", 39, 70)]
    spans = [("mmid.a", 0, 40), ("mmid.b", 0, 30)]   # b inside a, one start
    s = TraceSummary(ops, spans, (0, 100))
    got = dict(program_trace.innermost_gaps(s, spans))
    assert got == pytest.approx({"mmid.b": 10e-9, "mmid.a": 1e-9,
                                 "sampler": 30e-9})


@pytest.mark.parametrize("seed", range(5))
def test_bench_spans_alone_give_the_harness_gaps(seed):
    """With the harness's own spans only (they follow one another), the
    innermost span is the harness's."""
    rng = random.Random(seed)
    t, ops, spans = 0, [], [("bench.window", 0, 0)]
    for _ in range(200):
        kind = rng.random()
        dt = rng.randint(1, 50)
        if kind < 0.5:
            ops.append(("k", t, t + dt))
        else:
            spans.append((rng.choice(["bench.objective", "bench.campaign_io"]),
                          t, t + dt))
            if rng.random() < 0.5:
                ops.append(("k", t + 1, t + 1 + rng.randint(0, dt)))
        t += dt + rng.randint(0, 5)
    spans[0] = ("bench.window", 0, t)
    s = TraceSummary(ops, spans, (0, t))
    assert program_trace.innermost_gaps(s, spans, 64) == s.idle_gaps(64)


def test_summarize_keeps_the_program_ranges(monkeypatch):
    """A CPU profile: the ``mmid.*`` ranges beside the harness's spans, read
    through the harness's own ``summarize`` even where :func:`execute` has
    put ours in its place."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with record_function("bench.objective"):
                with record_function("mmid.objective"):
                    torch.ones(4).sum()
    monkeypatch.setattr(program_trace.bench_trace, "summarize",
                        program_trace.summarize)
    s = program_trace.summarize(prof)
    assert [n for n, _, _ in s.program_spans] == ["mmid.objective"]
    assert sorted(n for n, _, _ in s.spans) == ["bench.objective", "bench.window"]
    (_, a0, a1), = [sp for sp in s.spans if sp[0] == "bench.objective"]
    (_, b0, b1), = s.program_spans
    assert a0 <= b0 <= b1 <= a1
    # no device operation: one gap, the window, booked by its midpoint
    mid = sum(s.window) // 2
    name = ("mmid.objective" if b0 <= mid <= b1 else
            "bench.objective" if a0 <= mid <= a1 else "sampler")
    assert s.idle_gaps() == [[name, s.window_s]]


def test_execute_looks_up_window_and_summarize_when_called():
    """:func:`program_trace.execute` swaps ``window.Window`` and
    ``trace.summarize`` for its own while ``run.execute`` runs; that holds
    only while ``run.execute`` imports both inside its body."""
    import ast
    import inspect
    import textwrap

    body = ast.parse(textwrap.dedent(inspect.getsource(run.execute)))
    local = {(node.module, alias.name) for node in ast.walk(body)
             if isinstance(node, ast.ImportFrom) for alias in node.names}
    assert {("h100_bench.window", "Window"),
            ("h100_bench.trace", "summarize")} <= local
    assert not hasattr(run, "Window") and not hasattr(run, "summarize")


class _Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._d, self._t = name, start, end - start, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._t}"


def test_device_annotations_of_program_ranges_are_no_device_operations():
    """On a card a ``record_function`` range is also an annotation on the
    device's timeline, over the kernels launched inside it."""
    events = [_Event("bench.window", 0, 100, "CPU"), _Event("mmid.objective", 10, 60, "CPU"),
              _Event("mmid.objective", 20, 70, "CUDA"), _Event("bench.objective", 10, 61, "CUDA"),
              _Event("kernel", 30, 40, "CUDA")]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    s = program_trace.summarize(prof)
    assert s.device_ops == [("kernel", 30, 40)] and s.busy_s() == pytest.approx(10e-9)
    assert s.program_spans == [("mmid.objective", 10, 60)]
    # gaps 0-30 (midpoint in the range) and 40-100 (after it)
    assert dict(s.idle_gaps()) == pytest.approx({"mmid.objective": 30e-9,
                                                 "sampler": 60e-9})


def _rec(snapshot=None, iterations=1000):
    timed = Phase("timed")
    timed.iterations = iterations
    if snapshot is not None:
        timed.program = snapshot
    return run.Record(timed=timed, traced=Phase("traced"))


def _span(count, total_s, self_s=None):
    return dict(count=count, total_s=total_s,
                self_s=total_s if self_s is None else self_s)


SNAP = {"spans": {"objective.prep": _span(1001, 1.8), "k1.launch": _span(1001, 0.1),
                  "mh.draws": _span(1000, 0.2), "campaign.segment": _span(1, 3.0, 0.05),
                  "mh.step": _span(1000, 2.5, 0.4), "mh.adapt_cov": _span(10, 0.02),
                  "mh.finish": _span(1, 0.03), "campaign.checkpoint": _span(2, 0.5)},
        "counters": {"checkpoint.bytes": {(): 8_000_000},
                     "launches": {("k1", 2, "cash_karp", 8192): 1001}}}


def test_readers_on_a_snapshot():
    rec = _rec(SNAP)
    want = {"prep_host_ms": 1e3 * 1.8 / 1001, "launch_host_ms": 1e3 * 0.1 / 1001,
            "draws_host_ms": 0.2, "sampler_self_ms": 0.05 + 0.4 + 0.02 + 0.03,
            "checkpoint_bytes": 4_000_000}
    for name, value in want.items():
        assert _reader(name).read(rec) == pytest.approx(value), name
    assert program_trace.k1_launches(SNAP) == {8192: 1001}


@pytest.mark.parametrize("name", program_trace.PROGRAM_METRICS)
def test_readers_without_the_span(name):
    assert _reader(name).read(_rec()) is None          # no tracer in the run
    empty = {"spans": {}, "counters": {}}
    assert _reader(name).read(_rec(empty)) is None
    assert _reader(name).read(_rec({"spans": {"other": _span(1, 1.0)},
                                    "counters": {}})) is None


@pytest.mark.parametrize("cell", ["am8192-cashkarp3", "am1024-dopri5x4"])
def test_rehearsal(cell):
    out = program_trace.execute(cell, SEED, 0.0, device="cpu", overrides=SMALL)
    assert out["correct"] is True, out["checks"]
    prog = out["program"]
    got = prog["rehearsal"]
    want = {"prep_host_ms", "launch_host_ms", "draws_host_ms", "sampler_self_ms"}
    if cell == "am8192-cashkarp3":
        want.add("checkpoint_bytes")
    assert set(got) == want and all(v > 0 for v in got.values())
    assert "metrics" not in prog and prog["idle_gaps"] is None
    assert prog["harness_calls_by_chains"] == {8: out["window"]["iterations"]}
    assert prog["k1_launches_by_chains"] == {}         # the plain version
    spans = prog["timed"]["spans"]
    assert spans["mh.step"]["count"] == out["window"]["iterations"]
    assert prog["traced"]["spans"]["mh.step"]["count"] == SMALL["segment_steps"]
