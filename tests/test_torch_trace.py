"""The port's tracer (``mmidv1_tpu_torch.utils.trace``): spans off by
default and free of records, counters always counting, nested spans' self
time, the spans of a checkpointed AM-MH campaign on the host, samples that
do not depend on tracing, and ``mmid.*`` ranges in a CPU profile."""

import os
import sys
import types

import pytest
import torch

from mmidv1_tpu_torch.calibration.mh import MHConfig, run_mh_checkpointed
from mmidv1_tpu_torch.utils import trace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_kernels import _objective  # noqa: E402

CFG = MHConfig(iterations=8, burn_in=2, adaptation_period=2, thinning=2)
SEGMENTS = 2
STEPS = 8                 # 2 segments of 4 steps


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def test_off_records_no_span_and_counters_count():
    a, b = trace.span("a"), trace.span("b")
    assert a is b                                # one shared null context
    with a:
        with b:
            trace.count("c", ("x", 1))
    trace.count("c", ("x", 1), 2)
    trace.count("d")
    snap = trace.snapshot()
    assert snap["spans"] == {}
    assert snap["counters"] == {"c": {("x", 1): 3}, "d": {(): 1}}
    assert trace.total("c", ("x",)) == 3 and trace.total("c", ("y",)) == 0
    assert trace.counts("c", ("x",)) == {(1,): 3} == trace.counts(
        "c", ("x",), snap)
    assert trace.counts("c", ("y",)) == {} and trace.counts("e") == {}


def test_nested_spans_count_total_and_self(monkeypatch):
    ticks = iter([0, 10, 30, 40, 50, 60, 70, 100])
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    trace.enable()
    with trace.span("outer"):                    # 0 .. 100
        with trace.span("inner"):                # 10 .. 30
            pass
        with trace.span("inner"):                # 40 .. 70
            with trace.span("leaf"):             # 50 .. 60
                pass
    snap = trace.snapshot()["spans"]
    ns = lambda d: {k: round(v * 1e9) if k != "count" else v
                    for k, v in d.items()}
    assert ns(snap["outer"]) == dict(count=1, total_s=100, self_s=50)
    assert ns(snap["inner"]) == dict(count=2, total_s=50, self_s=40)
    assert ns(snap["leaf"]) == dict(count=1, total_s=10, self_s=10)
    snap["outer"]["count"] = 99                  # a copy
    assert trace.snapshot()["spans"]["outer"]["count"] == 1
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def _campaign(tmp_path, sizes=None):
    """A checkpointed AM-MH campaign on the host through K1's plain version
    (8 chains, 2 segments of 4 steps); ``sizes`` collects the size of the
    checkpoint each segment found on disk."""
    ll, theta0 = _objective(torch.device("cpu"), torch.float64, n_days=20)
    path = str(tmp_path / "ckpt.npz")
    space = ll.prep.space

    def draws_for_segment(s):
        from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
        if sizes is not None and os.path.exists(path):
            sizes.append(os.path.getsize(path))
        return SeededRunDraws(7, s, 8, space.dim, theta0.dtype, theta0.device)

    res = run_mh_checkpointed(ll, space, theta0, CFG, seed=7, n_chains=8,
                              segments=SEGMENTS, checkpoint_path=path,
                              resume=False, draws_for_segment=draws_for_segment)
    if sizes is not None:
        sizes.append(os.path.getsize(path))
    return res


def test_campaign_spans_on_the_host(tmp_path):
    trace.enable()
    sizes = []
    _campaign(tmp_path, sizes)
    snap = trace.snapshot()
    counts = {name: s["count"] for name, s in snap["spans"].items()}
    assert counts["mh.draws"] == counts["mh.step"] == STEPS
    calls = STEPS + 1                            # the start's call included
    for name in ("objective", "objective.prep", "prep.constrain", "prep.apply",
                 "prep.initial_state", "prep.pack", "k1.launch",
                 "objective.mask"):
        assert counts[name] == calls, name
    for name in ("campaign.segment", "campaign.to_host", "campaign.checkpoint",
                 "checkpoint.to_host", "checkpoint.write", "mh.finish"):
        assert counts[name] == SEGMENTS, name
    assert counts["mh.adapt_cov"] >= 1
    assert snap["counters"]["checkpoint.bytes"] == {(): sum(sizes)}
    assert len(sizes) == SEGMENTS
    sp = snap["spans"]
    for name, s in sp.items():
        assert 0 < s["self_s"] <= s["total_s"], name
    # children inside their parents
    assert sp["objective.prep"]["total_s"] + sp["k1.launch"]["total_s"] \
        <= sp["objective"]["total_s"]
    assert sp["checkpoint.to_host"]["total_s"] + sp["checkpoint.write"]["total_s"] \
        <= sp["campaign.checkpoint"]["total_s"]
    assert sp["mh.step"]["self_s"] < sp["mh.step"]["total_s"]


@pytest.mark.parametrize("profile", [False, True])
def test_tracing_leaves_the_samples_bit_identical(tmp_path, profile):
    off = _campaign(tmp_path / "off")
    trace.enable(profile=profile)
    on = _campaign(tmp_path / "on")
    trace.disable()
    for a, b in [(off.samples, on.samples), (off.sample_logps, on.sample_logps),
                 (off.final_state.x, on.final_state.x),
                 (off.final_state.chol, on.final_state.chol)]:
        assert torch.equal(a, b)


def test_profile_ranges_nest_inside_an_enclosing_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.enable(profile=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with trace.span("a"):
                with trace.span("b"):
                    torch.ones(8).sum()
    trace.disable()
    found = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("outer", "mmid.a", "mmid.b"):
            found[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    assert set(found) == {"outer", "mmid.a", "mmid.b"}
    (o0, o1), (a0, a1), (b0, b1) = (found["outer"], found["mmid.a"],
                                    found["mmid.b"])
    assert o0 <= a0 <= b0 <= b1 <= a1 <= o1
    assert trace.snapshot()["spans"]["a"]["count"] == 1
