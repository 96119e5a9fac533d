"""The harness's own count of the objective's calls, and the readers that
take it: ``mfu``, ``k1_roofline`` and ``idle_share`` keep to their
definitions on a made-up window and trace."""

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))

from h100_bench import roofline, run  # noqa: E402
from h100_bench.trace import TraceSummary  # noqa: E402
from h100_bench.window import Phase, Window  # noqa: E402

with open(os.path.join(HERE, "configs", "spain2020-dopri5x4-f32.json")) as f:
    CONFIG = json.load(f)


def _reader(name):
    return run.load_module(os.path.join(HERE, "metrics", f"{name}.py"), f"m_{name}")


def test_wrap_counts_calls_by_chain_count():
    win = Window(seconds=1e9, trace=False, trace_units=1,
                 device=torch.device("cpu"), t_process=0.0)
    f = win.wrap(lambda x: x.sum(1))
    f(torch.ones(3, 2))                    # before the window: not counted
    win.start()
    for B in (4, 4, 8):
        f(torch.ones(B, 2))
    assert win.timed.calls == {4: 2, 8: 1}
    assert win.timed.spans["objective"].count == 3


def _rec(**kw):
    timed, traced = Phase("timed"), Phase("traced")
    timed.t0, timed.t1, timed.iterations, timed.calls = 0.0, 2.0, 1000, {1024: 1000}
    traced.iterations, traced.calls = 500, {1024: 500}
    ns = 10 ** 9
    # K1 busy 0.25 s, another kernel 0.05 s, in a traced window of 3 s
    trace = TraceSummary([("sepaihrd_forward_split_kernel<Dopri5, false>", 0, ns // 4),
                          ("elementwise_kernel", ns // 2, ns // 2 + ns // 20)],
                         [], (0, 3 * ns))
    return run.Record(config=CONFIG, cuda=True, timed=timed, traced=traced,
                      trace=trace, **kw)


def test_mfu():
    rec = _rec()
    ops = 1000 * roofline.call_cost("k1", CONFIG, 1024)["ops"]
    assert _reader("mfu").read(rec) == pytest.approx(100 * ops / (2.0 * 67e12))
    rec.timed.calls = {}
    assert _reader("mfu").read(rec) is None


def test_k1_roofline():
    rec = _rec()
    least = 500 * roofline.call_cost("k1", CONFIG, 1024)["ops"] / 67e12
    assert _reader("k1_roofline").read(rec) == pytest.approx(100 * least / 0.25)
    rec.traced.calls = {}
    assert _reader("k1_roofline").read(rec) is None


def test_idle_share_uses_the_timed_window():
    # 0.3 s busy over 500 traced iterations; 2 ms an iteration untraced
    assert _reader("idle_share").read(_rec()) == pytest.approx(100 * (1 - 0.3 / 500 / 2e-3))
