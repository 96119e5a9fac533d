"""The parallel-tempering cell on the host: it rehearses at a tiny size
through the program's plain versions, timed and traced (the program's spans
read by ``pt_step_host_ms`` and ``pt_swap_host_ms`` in the traced run only,
and the tracer off again after it; under ``program_trace.py`` the window
keeps the tracer itself), and a swap that moves ``x`` between rungs without
its ``logp`` turns ``correct`` false."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(HERE))

from h100_bench import run  # noqa: E402

CELL = "pt8x1024-cashkarp3"
SMALL = dict(chains=16, segment_steps=20, thinning=10, burn_in=10, num_days=15,
             ref_block=16)
SEED = 2 ** 33 + 29


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(trace):
    from mmidv1_tpu_torch.utils import trace as program_trace

    out = run.execute(CELL, SEED, 0.0, trace, device="cpu", overrides=SMALL)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] == SMALL["chains"]
    assert out["metrics"] == {} and out["device"] == {}
    got = out["rehearsal"]
    if trace:
        assert got["pt_step_host_ms"] > 0 and got["pt_swap_host_ms"] > 0
        assert {"campaign_io_ms", "sampler_host_ms", "objective_host_ms"} <= set(got)
    else:
        assert set(got) == {"draws_per_s", "setup_s"}
    assert program_trace.span("x") is program_trace.span("y")    # off again


def test_swap_moving_x_without_logp_is_not_correct(monkeypatch):
    from mmidv1_tpu_torch.calibration import tempering

    swap = tempering.pt_swap_step

    def broken(state, *a, **k):
        new = swap(state, *a, **k)
        return new._replace(logp=state.logp)

    monkeypatch.setattr(tempering, "pt_swap_step", broken)
    out = run.execute(CELL, SEED, 0.0, False, device="cpu", overrides=SMALL)
    assert out["correct"] is False and out["failed"] > 0, out["checks"]
    assert out["checks"]["value_gap"]["value"] > out["checks"]["value_gap"]["limit"]


def test_program_trace_keeps_its_own_tracer():
    """Under ``program_trace.py`` the window switches the tracer itself: the
    driver leaves it on for the traced window, whose snapshot holds the
    ``pt.*`` spans too."""
    from h100_bench import program_trace

    out = program_trace.execute(CELL, SEED, 0.0, device="cpu", overrides=SMALL)
    assert out["correct"] is True, out["checks"]
    timed, traced = out["program"]["timed"], out["program"]["traced"]
    for snap in (timed, traced):
        assert snap["spans"]["pt.step"]["count"] == SMALL["segment_steps"]
        assert snap["spans"]["pt.swap"]["count"] == SMALL["segment_steps"]
