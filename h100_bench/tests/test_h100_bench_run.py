"""The harness end to end on the host: a run without a card fails and prints
nothing; each cell rehearses at a tiny size through the program's plain
versions; and with the timed path broken underneath, ``correct`` comes out
false (a step that returns its state unchanged, half of the batch left out
with the mean of the rest in its place, an answer altered where it is
produced)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from h100_bench import run  # noqa: E402

SMALL = {
    "am8192-cashkarp3": dict(chains=8, segment_steps=20, thinning=10, burn_in=10,
                             num_days=15, ref_block=8),
    "am1024-dopri5x4": dict(chains=8, segment_steps=20, thinning=10, burn_in=10,
                            num_days=15, ref_block=8),
}
DEVICE_METRICS = {"launches_per_step", "k1_roofline", "idle_share", "mfu"}
SEED = 2 ** 33 + 17


def _cmd(root, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, os.path.join(root, "h100_bench", "run.py"),
                           "--workload", "am1024-dopri5x4", "--seed", str(SEED),
                           "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, cwd=root, env=env, timeout=120)


def test_no_card_fails():
    p = _cmd(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cmd(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(cell, trace):
    out = run.execute(cell, SEED, 0.0, trace, device="cpu", overrides=SMALL[cell])
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["device"] == {} and "breakdown" not in out
    assert out["metrics"] == {}                  # a host number is no card's
    assert not set(out["rehearsal"]) & DEVICE_METRICS
    assert list(out)[-1] == "checks"
    json.dumps(out)
    if not trace:
        assert set(out["rehearsal"]) == {"draws_per_s", "setup_s"}


def _unchanged(monkeypatch):
    """The sampler's step returns its state unchanged."""
    from mmidv1_tpu_torch.calibration import mh
    monkeypatch.setattr(mh, "mh_step", lambda state, *a, **k:
                        state._replace(step=state.step + 1))


def _break_objective(kind):
    """Sabotage of the driver's objective: ``half`` (the second half of the
    rows gets the mean of the first half's answers) or ``alter`` (row 0's
    answer moved by half its size)."""
    def broken(fn):
        def f(x):
            v = fn(x).clone()
            n = x.shape[0]
            if kind == "half":
                v[n // 2:] = v[:n // 2].mean()
            else:
                v[0] = v[0] * 1.5
            return v
        return f

    def sabotage(driver):
        make = driver.s.objective
        driver.s.objective = lambda: broken(make())
    return sabotage


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    sabotage = None
    if fault == "unchanged":
        _unchanged(monkeypatch)
    else:
        sabotage = _break_objective(fault)
    out = run.execute(cell, SEED, 0.0, False, device="cpu", overrides=SMALL[cell],
                      sabotage=sabotage)
    assert out["correct"] is False and out["failed"] > 0, out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_separates(card, cell):
    """On the card, at a size a test run holds: the control (the reference
    in float32 with a TF32 contact product, in the program's place) reads
    at least ten times the program's largest value gap, at the same states."""
    from h100_bench import control

    ov = dict(SMALL[cell], num_days=60)
    out = run.execute(cell, SEED, 0.0, False, overrides=ov, extra=control.readings)
    prog = out["extra"]["program_gaps"]["max"]
    ctl = out["extra"]["control"]["value_gaps"]["max"]
    assert ctl > 10 * prog, (ctl, prog)
