"""One process a rank (``ranks.py``): ``run.py`` at W = 2 and 4 as ``gloo``
ranks on the host, with a DE-MC driver on ``setup.mesh``
(``de_ranks_driver.py``, the program's ``parallel.run_mh_sharded``).

Every rank leaves the runner at the same unit (the last rank's window clock
stands still, so only rank 0's shared decision closes its window), the line
counts W devices and every global chain, and the gathered final equals the
one-rank run's: the same accept decisions, positions within 1e-12 in
float64 (the ranks' sums differ only in order). A rank that raises, loads
JAX or is killed ends the run non-zero with no result line and no process
left. A one-chip cell starts no child and no process group, and its line
has today's keys. On four cards (marked ``cuda``) the same driver runs as
four ``nccl`` ranks at 4 × 1024 float32 chains over the full 306 days."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from h100_bench import program_trace, ranks, run  # noqa: E402

DRIVER = os.path.join(HERE, "tests", "de_ranks_driver.py")
CELL = "am8192-cashkarp3"                 # cash_karp@3; DRIVER replaces its sampler
HOST = dict(chains=64, segment_steps=20, num_days=30, dtype="float64",
            ref_block=64, warm_units=1)
SEED = 2 ** 33 + 23
LIMIT_S = 120
WINDOW_S = 1e-6           # rank 0 closes the window at its first timed unit


def _run(seed, overrides, *, device="cpu", seconds=WINDOW_S, trace=0,
         timeout=LIMIT_S):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", CELL,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--device", device, "--driver", DRIVER,
           "--overrides", json.dumps(overrides)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=timeout, stdin=subprocess.DEVNULL)
    return p, time.perf_counter() - t


def _line(p):
    """The result line, or None where stdout holds none."""
    for text in reversed(p.stdout.strip().splitlines()):
        try:
            out = json.loads(text)
        except json.JSONDecodeError:
            continue
        if isinstance(out, dict) and "correct" in out:
            return out
    return None


def _leftovers(seed):
    """Processes still running ``run.py`` with ``seed``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if any(a.endswith(b"run.py") for a in argv) and str(seed).encode() in argv:
            found.append(int(pid))
    return found


def _no_leftovers(seed):
    end = time.monotonic() + 10
    while _leftovers(seed) and time.monotonic() < end:
        time.sleep(0.2)
    assert not _leftovers(seed)


@pytest.fixture(scope="module")
def one_rank():
    p, _ = _run(SEED, dict(HOST, chips=1))
    assert p.returncode == 0, p.stderr[-3000:]
    return _line(p)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_equal_one_rank(one_rank, world):
    p, _ = _run(SEED, dict(HOST, chips=world))
    assert p.returncode == 0, p.stderr[-3000:]
    out = _line(p)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] == HOST["chains"]
    assert out["device"] == {"count": world}
    units = out["window"]["units"]
    assert out["window"]["units_by_rank"] == [units] * world
    assert units == one_rank["window"]["units"] == 1
    got, want = out["extra"], one_rank["extra"]
    assert got["accept"] == want["accept"]
    x, x1 = torch.tensor(got["x"]), torch.tensor(want["x"])
    assert x.shape == (HOST["chains"], 62)
    assert torch.allclose(x, x1, rtol=0, atol=1e-12)
    assert torch.allclose(torch.tensor(got["logp"]), torch.tensor(want["logp"]),
                          rtol=1e-12, atol=0)
    _no_leftovers(SEED)


@pytest.mark.parametrize("kind", ["raise", "jax", "kill"])
def test_failed_rank_ends_the_run(kind):
    seed = SEED + {"raise": 1, "jax": 2, "kill": 3}[kind]
    fault = dict(rank=1, unit=1, kind=kind)
    p, seconds = _run(seed, dict(HOST, chips=2, fault=fault))
    assert p.returncode != 0 and seconds < LIMIT_S
    assert _line(p) is None, p.stdout[-2000:]
    if kind == "jax":
        assert "loaded ['jax']" in p.stderr
    _no_leftovers(seed)


def test_one_chip_starts_no_rank(monkeypatch, capsys):
    """A one-chip cell through ``main``: no child, no process group, and
    the line's keys as before one process a rank."""
    import torch.distributed as dist

    started = []
    popen = subprocess.Popen

    def record(args, *a, **k):
        started.append(args)
        return popen(args, *a, **k)

    def no_group(*a, **k):
        raise AssertionError("a one-chip cell started a process group")

    monkeypatch.setattr(subprocess, "Popen", record)
    monkeypatch.setattr(dist, "init_process_group", no_group)
    small = dict(chains=8, segment_steps=20, thinning=10, burn_in=10,
                 num_days=15, ref_block=8)
    rc = run.main(["--workload", "am1024-dopri5x4", "--seed", str(SEED),
                   "--seconds", "0", "--device", "cpu",
                   "--overrides", json.dumps(small)])
    assert rc == 0
    assert not any("run.py" in " ".join(map(str, a)) for a in started), started
    assert not dist.is_initialized()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "rehearsal", "window", "power_limit", "checks"]
    assert out["device"] == {} and list(out["window"]) == ["units", "iterations",
                                                           "seconds"]
    assert out["correct"] is True


def test_program_trace_refuses_ranks():
    with pytest.raises(ValueError, match="one process a rank"):
        program_trace.execute(CELL, SEED, 0.0, device="cpu", overrides={"chips": 4})


def test_child_rank_comes_from_the_launcher(monkeypatch):
    monkeypatch.delenv(ranks.PARENT, raising=False)
    monkeypatch.setenv("RANK", "3")
    assert ranks.child_rank() is None          # a RANK of another launcher
    monkeypatch.setenv(ranks.PARENT, "1")
    assert ranks.child_rank() == 3


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


CARD = dict(chips=4, chains=4096, segment_steps=200, ref_block=4096, warm_units=1)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_four_nccl_ranks(four_cards, trace):
    """Four ``nccl`` ranks on four cards, 4 × 1024 float32 chains,
    cash_karp@3 over 306 days, two 200-step units: correct, four devices,
    four memory peaks, every rank's exit 0 (rank 0 exits 1 otherwise) and
    no JAX loaded (3 otherwise); traced, ``mfu`` over all four cards."""
    seed = 3123000101 + trace
    p, took = _run(seed, CARD, device="cuda", trace=trace, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = _line(p)
    print(f"trace {trace}, {took:.1f} s: {json.dumps(out)}")
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] == 4096
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 4
    peaks = dev["memory_peak_bytes_by_rank"]
    assert len(peaks) == 4 and all(b > 0 for b in peaks)
    assert dev["memory_peak_bytes"] == max(peaks)
    assert out["window"]["units_by_rank"] == [out["window"]["units"]] * 4
    if trace:
        assert 0 < out["metrics"]["mfu"]["value"] < 100
        assert dev["busy_s"] > 0
    else:
        assert out["metrics"]["draws_per_s"]["value"] > 0
    _no_leftovers(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["kill", "hang"])
def test_four_nccl_ranks_lose_one(four_cards, kind):
    """Rank 2 killed, or hung, mid-window: the run ends non-zero with no
    line and no rank left (a hang by the process group's timeout)."""
    seed = 3123000111 + (kind == "hang")
    seconds = 5.0
    fault = dict(rank=2, unit=2, kind=kind)
    p, took = _run(seed, dict(CARD, fault=fault), device="cuda", seconds=seconds,
                   timeout=600)
    assert p.returncode != 0 and _line(p) is None, p.stdout[-2000:]
    assert took < 300 + ranks.timeout_s(seconds)
    print(f"{kind}: rc {p.returncode} after {took:.1f} s\n{p.stderr[-1500:]}")
    _no_leftovers(seed)
