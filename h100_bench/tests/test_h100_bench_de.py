"""The DE-MC cell across ranks (``de32768-x4-cashkarp3``): it rehearses on
the host as four ``gloo`` ranks through ``run.py``, timed and traced (the
collective spans read by ``mesh_host_ms`` in the traced run), and the
driver's step check passes; a fault planted in the walker exchange fails
the run (``de_fault_driver.py``); an objective
that leaves half the rows out, or alters one, turns ``correct`` false;
``gather_roofline``'s least time rests on the bytes the cell needs, frozen
from the cell, and reads a share of the NCCL kernels' time. On four cards
(marked ``cuda``) the cell runs at a small size through ``run.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from h100_bench import run  # noqa: E402
from h100_bench.metrics import gather_roofline  # noqa: E402
from h100_bench.trace import TraceSummary  # noqa: E402

CELL = "de32768-x4-cashkarp3"
HOST = dict(chains=32, segment_steps=20, thinning=10, burn_in=10, num_days=15,
            ref_block=32, dtype="float64")
SEED = 2 ** 33 + 31
LIMIT_S = 240
DRIVER = os.path.join(HERE, "tests", "de_cell_driver.py")
FAULT_DRIVER = os.path.join(HERE, "tests", "de_fault_driver.py")


def _call(overrides, *, device="cpu", seconds=1e-6, trace=0, seed=SEED,
          driver=None):
    """``run.py`` on the cell, through ``driver`` where given."""
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", CELL,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--device", device, "--overrides", json.dumps(overrides)]
    if driver:
        cmd += ["--driver", driver]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=LIMIT_S, stdin=subprocess.DEVNULL)


def _run(overrides, *, trace=0, **kw):
    """The cell's line; traced, through ``de_cell_driver.py``, whose
    ``extra`` holds rank 0's timed counters."""
    p = _call(overrides, trace=trace, driver=DRIVER if trace else None, **kw)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _step_checked(out, chains):
    """The driver's step check ran over every chain and was not vacuous."""
    sc = out["extra"]["step_check"]
    assert sc["proposal_gap"] <= 1 and sc["outcome_unread"] == 0, sc
    assert sc["decisions_differ"] == 0, sc
    assert sc["moved"] >= chains // 4 and sc["accepted"] > 0, sc
    assert sc["decisions_compared"] + sc["ties"] >= sc["moved"] - 1, sc


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_on_four_ranks(trace):
    out = _run(HOST, trace=trace)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] == HOST["chains"]
    assert out["device"] == {"count": 4} and out["metrics"] == {}
    assert out["window"]["units_by_rank"] == [out["window"]["units"]] * 4
    _step_checked(out, HOST["chains"])
    got = out["rehearsal"]
    if trace:
        # on the host every step is eager, and each gathers the walker table
        steps = out["window"]["iterations"]
        assert out["extra"]["mh.graph"] == {repr(("eager", 8, "de")): steps}
        gathers = out["extra"]["mesh.bytes"][repr(("all_gather", "torch.float64",
                                                   32 * 62))]
        assert gathers >= steps * 32 * 62 * 8
        assert got["mesh_host_ms"] > 0
        assert {"campaign_io_ms", "sampler_host_ms", "objective_host_ms"} <= set(got)
        # a device trace's reader has nothing to read on the host
        assert "gather_roofline" not in got
    else:
        assert set(got) == {"draws_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["local", "parity", "order"])
def test_planted_fault_fails_the_run(fault):
    """Partners from the rank's own rows, the moving half's parity flipped,
    the walker table out of rank order: each leaves every chain the value
    of its position, and the driver's step check ends the run with no
    line."""
    p = _call(dict(HOST, fault=fault), driver=FAULT_DRIVER)
    assert p.returncode != 0
    assert "DE step check failed" in p.stderr, p.stderr[-3000:]
    assert not any(ln.startswith("{") for ln in p.stdout.splitlines())


def _sabotage(kind):
    """The sampled objective leaves its second half of rows out (the mean
    of the first half's answers in their place), or alters row 0's answer
    by half its size."""
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


@pytest.mark.parametrize("kind", ["half", "alter"])
def test_sabotaged_objective_is_not_correct(kind):
    out = run.execute(CELL, SEED, 0.0, False, device="cpu",
                      overrides=dict(HOST, chains=16, ref_block=16, chips=1),
                      sabotage=_sabotage(kind))
    assert out["correct"] is False and out["failed"] > 0, out["checks"]


def test_gather_roofline_frozen_bytes():
    """(W - 1) / W x N / 2 x d x 4 B for the cell: 3 047 424 B at W 4, N
    32768, d 62, float32; the bandwidth comes with its source line."""
    cell, config, _ = run.cell_files(CELL)
    W, N, d = cell["chips"], cell["chains"], config["parameters"]
    assert (W, N, d, config["dtype"]) == (4, 32768, 62, "float32")
    assert gather_roofline.needed_bytes(cell, config) == \
        (W - 1) * N // 2 * d * 4 // W == 3047424
    spec = gather_roofline.spec()
    assert spec["bytes_per_s"] > 0 and "nvidia-smi nvlink -s" in spec["nvidia_smi"]


def test_gather_roofline_reads_the_nccl_kernels():
    """Over a trace of two steps, each with an NCCL gather of 20 us beside
    K1: the least time of two steps over 40 us; nothing without an NCCL
    kernel, or on one chip."""
    cell, config, _ = run.cell_files(CELL)
    ops = [("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            0, 20_000), ("sepaihrd_forward_wide_kernel<float>", 20_000, 600_000),
           ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            600_000, 620_000), ("Memcpy DtoD", 620_000, 640_000)]
    rec = run.Record(cell=cell, config=config, chips=4,
                     traced=type("P", (), {"iterations": 2})(),
                     trace=TraceSummary(ops, [], (0, 640_000)))
    least = gather_roofline.needed_bytes(cell, config) / \
        gather_roofline.spec()["bytes_per_s"]
    assert gather_roofline.read(rec) == pytest.approx(100 * 2 * least / 40e-6)
    rec.trace = TraceSummary(ops[1:2], [], (0, 640_000))
    assert gather_roofline.read(rec) is None
    rec.trace, rec.chips = TraceSummary(ops, [], (0, 640_000)), 1
    assert gather_roofline.read(rec) is None


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_four_cards(four_cards, trace):
    """The cell at 4 x 1024 float32 chains, 200-step segments, through
    ``run.py`` on four ``nccl`` ranks: correct, four devices, the ranks
    leaving at the same unit; traced, the two new readers read and every
    step of the timed window replays the DE step's graphs; the driver's
    step check passes, and with partners taken from each rank's own rows
    it fails the run."""
    out = _run(dict(chains=4096, segment_steps=200, ref_block=4096),
               device="cuda", seconds=2.0, trace=trace, seed=3125000201 + trace)
    print(json.dumps(out))
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["device"]["count"] == 4
    assert out["window"]["units_by_rank"] == [out["window"]["units"]] * 4
    _step_checked(out, 4096)
    m = out["metrics"]
    if trace:
        assert out["extra"]["mh.graph"] == {
            repr(("replay", 1024, "de")): out["window"]["iterations"]}
        assert m["mesh_host_ms"]["value"] > 0
        assert 0 < m["gather_roofline"]["value"] < 100
        assert 0 < m["mfu"]["value"] < 100
    else:
        assert m["draws_per_s"]["value"] > 0
        p = _call(dict(chains=4096, segment_steps=200, ref_block=4096,
                       fault="local"), device="cuda", seconds=2.0,
                  seed=3125000203, driver=FAULT_DRIVER)
        print(p.stderr[-2000:])
        assert p.returncode != 0 and "DE step check failed" in p.stderr
