"""DE-MC as a checkpointed campaign on a mesh: ``run_mh_checkpointed(...,
mesh=...)`` against the plain reference of the benchmark
(``h100_bench/reference/de.py``, written from ter Braak 2006 and the
red-black description, importing nothing of the port).

Host tests, ``gloo`` ranks spawned on the CPU (``tests/torch_ranks.py``),
float64 through K1's plain version, 16 chains over 20 days of the frozen
Spain-2020 tree, two segments of 10 steps: the campaign on one process and
on 2 and 4 ranks equals the reference fed the same seeded draws (positions,
values and scales within 1e-12, accept counts exact); a campaign killed
after its first segment and resumed from each rank's checkpoint shard
equals the uninterrupted one to the bit; shards of another number of
processes refuse to resume; the exact gather is ``torch.cat`` of the ranks'
rows in rank order. The card test (marked ``cuda``) holds the graphed DE
step equal to the eager one to the bit on one rank, with and without a
process group, through a campaign of two segments and its resume:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_de_mesh.py -m cuda
"""

import os
import socket
import sys

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch.calibration import mh
from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
from mmidv1_tpu_torch.parallel.mesh import LOCAL, EnsembleMesh
from mmidv1_tpu_torch.utils import trace
from mmidv1_tpu_torch.utils.checkpoint import shard_path

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)
import torch_ranks as R  # noqa: E402
from h100_bench.reference.de import DEReference  # noqa: E402

F64 = torch.float64
C = R.DE_CAMPAIGN
SPAWN_S = 180.0


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("de_mesh"))


@pytest.fixture(scope="module")
def reference():
    """The reference over both segments: the final state and the samples
    at every block's end, with every step's accept mask."""
    space, theta0, ll = R.spain_problem(C["num_days"])
    N = C["n_chains"]
    ref = DEReference(ll, space.lower, space.upper, space.sigmas,
                      thinning=C["thinning"])
    draws = lambda s: SeededRunDraws(C["seed"], s, N, space.dim, F64, "cpu")
    st = ref.init(theta0, draws(0).init())
    blocks, decisions = [], []
    for s in range(C["segments"]):
        blocks += ref.run(st, draws(s), C["steps"], decisions)
    return st, blocks, torch.stack(decisions)


@pytest.fixture(scope="module")
def one_rank(workdir):
    return R.task_de_campaign(None, os.path.join(workdir, "one.npz"))


@pytest.fixture(scope="module")
def two_ranks(workdir, one_rank):
    """On two ranks: the campaign, the same killed after one segment and
    resumed, a resume of the one-process checkpoint, and the gather."""
    full, cut = (os.path.join(workdir, f"{n}.npz") for n in ("two", "cut"))
    tasks = [(R.task_de_campaign, dict(path=full)),
             (R.task_de_campaign, dict(path=cut, kill_after=1)),
             (R.task_de_campaign, dict(path=cut, resume=True)),
             (R.task_de_campaign, dict(path=os.path.join(workdir, "one.npz"),
                                       resume=True)),
             (R.task_gather, {})]
    return R.spawn(2, tasks, os.path.join(workdir, "w2"), timeout=SPAWN_S)


@pytest.fixture(scope="module")
def four_ranks(workdir):
    tasks = [(R.task_de_campaign, dict(path=os.path.join(workdir, "four.npz"))),
             (R.task_gather, {})]
    return R.spawn(4, tasks, os.path.join(workdir, "w4"), timeout=SPAWN_S)


def _whole(ranks, i):
    """Task ``i``'s final rows of every rank, in rank order, with the
    samples (every rank's the same: the gathered ensemble)."""
    parts = [r[i] for r in ranks]
    for p in parts[1:]:
        np.testing.assert_array_equal(p["samples"], parts[0]["samples"])
    out = {f: np.concatenate([p[f] for p in parts])
           for f in ("x", "logp", "log_scale", "accept_count")}
    return dict(out, step=parts[0]["step"], samples=parts[0]["samples"],
                sample_logps=parts[0]["sample_logps"])


def _equals_reference(got, reference):
    st, blocks, decisions = reference
    close = lambda a, b: np.testing.assert_allclose(a, b.numpy(), rtol=0,
                                                    atol=1e-12)
    assert got["step"] == st["step"] == C["segments"] * C["steps"]
    close(got["x"], st["x"])
    np.testing.assert_allclose(got["logp"], st["logp"].numpy(), rtol=1e-12)
    close(got["log_scale"], st["log_scale"])
    assert got["accept_count"].tolist() == st["accept_count"].tolist()
    close(got["samples"], torch.stack([x for x, _ in blocks]))
    # nothing vacuous: moves accepted and refused, a frozen half each step
    moved = decisions.sum(dim=0)
    assert 0 < int(decisions.sum()) < decisions.numel() // 2
    assert int(decisions[0::2, 1::2].sum()) == int(decisions[1::2, 0::2].sum()) == 0
    assert int((moved > 0).sum()) >= C["n_chains"] // 4


def test_one_rank_campaign_equals_the_reference(one_rank, reference):
    _equals_reference(one_rank, reference)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_campaign_equals_the_reference(request, world, reference):
    ranks = request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])
    _equals_reference(_whole(ranks, 0), reference)


def test_resumed_shards_equal_the_uninterrupted_campaign(two_ranks, workdir):
    """Killed after segment 0, each rank's shard on disk; resumed, every
    rank's state and the last segment's samples equal the uninterrupted
    two-rank campaign's to the bit."""
    assert all(r[1] == dict(killed=True) for r in two_ranks)
    for rank in range(2):
        mesh = EnsembleMesh(world_size=2, rank=rank, device=torch.device("cpu"))
        assert os.path.exists(shard_path(os.path.join(workdir, "cut.npz"), mesh))
    full, resumed = _whole(two_ranks, 0), _whole(two_ranks, 2)
    blocks = C["steps"] // C["thinning"]
    for f in ("x", "logp", "log_scale", "accept_count"):
        np.testing.assert_array_equal(resumed[f], full[f], err_msg=f)
    assert resumed["step"] == full["step"]
    np.testing.assert_array_equal(resumed["samples"], full["samples"][blocks:])


def test_resume_on_another_world_raises(two_ranks, workdir):
    """Two ranks refuse the one-process checkpoint; one process refuses the
    two ranks' shards, and names the count they were written by."""
    for r in two_ranks:
        assert "written by [1] process(es)" in r[3]["error"]
        assert "this run has 2" in r[3]["error"]
    got = R.task_de_campaign(None, os.path.join(workdir, "two.npz"),
                             resume=True)
    assert "written by [2] process(es)" in got["error"]


def test_shard_path():
    mesh = EnsembleMesh(world_size=4, rank=3, device=torch.device("cpu"))
    assert shard_path("out/campaign_checkpoint.npz", LOCAL) == \
        "out/campaign_checkpoint.npz"
    assert shard_path("out/campaign_checkpoint.npz", mesh) == \
        "out/campaign_checkpoint.rank3-of-4.npz"


@pytest.mark.parametrize("world", [2, 4])
def test_gather_is_the_ranks_rows_in_order(request, world):
    ranks = request.getfixturevalue({2: "two_ranks", 4: "four_ranks"}[world])
    _gathered_in_rank_order([r[-1] for r in ranks], world)


def _gathered_in_rank_order(got_by_rank, world):
    """``R.task_gather``'s results: along dims 0 and 1, with and without a
    buffer of the caller's, every rank's rows in rank order."""
    rows = torch.arange(6, dtype=F64).reshape(3, 2)
    wide = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    want = torch.cat([rows + 100 * r for r in range(world)]).numpy()
    want_wide = torch.cat([wide + 1000 * r for r in range(world)], dim=1).numpy()
    for got in got_by_rank:
        np.testing.assert_array_equal(got["rows"], want)
        np.testing.assert_array_equal(got["into"], want)
        assert got["same"] is True
        np.testing.assert_array_equal(got["wide"], want_wide)
        assert got["bytes"] == {("all_gather", "torch.float64", 6 * world):
                                2 * 6 * world * 8,
                                ("all_gather", "torch.float32", 24 * world):
                                24 * world * 4}


# ------------------------------------------------------------------ card


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def nccl_one():
    """A process group of one ``nccl`` rank on this card: the mesh's
    gather is then the collective, as on many cards."""
    import torch.distributed as dist
    from mmidv1_tpu_torch.parallel import ensemble_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    yield ensemble_mesh(device="cuda")
    dist.destroy_process_group()


def _card_campaign(mesh, path, monkeypatch, eager=False, resume=False,
                   keep=None):
    """``R.de_card_campaign``: 2048 chains, two segments of 200 steps;
    ``eager`` forces every step eager."""
    if eager:
        monkeypatch.setattr(mh, "EAGER_STEPS", 10 ** 9)
    try:
        return R.de_card_campaign(mesh, path, resume=resume, keep=keep)
    finally:
        monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["none", "nccl"])
def test_graphed_de_step_equals_eager_on_the_card(request, group, monkeypatch,
                                                  tmp_path):
    """2048 float32 chains, cash_karp@3 over 306 days, two segments of 200
    DE-MC steps: graphed (two eager steps, one capture, replays) and forced
    eager, every field of the final state and the samples equal to the
    bit; the campaign resumed at segment 1 from the graphed run's
    checkpoint too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and K1 have no CPU mode")
    mesh = LOCAL if group == "none" else request.getfixturevalue("nccl_one")
    trace.reset()
    cut = str(tmp_path / "cut.npz")
    graphed = _card_campaign(mesh, str(tmp_path / "g.npz"), monkeypatch,
                             keep=cut)
    assert trace.counts("mh.graph") == {
        ("eager", 2048, "de"): mh.EAGER_STEPS, ("capture", 2048, "de"): 1,
        ("replay", 2048, "de"): 400 - mh.EAGER_STEPS - 1}
    if mesh is not LOCAL:
        assert trace.counts("mesh.bytes", ("all_gather",)) != {}
    eager = _card_campaign(mesh, None, monkeypatch, eager=True)
    resumed = _card_campaign(mesh, cut, monkeypatch, resume=True)
    trace.reset()
    for name in mh.MHState._fields[:-1]:
        a, b = getattr(graphed.final_state, name), getattr(eager.final_state, name)
        assert torch.equal(a, b), name
        assert torch.equal(getattr(resumed.final_state, name), a), name
    assert torch.equal(graphed.samples, eager.samples)
    assert torch.equal(resumed.samples, graphed.samples[2:])
    assert int(graphed.final_state.accept_count.sum()) > 0


@pytest.mark.cuda
def test_four_nccl_ranks_equal_one_rank_on_the_cards(tmp_path):
    """On four cards, one ``nccl`` rank a card: the gather along dims 0 and
    1, with and without a kept buffer, is every rank's rows in rank order;
    the DE-MC campaign of ``R.de_card_campaign`` (2048 chains, 512 a rank,
    every step after the third replayed as graphs around the gather) gives
    the one-rank campaign's final rows and samples to the bit."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    one = R.de_card_campaign(LOCAL)        # builds the kernels, on card 0
    ranks = R.spawn(4, [(R.task_gather, {}), (R.task_de_card_campaign, {})],
                    str(tmp_path / "w"), timeout=SPAWN_S, init="nccl")
    _gathered_in_rank_order([r[0] for r in ranks], 4)
    four = [r[1] for r in ranks]
    n = R.DE_CARD["n_chains"] // 4
    steps = R.DE_CARD["segments"] * R.DE_CARD["steps"]
    for r, got in enumerate(four):
        assert got["step"] == one.final_state.step == steps
        assert got["graph"] == {
            ("eager", n, "de"): mh.EAGER_STEPS, ("capture", n, "de"): 1,
            ("replay", n, "de"): steps - mh.EAGER_STEPS - 1}
        for f in R.DE_ROWS:
            want = getattr(one.final_state, f)[r * n:(r + 1) * n]
            np.testing.assert_array_equal(got[f], want.cpu().numpy(),
                                          err_msg=f)
        np.testing.assert_array_equal(got["samples"], one.samples.cpu().numpy())
        np.testing.assert_array_equal(got["sample_logps"],
                                      one.sample_logps.cpu().numpy())
    assert int(one.final_state.accept_count.sum()) > 0


# ------------------------------------------------ the campaign's entry point

CLI = ["--device", "cpu", "--num-days", "20", "--tableau", "rk4", "--substeps",
       "1", "--chains", "8", "--thinning", "5", "--burn-in", "0",
       "--skip-report", "--proposal", "de", "--seed", "5", "--dtype", "float64"]


def _cli_on_ranks(world, argv, workdir):
    return R.spawn(world, [(R.task_campaign_cli, dict(argv=argv))], workdir,
                   timeout=SPAWN_S, init="multihost")


def test_campaign_cli_on_two_ranks(tmp_path):
    """``production_campaign --proposal de`` on two ``gloo`` ranks, killed
    after one of two segments and resumed: rank 0 alone writes the segment
    files, the trace and the parameters; each rank its checkpoint shard;
    the segments equal the one-process campaign's; PT refuses a mesh."""
    from mmidv1_tpu_torch.cli import production_campaign as pc

    full = ["--iterations", "40", "--segments", "2"]
    one, two = tmp_path / "one", tmp_path / "two"
    pc.run(CLI + full + ["--out", str(one)])
    killed = _cli_on_ranks(2, CLI + ["--iterations", "20", "--segments", "1",
                                     "--out", str(two)], str(tmp_path / "w"))
    assert [r[1] == {} for r in killed] == [False, True]
    assert sorted(os.listdir(two)) == sorted([
        "mh_segment_0000.npz", "campaign_checkpoint.rank0-of-2.npz",
        "campaign_checkpoint.rank1-of-2.npz", "posterior_trace.csv",
        "calibrated_parameters.txt", "campaign_metadata.json"])
    resumed = _cli_on_ranks(2, CLI + full + ["--out", str(two)],
                            str(tmp_path / "w"))
    assert resumed[0][1]["stored_samples"] == 2 * 4 * 8
    for s in range(2):
        name = f"mh_segment_{s:04d}.npz"
        with np.load(one / name) as a, np.load(two / name) as b:
            for k in ("samples", "sample_logps"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-12)
    with np.load(two / "campaign_checkpoint.rank1-of-2.npz") as z:
        assert int(z["step"]) == 40 and z["x"].shape == (4, 62)
    with pytest.raises(RuntimeError, match="--rungs > 1 runs on one process"):
        _cli_on_ranks(2, CLI + ["--rungs", "2", "--out", str(tmp_path / "pt")],
                      str(tmp_path / "w"))


def _segment_bytes(out):
    return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))
            if f.startswith("mh_segment_")}


def test_campaign_cli_on_another_world_keeps_the_segments(tmp_path):
    """A campaign restarted on another number of processes refuses to resume
    and leaves the directory's segment files as they were: two ranks in a
    one-process campaign's directory, one process in two ranks'."""
    from mmidv1_tpu_torch.cli import production_campaign as pc

    one, two = tmp_path / "one", tmp_path / "two"
    seg = CLI + ["--iterations", "20", "--segments", "1"]
    pc.run(seg + ["--out", str(one)])
    _cli_on_ranks(2, seg + ["--out", str(two)], str(tmp_path / "w"))
    kept = {d: _segment_bytes(d) for d in (one, two)}
    assert all(list(k) == ["mh_segment_0000.npz"] for k in kept.values())
    restart = CLI + ["--iterations", "40", "--segments", "2"]
    with pytest.raises(RuntimeError, match=r"written by \[1\] process\(es\)"):
        _cli_on_ranks(2, restart + ["--out", str(one)], str(tmp_path / "w"))
    with pytest.raises(ValueError, match=r"written by \[2\] process\(es\)"):
        pc.run(restart + ["--out", str(two)])
    assert {d: _segment_bytes(d) for d in (one, two)} == kept
