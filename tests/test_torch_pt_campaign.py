"""The port's parallel tempering against the plain reference of the
benchmark (``h100_bench/reference/tempering.py``, written from the
published description and importing nothing of the port), and its campaign
driver ``run_pt_checkpointed``.

Host tests: ``make_pt_runner`` equals the reference on explicit draws on
the Spain-2020 space in float64 (both swap parities, the ladder moving in
burn-in, the covariances every block) at 1e-12; a campaign killed after one
of two segments and resumed equals the uninterrupted one to the bit; the
tracer's ``pt.*`` spans and the ``pt.sweeps`` counter. Card test (marked
``cuda``): at the benchmark cell's 8 x 1024 in float64, 20 steps of the
runner on K1 against the reference on the plain Spain objective with the
same draws. This file imports nothing of JAX, so the card can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pt_campaign.py -m cuda
"""

import os
import sys

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch.calibration import tempering
from mmidv1_tpu_torch.calibration.calibrator import condition_covariance
from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
from mmidv1_tpu_torch.calibration.param_space import REFLECT
from mmidv1_tpu_torch.calibration.tempering import (PTConfig, init_pt_state,
                                                    make_pt_runner,
                                                    run_pt_checkpointed)
from mmidv1_tpu_torch.cli.common import load_spain_pipeline
from mmidv1_tpu_torch.data import read_sepaihrd_parameters
from mmidv1_tpu_torch.ops import build_objective_fused
from mmidv1_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from h100_bench.reference.tempering import PTReference  # noqa: E402

TREE = os.path.join(REPO, "h100_bench", "data", "spain2020")
F64 = torch.float64


class Table:
    """Explicit draws of ``steps`` steps for ``K`` rungs of ``N`` chains in
    ``d`` dimensions, the same tensors to whoever asks."""

    def __init__(self, seed, steps, K, N, d, device="cpu"):
        g = torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=g, dtype=F64, device=device)
        self.z0 = torch.randn((K * N, d), **kw)
        self.z = torch.randn((steps, K * N, d), **kw)
        self.u = torch.rand((steps, K * N), **kw)
        self.us = torch.rand((steps, max(K - 1, 1), N), **kw)
        self.shape = (K - 1, N)

    def init(self):
        return self.z0.clone()

    def step(self, i):
        return self.z[i].clone(), self.u[i].clone()

    def swap(self, i, shape):
        assert tuple(shape) == self.shape
        return self.us[i].clone()


def _spain(device, num_days, tableau="cash_karp", substeps=3):
    """The frozen Spain-2020 tree's space, its MAP, the posterior covariance
    conditioned as the campaigns do, and K1 (REFLECT) in float64."""
    pipe = load_spain_pipeline(TREE, dtype=F64, device=device, num_days=num_days)
    space = pipe.space
    init = read_sepaihrd_parameters(
        os.path.join(TREE, "calibrated_parameters.txt"), 4,
        N=pipe.data.population_by_age,
        M_baseline=pipe.params.M_baseline.cpu().numpy(), dtype=F64, device=device)
    theta0 = space.extract(init)
    with np.load(os.path.join(TREE, "posterior_cov.npz")) as z:
        cov = torch.as_tensor(z["cov"]).to(device=device, dtype=F64)
    cov0 = condition_covariance(cov, space.sigmas)
    ll = build_objective_fused(space, pipe.params, pipe.data, pipe.ts,
                               substeps=substeps, tableau=tableau,
                               constraint_mode=REFLECT, dtype=F64, device=device)
    return space, theta0, cov0, ll


@pytest.fixture(scope="module")
def spain30():
    return _spain("cpu", 30)


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


# --------------------------------------------------- against the reference


def test_runner_equals_the_plain_reference(spain30):
    """4 rungs x 8 chains, 3 blocks of 4 steps, a swap sweep every step
    (both parities), the ladder moving through burn-in (8 steps), every
    rung's covariance re-estimated every block: every field of the state
    and the cold rung's samples at 1e-12, the counters exactly."""
    space, theta0, cov0, ll = spain30
    K, N, d = 4, 8, space.dim
    kw = dict(burn_in=8, adaptation_period=4, thinning=4, ladder_kappa=0.5,
              ladder_t0=5.0)
    cfg = PTConfig(iterations=12, n_rungs=K, beta_min=0.05, **kw)
    draws = Table(11, 12, K, N, d)
    betas = cfg.ladder(F64)
    st0 = init_pt_state(space, theta0, ll, draws.init(), n_rungs=K, n_chains=N,
                        jitter=3.0, initial_cov=cov0, betas=betas)
    res = make_pt_runner(space, cfg, ll)(st0, draws)

    ref = PTReference(ll, space.lower, space.upper, **kw)
    st = ref.init(theta0, space.sigmas, draws.init(), cov0, betas, K, N, jitter=3.0)
    decisions = []
    cold = ref.run(st, draws, 12, decisions)

    fs = res.final_state
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
    for name in ("x", "logp", "log_scale", "betas", "swap_prob", "cov", "chol"):
        close(getattr(fs, name), st[name])
    close(fs.ladder_s, st["spacings"])
    for name in ("swap_accept", "swap_tries", "accept_count"):
        assert getattr(fs, name).tolist() == st[name].tolist(), name
    close(res.samples, torch.stack([x for x, _ in cold]))
    close(res.sample_logps, torch.stack([lp for _, lp in cold]))
    assert fs.step == st["step"] == 12
    # nothing here is vacuous: proposals accepted and refused, swaps made on
    # both parities, the ladder moved off its start
    acc = torch.stack([a for a, _ in decisions])
    assert 0 < int(acc.sum()) < acc.numel()
    assert all(t > 0 for t in fs.swap_tries.tolist())
    assert int(fs.swap_accept.sum()) > 0
    assert not torch.equal(fs.betas, betas)
    assert float(fs.betas[0]) == 1.0


# ------------------------------------------------------------ the campaign


def _campaign(spain30, path, *, segments=2, kill_after=None, resume=False,
              kept=None, progress_fn=None):
    """A checkpointed PT campaign on the host (4 rungs x 4 chains, segments
    of 8 steps, thinning 4, burn-in 6); ``kill_after`` stops it once that
    many segments are on disk; ``kept`` collects each segment's result."""
    space, theta0, cov0, ll = spain30
    cfg = PTConfig(iterations=8 * segments, burn_in=6, adaptation_period=4,
                   thinning=4, n_rungs=4, beta_min=0.05, ladder_t0=5.0)

    class Killed(Exception):
        pass

    def draws_for_segment(s):
        if kill_after is not None and s == kill_after:
            raise Killed
        return SeededRunDraws(5, s, 16, space.dim, F64, "cpu")

    def on_segment(s, r):
        if kept is not None:
            kept.append((s, r.samples.clone(), r.sample_logps.clone()))

    try:
        return run_pt_checkpointed(ll, space, theta0, cfg, seed=5, n_chains=4,
                                   segments=segments, checkpoint_path=str(path),
                                   resume=resume, initial_cov=cov0,
                                   progress_fn=progress_fn,
                                   on_segment=on_segment,
                                   draws_for_segment=draws_for_segment)
    except Killed:
        return None


def test_killed_and_resumed_campaign_equals_uninterrupted(spain30, tmp_path):
    full_kept, resumed_kept = [], []
    full = _campaign(spain30, tmp_path / "full.npz", kept=full_kept)
    path = tmp_path / "killed.npz"
    assert _campaign(spain30, path, kill_after=1, kept=resumed_kept) is None
    resumed = _campaign(spain30, path, resume=True, kept=resumed_kept)
    assert [s for s, *_ in resumed_kept] == [0, 1]
    for (_, a, la), (_, b, lb) in zip(full_kept, resumed_kept):
        assert torch.equal(a, b) and torch.equal(la, lb)
    for name in tempering.PTState._fields:
        a, b = getattr(full.final_state, name), getattr(resumed.final_state, name)
        assert (a == b) if name == "step" else torch.equal(a, b), name
    assert resumed.samples.shape[0] == 2          # this process ran segment 1
    assert torch.equal(resumed.samples, full.samples[2:])
    with np.load(tmp_path / "full.npz") as za, np.load(path) as zb:
        assert za.files == zb.files
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    with pytest.raises(ValueError, match="already covers"):
        _campaign(spain30, path, resume=True)


def test_spans_and_sweeps_of_a_segment(spain30, tmp_path):
    """One segment of 8 steps (a sweep a step, 6 of them in burn-in, 2
    blocks) with the tracer on: each ``pt.*`` span, ``pt.step`` once a step
    and holding the objective's span, and ``pt.sweeps`` once a sweep by
    parity. Off, no span is recorded and the samples are the same bits.
    ``progress_fn`` hears of each block's end."""
    progress = []
    trace.enable()
    on = _campaign(spain30, tmp_path / "on.npz", segments=1,
                   progress_fn=lambda *a: progress.append(a))
    snap = trace.snapshot()
    trace.disable()
    sp = snap["spans"]
    counts = {name: s["count"] for name, s in sp.items()}
    steps = 8
    assert counts["pt.step"] == steps and counts["pt.swap"] == steps
    assert counts["pt.draws"] == 2 * steps           # the step's and the sweep's
    assert counts["pt.adapt_ladder"] == 6
    assert counts["pt.adapt_cov"] == 2
    for name in ("pt.finish", "campaign.segment", "campaign.to_host",
                 "campaign.checkpoint"):
        assert counts[name] == 1, name
    assert counts["objective"] == steps + 1          # the start's call included
    assert sp["pt.step"]["self_s"] < sp["pt.step"]["total_s"]
    assert sp["pt.step"]["total_s"] <= sp["campaign.segment"]["total_s"]
    assert snap["counters"]["pt.sweeps"] == {(0, 4, 4): 4, (1, 4, 4): 4}
    assert [p[0] for p in progress] == [4, 8]
    assert all(0.0 <= p[1] <= 1.0 and p[3] > 0.0 for p in progress)
    assert progress[-1][2] == float(on.best_logp)

    trace.reset()
    off = _campaign(spain30, tmp_path / "off.npz", segments=1)
    snap = trace.snapshot()
    assert snap["spans"] == {}
    # counters count with the spans off, as every counter of the tracer does
    assert snap["counters"]["pt.sweeps"] == {(0, 4, 4): 4, (1, 4, 4): 4}
    for name in ("x", "logp", "betas", "chol"):
        assert torch.equal(getattr(on.final_state, name),
                           getattr(off.final_state, name))
    assert torch.equal(on.samples, off.samples)


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode; the host test "
                    "above holds the plain version")
    return torch.device("cuda")


@pytest.mark.cuda
def test_runner_on_k1_follows_the_reference_on_the_card(cuda):
    """8 rungs x 1024 chains, float64, the full Spain-2020 window on
    cash_karp@3, 20 steps with a sweep each (the ladder and the covariances
    held, so the chain columns are independent): the runner on K1 against
    the reference on the plain Spain objective, fed the same draws. Every
    decision (accept a step, exchange a sweep) is compared; in every column
    where all agree the positions agree to 1e-9, and at most a handful of
    columns part."""
    from h100_bench.reference.spain import SpainReference

    space, theta0, cov0, ll = _spain(cuda, None)
    K, N, d, steps = 8, 1024, space.dim, 20
    kw = dict(burn_in=0, adaptation_period=100, thinning=steps)
    cfg = PTConfig(iterations=steps, n_rungs=K, beta_min=0.05, **kw)
    draws = Table(2024, steps, K, N, d, device=cuda)
    betas = cfg.ladder(F64, cuda)

    mine = []
    step_fn, swap_fn = tempering.pt_mh_step, tempering.pt_swap_step

    def mh_step(state, *a, **k):
        new = step_fn(state, *a, **k)
        mine.append([new.accept_count > state.accept_count, None])
        return new

    def swap_step(state, u, b, parity, **k):
        new = swap_fn(state, u, b, parity, **k)
        moved = torch.any(new.x[:-1] != state.x[:-1], dim=-1)
        on = (torch.arange(K - 1, device=cuda) % 2 == parity % 2)[:, None]
        mine[-1][1] = moved & on
        return new

    st0 = init_pt_state(space, theta0, ll, draws.init(), n_rungs=K, n_chains=N,
                        initial_cov=cov0, betas=betas)
    saved = tempering.pt_mh_step, tempering.pt_swap_step
    tempering.pt_mh_step, tempering.pt_swap_step = mh_step, swap_step
    try:
        fs = make_pt_runner(space, cfg, ll)(st0, draws).final_state
    finally:
        tempering.pt_mh_step, tempering.pt_swap_step = saved

    plain = SpainReference(os.path.join(TREE, "data"), tableau="cash_karp",
                           substeps=3, device=cuda)
    ref = PTReference(plain.loglik, space.lower, space.upper, **kw)
    st = ref.init(theta0, space.sigmas, draws.init(), cov0, betas, K, N)
    theirs = []
    ref.run(st, draws, steps, theirs)

    differ = torch.zeros(N, dtype=torch.bool, device=cuda)
    n_decisions = 0
    for (a, ex), (b, ex_r) in zip(mine, theirs):
        differ |= torch.any(a != b, dim=0) | torch.any(ex != ex_r, dim=0)
        n_decisions += int((a != b).sum()) + int((ex != ex_r).sum())
    same = ~differ
    gap = ((fs.x - st["x"]).abs()
           / st["x"].abs().clamp_min(1e-12)).amax(dim=(0, 2))
    print(f"columns parted: {int(differ.sum())} of {N}; decisions differing: "
          f"{n_decisions}; largest relative position gap elsewhere: "
          f"{float(gap[same].max()):.3e}")
    assert float(gap[same].max()) <= 1e-9
    assert int(differ.sum()) <= 5
    assert 0 < int(fs.swap_accept.sum())
