"""The single-rank AM-MH step replayed as two CUDA graphs around the
objective call (``calibration.mh._StepGraphs``) and its draw source.

This file imports nothing of JAX, so the card (which has no JAX) can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_graph.py

Host tests: the step split in two (``mh_propose``, ``mh_accept``), and the
two parts on the graphs' fixed buffers, equal the step as it was written
before the split bit for bit on the Spain-2020 space, float32 and float64,
with proposals reflected into the bounds and values floored, infinite and
NaN; ``SeededRunDraws``'s reseeded generators draw what a new generator a
step drew; host steps and DE-MC stay eager. Card tests (marked ``cuda``):
at the benchmark's two shapes (1024 chains dopri5@4, 8192 cash_karp@3,
float32), a campaign of 2 segments of 1000 steps with the graphs equals the
same campaign forced eager bit for bit, and one resumed at segment 1 equals
it too; the objective is called once a step.
"""

import math
import os

import pytest
import torch

from mmidv1_tpu_torch.calibration import mh
from mmidv1_tpu_torch.calibration.draws import SeededRunDraws, seeded_generator
from mmidv1_tpu_torch.calibration.mh import (MHConfig, adapt_covariance,
                                             init_mh_state, run_mh,
                                             run_mh_checkpointed, safe_logp)
from mmidv1_tpu_torch.calibration.param_space import REFLECT
from mmidv1_tpu_torch.cli.common import load_spain_pipeline
from mmidv1_tpu_torch.ops import build_objective_fused
from mmidv1_tpu_torch.utils import trace

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("x", "logp", "log_scale", "chol", "cov", "best_x", "best_logp",
          "accept_count")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and K1 have no CPU mode "
                    "(run this file on the card)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def assert_bit_equal(a, b, what=""):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(bits(a) if a.is_floating_point() else a,
                       bits(b) if b.is_floating_point() else b), what


def assert_same_state(a, b):
    for f in FIELDS:
        assert_bit_equal(getattr(a, f), getattr(b, f), f)
    assert a.step == b.step


def legacy_mh_step(state, z, u, space, loglik_batch, cfg):
    """The AM step as :func:`mh.mh_step` was written before its split into
    ``mh_propose`` and ``mh_accept`` (the DE branch left out)."""
    dtype = state.x.dtype
    scale = torch.exp(state.log_scale)[:, None]
    proposal = state.x + scale * (z @ state.chol.T)
    proposal = space.reflect(proposal)

    logp_prop = safe_logp(loglik_batch(proposal))
    log_ratio = logp_prop - state.logp
    log_u = torch.log(torch.clamp_min(u, 1e-12))
    accept = (log_ratio >= 0) | (log_u < log_ratio)

    x = torch.where(accept[:, None], proposal, state.x)
    logp = torch.where(accept, logp_prop, state.logp)

    better = logp > state.best_logp
    best_x = torch.where(better[:, None], x, state.best_x)
    best_logp = torch.where(better, logp, state.best_logp)

    step = state.step + 1
    if cfg.adapt_scale:
        gamma = min(1.0 / math.sqrt(step + 1.0), 0.1)
        delta = accept.to(dtype) - cfg.target_acceptance_rate
        log_scale = torch.clamp(state.log_scale + gamma * delta, -6.9, 2.3)
    else:
        log_scale = state.log_scale

    return state._replace(
        x=x, logp=logp, log_scale=log_scale, best_x=best_x, best_logp=best_logp,
        accept_count=state.accept_count + accept.to(torch.int32), step=step)


# --- host (tier-1) ----------------------------------------------------------

def _spain_host(dtype, B):
    """The Spain-2020 space (20 days, rk4@1, REFLECT) on the host,
    ``objective(k)``: its objective with one value overridden at step ``k``
    (row 1 NaN, row 2 -inf, row 3 +inf, row 4 the floor, in turn), and a
    start of ``B`` chains with wide scales, so that proposals leave the
    bounds, at a step past the gain's cap of 0.1 (from step 99 on it
    changes every step)."""
    pipe = load_spain_pipeline(REPO, dtype=dtype, device="cpu", num_days=20)
    space = pipe.space
    ll = build_objective_fused(space, pipe.params, pipe.data, pipe.ts,
                               substeps=1, tableau="rk4",
                               constraint_mode=REFLECT, dtype=dtype,
                               device="cpu")

    def objective(k):
        def f(x):
            v = ll(x).clone()
            v[1 + k % 4] = (float("nan"), -math.inf, math.inf,
                            torch.finfo(dtype).min)[k % 4]
            return v
        return f

    g = torch.Generator().manual_seed(11)
    theta0 = space.extract(pipe.params).to(dtype)
    state = init_mh_state(space, theta0, ll,
                          torch.randn(B, space.dim, generator=g, dtype=dtype))
    scales = torch.linspace(-1.0, 2.3, B, dtype=dtype)
    return space, objective, state._replace(log_scale=scales, step=4321), g


@pytest.mark.parametrize("adapt_scale", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_step_and_its_buffers_equal_the_legacy_step(dtype, adapt_scale):
    """Eight steps three ways from one start and one set of draws, the
    covariance re-estimated after the fourth: the step as it was written,
    :func:`mh.mh_step` (the two parts composed, the gain a Python float),
    and the step graphs' body on their fixed buffers (the gain a 0-dim
    tensor, the new state copied into the buffers). Every field is bit-equal
    after every step; some raw proposals lay outside the bounds and some
    values were NaN, infinite or floored."""
    B = 12
    cfg = MHConfig(adapt_scale=adapt_scale)
    space, objective, start, g = _spain_host(dtype, B)
    draws = [(torch.randn(B, space.dim, generator=g, dtype=dtype),
              torch.rand(B, generator=g, dtype=dtype)) for _ in range(8)]
    legacy = split = start
    bufs = mh._StepBuffers(start, space, cfg)
    held = start
    outside = 0
    for i, (z, u) in enumerate(draws):
        raw = legacy.x + torch.exp(legacy.log_scale)[:, None] * (
            z @ legacy.chol.T)
        outside += int((~space.in_bounds(raw)).sum())
        legacy = legacy_mh_step(legacy, z, u, space, objective(i), cfg)
        split = mh.mh_step(split, z, u, space, objective(i), cfg)
        bufs.load(held, z, u)
        proposal = bufs.propose()
        bufs.lp.copy_(objective(i)(proposal))
        bufs.accept(proposal)
        held = bufs.result(held)
        for f in ("x", "logp", "log_scale", "best_x", "best_logp",
                  "accept_count"):
            assert getattr(held, f) is getattr(bufs.state, f)
        assert_same_state(split, legacy)
        assert_same_state(held, legacy)
        if i == 3:
            legacy = adapt_covariance(legacy, cfg)
            split = adapt_covariance(split, cfg)
            held = adapt_covariance(held, cfg)
            assert held.chol is not bufs.state.chol
    assert outside > 0
    assert bool(torch.isfinite(legacy.logp).all())
    assert int(legacy.accept_count.sum()) > 0


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 12345])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reseeded_draws_equal_new_generators(seed, dtype):
    """A :class:`SeededRunDraws` keeps one generator a purpose and reseeds
    it: its draws, in any order and repeated, equal those of a new
    :func:`seeded_generator` of the same ``(purpose, segment, step)`` words,
    as every draw was made before."""
    n, d = 10, 7

    def fresh(purpose, segment, i=0):
        return seeded_generator(seed, (purpose, segment, i), "cpu")

    for segment in (0, 1, 37):
        src = SeededRunDraws(seed, segment, n, d, dtype, "cpu")
        want = torch.randn((n, d), generator=fresh(0, segment), dtype=dtype)
        assert_bit_equal(src.init(), want)
        for i in (0, 1, 2, 999, 1, 1, 0, 5000):
            z, u = src.step(i)
            gen = fresh(1, segment, i)
            assert_bit_equal(z, torch.randn((n, d), generator=gen, dtype=dtype))
            assert_bit_equal(u, torch.rand((n,), generator=gen, dtype=dtype))
            j, k, g_u = src.partners(i)
            gen = fresh(2, segment, i)
            assert torch.equal(j, torch.randint(0, n // 2, (n,), generator=gen))
            assert torch.equal(k, torch.randint(0, n // 2, (n,), generator=gen))
            assert_bit_equal(g_u, torch.rand((n,), generator=gen, dtype=dtype))
            assert_bit_equal(src.swap(i, (3, n)), torch.rand(
                (3, n), generator=fresh(3, segment, i), dtype=dtype))
        assert sorted(src._gens) == [0, 1, 2, 3]


def _tiny_run(proposal):
    pipe = load_spain_pipeline(REPO, dtype=torch.float64, device="cpu",
                               num_days=15)
    ll = build_objective_fused(pipe.space, pipe.params, pipe.data, pipe.ts,
                               substeps=1, tableau="rk4",
                               constraint_mode=REFLECT, device="cpu")
    cfg = MHConfig(iterations=6, burn_in=2, thinning=2, adaptation_period=2,
                   proposal=proposal)
    theta0 = pipe.space.extract(pipe.params)
    return run_mh(ll, pipe.space, theta0, cfg, n_chains=8, jitter=0.1,
                  draws=SeededRunDraws(5, 0, 8, pipe.space.dim, torch.float64,
                                       "cpu"))


def test_host_and_de_steps_stay_eager():
    """On the host every AM step and every DE-MC step is eager and counted
    so (DE-MC's under its own keys); both runs return their thinned
    samples."""
    am = _tiny_run("am")
    assert trace.counts("mh.graph") == {("eager", 8): 6}
    trace.reset()
    de = _tiny_run("de")
    assert trace.counts("mh.graph") == {("eager", 8, "de"): 6}
    for res in (am, de):
        assert res.samples.shape == (3, 8, res.final_state.x.shape[1])
        assert bool(torch.isfinite(res.sample_logps).all())


# --- card -------------------------------------------------------------------

CARD_SHAPES = [(1024, "dopri5", 4, 100), (8192, "cash_karp", 3, 500)]
SEGMENT = 1000


class _Stop(Exception):
    pass


def _campaign(cuda, B, tableau, substeps, thinning, *, path=None,
              segments=2, resume=False, stop_at=None, on_segment=None):
    """A campaign of ``segments`` segments of 1000 AM steps at the
    benchmark's settings, on K1 (float32); with ``stop_at`` it stops before
    that segment (after the checkpoint of the one before). Returns the
    result (None where stopped) and the objective's calls."""
    pipe = load_spain_pipeline(REPO, dtype=torch.float32, device=cuda)
    ll = build_objective_fused(pipe.space, pipe.params, pipe.data, pipe.ts,
                               substeps=substeps, tableau=tableau,
                               constraint_mode=REFLECT, dtype=torch.float32,
                               device=cuda)
    calls = [0]

    def objective(x):
        calls[0] += 1
        return ll(x)

    def draws_for_segment(s):
        if s == stop_at:
            raise _Stop
        return SeededRunDraws(3000000001, s, B, pipe.space.dim, torch.float32,
                              cuda)

    cfg = MHConfig(iterations=SEGMENT * segments, burn_in=500,
                   adaptation_period=100, thinning=thinning)
    theta0 = pipe.space.extract(pipe.params).to(torch.float32)
    try:
        res = run_mh_checkpointed(objective, pipe.space, theta0, cfg,
                                  n_chains=B, segments=segments,
                                  checkpoint_path=path, resume=resume,
                                  on_segment=on_segment,
                                  draws_for_segment=draws_for_segment)
    except _Stop:
        res = None
    torch.cuda.synchronize(cuda)
    return res, calls[0]


def assert_same_result(a, b):
    for f in ("samples", "sample_logps", "best_x", "best_logp",
              "acceptance_rate", "final_cov", "final_scale"):
        assert_bit_equal(getattr(a, f), getattr(b, f), f)
    assert_same_state(a.final_state, b.final_state)


@pytest.mark.cuda
@pytest.mark.parametrize("B,tableau,substeps,thinning", CARD_SHAPES)
def test_graphed_campaign_equals_eager(cuda, monkeypatch, tmp_path, B, tableau,
                                       substeps, thinning):
    """Two segments of 1000 steps from one seed: with the step graphs
    (eager twice, one capture, replays after) and forced eager, the samples,
    values, final states, scales, accept counts and best are bit-equal; the
    campaign resumed at segment 1 from the graphed run's checkpoint (its
    first two steps eager again) equals the uninterrupted run's segment 1;
    the objective is called once a step and once at the start; kept results
    are not the graphs' buffers."""
    steps = 2 * SEGMENT
    first = []

    def keep_first(s, result):
        if s == 0:
            st = result.final_state
            first.append((result, [getattr(st, f).clone() for f in FIELDS],
                          result.samples.clone(), result.sample_logps.clone()))

    graphed, n = _campaign(cuda, B, tableau, substeps, thinning,
                           path=str(tmp_path / "full.npz"),
                           on_segment=keep_first)
    assert n == steps + 1
    assert trace.counts("mh.graph") == {
        ("eager", B): mh.EAGER_STEPS, ("capture", B): 1,
        ("replay", B): steps - mh.EAGER_STEPS - 1}
    assert graphed.final_state.step == steps

    trace.reset()
    monkeypatch.setattr(mh, "EAGER_STEPS", 10 ** 9)
    eager, n = _campaign(cuda, B, tableau, substeps, thinning)
    assert n == steps + 1
    assert trace.counts("mh.graph") == {("eager", B): steps}
    monkeypatch.undo()
    assert_same_result(graphed, eager)
    assert int(graphed.final_state.accept_count.min()) > 0

    path = str(tmp_path / "killed.npz")
    stopped, _ = _campaign(cuda, B, tableau, substeps, thinning, path=path,
                           stop_at=1)
    assert stopped is None
    resumed, n = _campaign(cuda, B, tableau, substeps, thinning, path=path,
                           resume=True)
    assert n == SEGMENT
    per = graphed.samples.shape[0] // 2
    assert_bit_equal(resumed.samples, graphed.samples[per:])
    assert_bit_equal(resumed.sample_logps, graphed.sample_logps[per:])
    assert_same_state(resumed.final_state, graphed.final_state)

    # segment 0's result, kept while segment 1 ran on the same graphs, is
    # as it was handed over: copies, not the buffers the steps overwrite
    (res0, state0, samples0, logps0), = first
    for f, want in zip(FIELDS, state0):
        assert_bit_equal(getattr(res0.final_state, f), want, f)
    assert_bit_equal(res0.samples, samples0)
    assert_bit_equal(res0.sample_logps, logps0)
    assert not torch.equal(res0.final_state.x, graphed.final_state.x)



@pytest.mark.cuda
@pytest.mark.parametrize("user", ["objective", "step"])
def test_a_replay_adds_what_its_capture_took_back(cuda, monkeypatch, user):
    """For both users of the graph cache, at 64 chains (float32, dopri5@4):
    every call counts one prep, one K1 (split) and one mask launch (the AM
    step: its objective call's), eager, capturing or replayed; a capture
    takes back what it counted (the step's own graphs: nothing, they launch
    no kernel of the port) and each replay adds exactly that again."""
    pipe = load_spain_pipeline(REPO, dtype=torch.float32, device=cuda)
    ll = build_objective_fused(pipe.space, pipe.params, pipe.data, pipe.ts,
                               substeps=4, tableau="dopri5",
                               constraint_mode=REFLECT, dtype=torch.float32,
                               device=cuda)
    B, d = 64, pipe.space.dim
    g = torch.Generator(device=cuda).manual_seed(7)
    theta0 = pipe.space.extract(pipe.params).to(torch.float32)
    x = pipe.space.reflect(theta0 + 0.1 * pipe.space.sigmas.to(torch.float32)
                           * torch.randn(B, d, generator=g, device=cuda))
    if user == "objective":
        run, counter = (lambda: ll(x)), "objective.graph"
    else:
        state = init_mh_state(pipe.space, x, ll, None)
        ll(x)                    # the objective replays from here on
        graphs = mh._StepGraphs(pipe.space, MHConfig())

        def run():
            nonlocal state
            z = torch.randn(B, d, generator=g, device=cuda)
            u = torch.rand(B, generator=g, device=cuda)
            state = graphs(state, z, u, ll)

        counter = "mh.graph"
    eager = 1 if user == "objective" else mh.EAGER_STEPS
    one_call = [(("prep", REFLECT, B), 1), (("k1", 1, "dopri5", B), 1),
                (("mask", B), 1)]
    calls = []
    count = trace.count
    monkeypatch.setattr(trace, "count", lambda name, key=(), n=1: (
        calls.append((name, key, n)), count(name, key, n))[1])
    for kind in ["eager"] * eager + ["capture", "replay", "replay"]:
        calls.clear()
        run()
        assert [(k, n) for name, k, n in calls if name == counter] == [
            ((kind, B), 1)]
        launches = [(k, n) for name, k, n in calls if name == "launches"]
        taken = [(k, -n) for k, n in launches if n < 0]
        added = [(k, n) for k, n in launches if n > 0]
        if kind == "capture" and user == "objective":
            # counted while captured, taken back, added by the replay
            assert taken == one_call and added == one_call * 2
        else:
            assert taken == [] and added == one_call, kind
    if user == "step":
        entry, = graphs.cache.entries.values()
        assert entry.counts == [[], []]
    torch.cuda.synchronize(cuda)
