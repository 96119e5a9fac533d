"""The port's parallel tempering against the plain reference of the
benchmark (``h100_bench/reference/tempering.py``, written from the
published description and importing nothing of the port), and its campaign
driver ``run_pt_checkpointed``.

Host tests: ``make_pt_runner`` equals the reference on explicit draws on
the Spain-2020 space in float64 (both swap parities, the ladder moving in
burn-in, the covariances every block) at 1e-12; a campaign killed after one
of two segments and resumed equals the uninterrupted one to the bit; the
tracer's ``pt.*`` spans and the ``pt.sweeps`` counter. The step graphs
(``tempering._StepGraphs``): the step split in three parts (propose,
accept, swap) and the parts on the graphs' fixed buffers equal the step
and the sweep as they were written before the split, bit for bit; the
graphed runner, its graphs stood in for by recordings of the operations
their callables ran, equals the runner forced eager bit for bit through a
killed and resumed campaign; host steps stay eager. Card tests (marked
``cuda``): at the benchmark cell's 8 x 1024 in float64, 20 steps of the
runner on K1 against the reference on the plain Spain objective with the
same draws; at 8 x 1024 cash_karp@3 in float32, a campaign of two segments
of 1000 steps graphed equals it forced eager, and resumed, bit for bit.
This file imports nothing of JAX, so the card can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pt_campaign.py -m cuda
"""

import contextlib
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

from mmidv1_tpu_torch.calibration import mh, tempering
from mmidv1_tpu_torch.calibration.calibrator import condition_covariance
from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
from mmidv1_tpu_torch.calibration.param_space import REFLECT
from mmidv1_tpu_torch.calibration.mh import safe_logp
from mmidv1_tpu_torch.calibration.tempering import (PTConfig, init_pt_state,
                                                    make_pt_runner,
                                                    pt_adapt_covariance,
                                                    pt_adapt_ladder, run_pt,
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
              kept=None, progress_fn=None, swap_every=1, raw=None):
    """A checkpointed PT campaign on the host (4 rungs x 4 chains, segments
    of 8 steps, thinning 4, burn-in 6); ``kill_after`` stops it once that
    many segments are on disk; ``kept`` collects each segment's samples,
    ``raw`` each segment's result as handed over with copies of it."""
    space, theta0, cov0, ll = spain30
    cfg = PTConfig(iterations=8 * segments, burn_in=6, adaptation_period=4,
                   thinning=4, n_rungs=4, beta_min=0.05, ladder_t0=5.0,
                   swap_every=swap_every)

    class Killed(Exception):
        pass

    def draws_for_segment(s):
        if kill_after is not None and s == kill_after:
            raise Killed
        return SeededRunDraws(5, s, 16, space.dim, F64, "cpu")

    def on_segment(s, r):
        if kept is not None:
            kept.append((s, r.samples.clone(), r.sample_logps.clone()))
        if raw is not None:
            raw.append((r, _copies(r)))

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


# ------------------------------------------------------------ step graphs

STATE_FIELDS = ("x", "logp", "log_scale", "chol", "cov", "best_x",
                "best_logp", "accept_count", "swap_accept", "swap_tries",
                "betas", "ladder_s", "swap_prob")
RESULT_FIELDS = ("samples", "sample_logps", "best_x", "best_logp",
                 "acceptance_rate", "swap_rate")


def bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def assert_bit_equal(a, b, what=""):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.is_floating_point():
        a, b = bits(a), bits(b)
    assert torch.equal(a, b), what


def assert_same_state(a, b):
    for f in STATE_FIELDS:
        assert_bit_equal(getattr(a, f), getattr(b, f), f)
    assert a.step == b.step


def _copies(result):
    """Copies of every tensor of a :class:`PTResult` and its state."""
    st = result.final_state
    return ({f: getattr(st, f).clone() for f in STATE_FIELDS},
            {f: getattr(result, f).clone() for f in RESULT_FIELDS})


def legacy_pt_mh_step(state, z, u, space, loglik_batch, cfg, betas):
    """The tempered step as :func:`tempering.pt_mh_step` was written before
    its split into ``pt_propose`` and ``pt_accept``."""
    K, N, d = state.x.shape
    dtype = state.x.dtype
    scale = torch.exp(state.log_scale)[..., None]
    corr = torch.einsum("knd,ked->kne", z, state.chol)
    proposal = space.reflect(state.x + scale * corr)

    logp_prop = safe_logp(loglik_batch(proposal.reshape(K * N, d))) \
        .reshape(K, N)
    log_ratio = betas[:, None] * (logp_prop - state.logp)
    accept = (log_ratio >= 0) | (torch.log(torch.clamp_min(u, 1e-12))
                                 < log_ratio)

    x = torch.where(accept[..., None], proposal, state.x)
    logp = torch.where(accept, logp_prop, state.logp)

    better = logp > state.best_logp
    best_x = torch.where(better[..., None], x, state.best_x)
    best_logp = torch.where(better, logp, state.best_logp)

    step = state.step + 1
    if cfg.adapt_scale:
        gamma = min(1.0 / np.sqrt(step + 1.0), 0.1)
        log_scale = torch.clamp(state.log_scale + gamma * (
            accept.to(dtype) - cfg.target_acceptance_rate), -6.9, 2.3)
    else:
        log_scale = state.log_scale

    return state._replace(
        x=x, logp=logp, log_scale=log_scale, best_x=best_x,
        best_logp=best_logp,
        accept_count=state.accept_count + accept.to(torch.int32), step=step)


def legacy_pt_swap_step(state, u, betas, parity, ema=0.1):
    """The swap sweep as :func:`tempering.pt_swap_step` was written before
    it took its pair mask as a tensor (one rank)."""
    K, N, _d = state.x.shape
    dev = state.x.device
    dlogp = state.logp[1:] - state.logp[:-1]
    dbeta = (betas[:-1] - betas[1:])[:, None]
    log_alpha = dbeta * dlogp
    pair_on = (torch.arange(K - 1, device=dev) % 2) == (parity % 2)
    accept = ((log_alpha >= 0) | (torch.log(torch.clamp_min(u, 1e-12))
                                  < log_alpha)) & pair_on[:, None]

    p_pair = torch.sum(torch.exp(torch.clamp_max(log_alpha, 0.0)), dim=1) / N
    swap_prob = torch.where(pair_on,
                            (1.0 - ema) * state.swap_prob + ema * p_pair,
                            state.swap_prob)

    pad = torch.zeros((1, N), dtype=torch.bool, device=dev)
    take_upper = torch.cat([accept, pad], dim=0)
    take_lower = torch.cat([pad, accept], dim=0)

    def exchange(a):
        down = torch.cat([a[1:], a[-1:]], dim=0)
        up = torch.cat([a[:1], a[:-1]], dim=0)
        tail = (1,) * (a.dim() - 2)
        m_up = take_upper.reshape(take_upper.shape + tail)
        m_lo = take_lower.reshape(take_lower.shape + tail)
        return torch.where(m_up, down, torch.where(m_lo, up, a))

    return state._replace(
        x=exchange(state.x), logp=exchange(state.logp),
        swap_accept=state.swap_accept + accept.sum(dim=1).to(torch.int32),
        swap_tries=state.swap_tries + (pair_on * N).to(torch.int32),
        swap_prob=swap_prob)


def _spain_host(dtype, K, N):
    """The Spain-2020 space (20 days, rk4@1, REFLECT) on the host,
    ``objective(k)``: its objective with one value overridden at step ``k``
    (row 1 NaN, row 2 -inf, row 3 +inf, row 4 the floor, in turn), and a
    start of ``K`` rungs of ``N`` chains with wide scales, so that
    proposals leave the bounds, at a step past the gain's cap of 0.1."""
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

    g = torch.Generator().manual_seed(17)
    theta0 = space.extract(pipe.params).to(dtype)
    state = init_pt_state(space, theta0, ll,
                          torch.randn(K * N, space.dim, generator=g,
                                      dtype=dtype),
                          n_rungs=K, n_chains=N, jitter=0.5)
    scales = torch.linspace(-1.0, 2.3, K * N, dtype=dtype).reshape(K, N)
    return space, objective, state._replace(log_scale=scales, step=4321), g


@pytest.mark.parametrize("adapt_scale", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_step_and_its_buffers_equal_the_legacy_step(dtype, adapt_scale):
    """Eight steps, each with a swap sweep (both parities in turn), three
    ways from one start of 4 rungs x 4 chains and one set of draws, the
    ladder moved after the third and the covariances re-estimated after the
    fifth: the step and sweep as they were written, :func:`pt_mh_step` and
    :func:`pt_swap_step` (the parts composed, the gain a Python float, the
    pair mask from the parity), and the step graphs' bodies on their fixed
    buffers (the gain a 0-dim tensor, the mask copied in, the new state
    written into the buffers). Every field is bit-equal after every step
    and every sweep; some raw proposals lay outside the bounds, some values
    were NaN, infinite or floored, and swaps were made."""
    K, N, steps = 4, 4, 8
    cfg = PTConfig(adapt_scale=adapt_scale, n_rungs=K, ladder_t0=5.0)
    space, objective, start, g = _spain_host(dtype, K, N)
    d = space.dim
    draws = [(torch.randn(K, N, d, generator=g, dtype=dtype),
              torch.rand(K, N, generator=g, dtype=dtype),
              torch.rand(K - 1, N, generator=g, dtype=dtype))
             for _ in range(steps)]
    legacy = split = held = start
    bufs = tempering._StepBuffers(start, space, cfg)
    outside = 0
    for i, (z, u, u_swap) in enumerate(draws):
        raw = legacy.x + torch.exp(legacy.log_scale)[..., None] * torch.einsum(
            "knd,ked->kne", z, legacy.chol)
        outside += int((~space.in_bounds(raw)).sum())
        legacy = legacy_pt_mh_step(legacy, z, u, space, objective(i), cfg,
                                   legacy.betas)
        split = tempering.pt_mh_step(split, z, u, space, objective(i), cfg,
                                     split.betas)
        bufs.load(held, z, u)
        proposal = bufs.propose()
        bufs.lp.copy_(objective(i)(proposal.reshape(K * N, d))
                      .reshape(K, N))
        bufs.accept(proposal)
        held = bufs.result(held, 1)
        for f in tempering._BUFFERED:
            assert getattr(held, f) is getattr(bufs.state, f), f
        assert_same_state(split, legacy)
        assert_same_state(held, legacy)

        parity = i % 2
        legacy = legacy_pt_swap_step(legacy, u_swap, legacy.betas, parity)
        split = tempering.pt_swap_step(split, u_swap, split.betas, parity)
        bufs.load_swap(held, u_swap, parity)
        bufs.swap()
        held = bufs.result(held, 0)
        assert_same_state(split, legacy)
        assert_same_state(held, legacy)
        if i == 2:
            legacy, split, held = (pt_adapt_ladder(st, cfg)
                                   for st in (legacy, split, held))
            assert held.betas is not bufs.state.betas
        if i == 4:
            legacy, split, held = (pt_adapt_covariance(st, cfg)
                                   for st in (legacy, split, held))
            assert held.chol is not bufs.state.chol
    assert outside > 0
    assert bool(torch.isfinite(legacy.logp).all())
    assert 0 < int(legacy.accept_count.sum()) < K * N * steps
    assert int(legacy.swap_accept.sum()) > 0
    assert not torch.equal(legacy.betas, start.betas)


class RecordedGraph:
    """A stand-in for a CUDA graph: the operations its capture ran, each
    with the tensors it read and wrote; a replay runs them again on those
    same tensors, as a graph replays its kernels on fixed addresses."""

    def __init__(self):
        self.ops = []
        self.replays = 0

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                if isinstance(o, torch.Tensor) and \
                        o.untyped_storage().data_ptr() != \
                        n.untyped_storage().data_ptr():
                    o.copy_(n)


class _Record(TorchDispatchMode):
    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a read of a value to the host cannot be captured
        assert func is not torch.ops.aten._local_scalar_dense.default, func
        out = func(*args, **kwargs)
        self.graph.ops.append((func, args, kwargs, out))
        return out


@pytest.fixture
def recorded_graphs(monkeypatch):
    """CUDA's graph calls stood in for by :class:`RecordedGraph`, and the
    step graphs keyed on host tensors as on the card's; yields the graphs
    captured."""
    made = []

    def new_graph():
        made.append(RecordedGraph())
        return made[-1]

    @contextlib.contextmanager
    def graph(g, pool=None):
        with _Record(g):
            yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tempering._StepGraphs, "_key", staticmethod(
        lambda x: (x.device, x.dtype) + tuple(x.shape[:2])))
    yield made


@pytest.mark.parametrize("swap_every", [1, 2])
def test_graphed_campaign_equals_eager_on_recorded_graphs(
        spain30, tmp_path, monkeypatch, recorded_graphs, swap_every):
    """The host campaign (4 x 4, two segments of 8 steps) through the step
    graphs, each graph a recording of the operations its callable ran:
    two eager steps, one capture of three graphs (propose, accept, swap),
    replays after, across the segment boundary; forced eager, the same
    bits in every field of the result and the state; killed after segment
    0 and resumed (its graphs captured anew), the same bits again; segment
    0's result, kept while segment 1 ran on the same graphs, unchanged.
    The swap graph replays on sweeps alone."""
    steps = 16
    raw = []
    graphed = _campaign(spain30, tmp_path / "full.npz", raw=raw,
                        swap_every=swap_every)
    assert trace.counts("pt.graph") == {
        ("eager", 16): mh.EAGER_STEPS, ("capture", 16): 1,
        ("replay", 16): steps - mh.EAGER_STEPS - 1}
    propose, accept, swap = recorded_graphs
    assert propose.replays == accept.replays == steps - mh.EAGER_STEPS
    sweeps = steps // swap_every
    assert swap.replays == sweeps - mh.EAGER_STEPS // swap_every
    assert trace.counts("pt.sweeps") == {(0, 4, 4): sweeps // 2,
                                         (1, 4, 4): sweeps // 2}

    trace.reset()
    with monkeypatch.context() as m:
        m.setattr(mh, "EAGER_STEPS", 10 ** 9)
        eager = _campaign(spain30, tmp_path / "eager.npz",
                          swap_every=swap_every)
    assert trace.counts("pt.graph") == {("eager", 16): steps}
    for f in RESULT_FIELDS:
        assert_bit_equal(getattr(graphed, f), getattr(eager, f), f)
    assert_same_state(graphed.final_state, eager.final_state)
    assert int(graphed.final_state.swap_accept.sum()) > 0

    path = tmp_path / "killed.npz"
    assert _campaign(spain30, path, kill_after=1,
                     swap_every=swap_every) is None
    resumed = _campaign(spain30, path, resume=True, swap_every=swap_every)
    assert_bit_equal(resumed.samples, graphed.samples[2:])
    assert_bit_equal(resumed.sample_logps, graphed.sample_logps[2:])
    assert_same_state(resumed.final_state, graphed.final_state)

    (r0, (state0, result0)), _ = raw
    for f, want in state0.items():
        assert_bit_equal(getattr(r0.final_state, f), want, f)
    for f, want in result0.items():
        assert_bit_equal(getattr(r0, f), want, f)
    assert not torch.equal(r0.final_state.x, graphed.final_state.x)


def test_host_steps_stay_eager(spain30):
    """On host tensors every step is eager, counted so, and no graph is
    captured; a sweep follows its step's path."""
    space, theta0, cov0, ll = spain30
    cfg = PTConfig(iterations=6, burn_in=2, thinning=2, adaptation_period=2,
                   n_rungs=3)
    res = run_pt(ll, space, theta0, cfg, n_chains=4, jitter=0.1,
                 draws=SeededRunDraws(5, 0, 12, space.dim, F64, "cpu"))
    assert trace.counts("pt.graph") == {("eager", 12): 6}
    assert trace.counts("pt.sweeps") == {(0, 3, 4): 3, (1, 3, 4): 3}
    assert res.samples.shape == (3, 4, space.dim)
    assert bool(torch.isfinite(res.sample_logps).all())


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode; the host test "
                    "above holds the plain version")
    return torch.device("cuda")


@pytest.mark.cuda
def test_runner_on_k1_follows_the_reference_on_the_card(cuda, monkeypatch):
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
    # the decisions are read off the eager step and sweep: no step replays
    monkeypatch.setattr(mh, "EAGER_STEPS", 10 ** 9)

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


SEGMENT = 1000


class _Stop(Exception):
    pass


def _card_campaign(cuda, swap_every, *, path=None, resume=False,
                   stop_at=None, on_segment=None):
    """A campaign of 2 segments of 1000 PT steps at the benchmark cell's
    shape (8 rungs x 1024 chains, cash_karp@3 on K1, float32, thinning
    500, burn-in 500); with ``stop_at`` it stops before that segment (after
    the checkpoint of the one before). Returns the result (None where
    stopped) and the objective's calls."""
    K, N = 8, 1024
    pipe = load_spain_pipeline(REPO, dtype=torch.float32, device=cuda)
    ll = build_objective_fused(pipe.space, pipe.params, pipe.data, pipe.ts,
                               substeps=3, tableau="cash_karp",
                               constraint_mode=REFLECT, dtype=torch.float32,
                               device=cuda)
    calls = [0]

    def objective(x):
        calls[0] += 1
        return ll(x)

    def draws_for_segment(s):
        if s == stop_at:
            raise _Stop
        return SeededRunDraws(3000000001, s, K * N, pipe.space.dim,
                              torch.float32, cuda)

    cfg = PTConfig(iterations=2 * SEGMENT, burn_in=500, adaptation_period=100,
                   thinning=500, n_rungs=K, beta_min=0.05,
                   swap_every=swap_every)
    theta0 = pipe.space.extract(pipe.params).to(torch.float32)
    try:
        res = run_pt_checkpointed(objective, pipe.space, theta0, cfg,
                                  n_chains=N, segments=2, checkpoint_path=path,
                                  resume=resume, on_segment=on_segment,
                                  draws_for_segment=draws_for_segment)
    except _Stop:
        res = None
    torch.cuda.synchronize(cuda)
    return res, calls[0]


@pytest.mark.cuda
@pytest.mark.parametrize("swap_every", [1, 2])
def test_graphed_campaign_equals_eager_on_the_card(cuda, monkeypatch, tmp_path,
                                                   swap_every):
    """Two segments of 1000 steps at 8 x 1024 cash_karp@3 float32 from one
    seed: with the step graphs (eager twice, one capture, replays after)
    and forced eager, the cold rung's samples and values, the MAP, the
    acceptance and swap rates and every field of the final state are
    bit-equal; the campaign resumed at segment 1 from the graphed run's
    checkpoint equals the uninterrupted run's segment 1; the objective is
    called once a step and once at the start; segment 0's result, kept
    while segment 1 ran on the same graphs, is as it was handed over."""
    steps = 2 * SEGMENT
    raw = []
    graphed, n = _card_campaign(
        cuda, swap_every, path=str(tmp_path / "full.npz"),
        on_segment=lambda s, r: raw.append((r, _copies(r))))
    assert n == steps + 1
    assert trace.counts("pt.graph") == {
        ("eager", 8192): mh.EAGER_STEPS, ("capture", 8192): 1,
        ("replay", 8192): steps - mh.EAGER_STEPS - 1}
    assert graphed.final_state.step == steps

    trace.reset()
    with monkeypatch.context() as m:
        m.setattr(mh, "EAGER_STEPS", 10 ** 9)
        eager, n = _card_campaign(cuda, swap_every)
    assert n == steps + 1
    assert trace.counts("pt.graph") == {("eager", 8192): steps}
    for f in RESULT_FIELDS:
        assert_bit_equal(getattr(graphed, f), getattr(eager, f), f)
    assert_same_state(graphed.final_state, eager.final_state)
    fs = graphed.final_state
    assert int(fs.accept_count.min()) > 0 and int(fs.swap_accept.min()) > 0

    path = str(tmp_path / "killed.npz")
    stopped, _ = _card_campaign(cuda, swap_every, path=path, stop_at=1)
    assert stopped is None
    resumed, n = _card_campaign(cuda, swap_every, path=path, resume=True)
    assert n == SEGMENT
    per = graphed.samples.shape[0] // 2
    assert_bit_equal(resumed.samples, graphed.samples[per:])
    assert_bit_equal(resumed.sample_logps, graphed.sample_logps[per:])
    assert_same_state(resumed.final_state, graphed.final_state)

    (r0, (state0, result0)), _ = raw
    for f, want in state0.items():
        assert_bit_equal(getattr(r0.final_state, f), want, f)
    for f, want in result0.items():
        assert_bit_equal(getattr(r0, f), want, f)
    assert not torch.equal(r0.final_state.x, graphed.final_state.x)
