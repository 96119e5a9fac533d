"""K1's value call replayed as a CUDA graph (``build_objective_fused`` on
``utils.graphs.GraphCache``) and the prep behind it, on the Spain-2020
space.

This file imports nothing of JAX, so the card (which has no JAX) can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_value_graph.py

Host tests: ``FusedPrep``'s prep (its plain version on the host) gives the
kernel inputs, and the gradient through them, bit for bit as
``ParameterSpace.apply``'s scatter did; host calls stay eager and keep every
prep span. Card tests (marked ``cuda``): at the samplers' chain counts
and the benchmark's two solvers, a replayed call equals the eager call on
the same thetas bit for bit, with rows reflected into the bounds, floored
(an initial state past N) and NaN; a kept result is never overwritten by a
later call; each replay counts one K1 launch and one ``replay``; past
``VALUE_GRAPHS`` shapes the least recently used one is dropped and
recaptured when it comes back.
"""

import os

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch.calibration.objective import lowest, make_time_grid
from mmidv1_tpu_torch.calibration.param_space import REFLECT, space_from_numpy
from mmidv1_tpu_torch.cli.common import load_spain_pipeline
from mmidv1_tpu_torch.models import sepaihrd
from mmidv1_tpu_torch.ops import build_objective_fused
from mmidv1_tpu_torch.ops import sepaihrd_adjoint as adj
from mmidv1_tpu_torch.ops import sepaihrd_fused as sf
from mmidv1_tpu_torch.utils import trace

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNUP_NAMES = ("seed_exposed", "runup_days")
KINDS = 4            # rows: jittered, out of bounds, past N, NaN


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


def spain(runup, dtype, device, num_days=None):
    """``(space, params, data, ts)`` of the Spain-2020 pipeline. Without
    run-up the run-up names leave the space, the base parameters' run-up is
    0 and the multipliers set the initial state. The upper bound of
    ``seed_exposed`` (run-up) or ``E0_multiplier`` (none) is raised to 1e9,
    so that a row can push the initial state past N."""
    pipe = load_spain_pipeline(REPO, dtype=torch.float64, device="cpu",
                               num_days=num_days)
    names = list(pipe.space.names)
    lo, hi, sg = (t.numpy().copy() for t in (
        pipe.space.lower, pipe.space.upper, pipe.space.sigmas))
    params = pipe.params
    if not runup:
        keep = [i for i, n in enumerate(names) if n not in RUNUP_NAMES]
        names = [names[i] for i in keep]
        lo, hi, sg = lo[keep], hi[keep], sg[keep]
        params = params.replace(runup_days=torch.zeros_like(params.runup_days))
    hi[names.index("seed_exposed" if runup else "E0_multiplier")] = 1e9
    params = params.to(device, dtype)
    space = space_from_numpy(names, lo, hi, sg, params, dtype=dtype,
                             device=device)
    ts = make_time_grid(float(params.runup_days), pipe.data.n_data_points)
    return space, params, pipe.data, ts


def batches(space, params, B, seed=5, kinds=KINDS):
    """``kinds`` theta batches of ``B`` rows: rows about the base parameters
    (0.3 sigmas of jitter) but, in turn, one row pushed past every upper
    bound (reflected back in), one with ``seed_exposed`` or
    ``E0_multiplier`` at 1e8 (an initial state past N: floored) and one NaN
    (floored). Batch k is the mixed batch rolled by k rows, so each kind
    lands in the first row once (all there is at B = 1)."""
    theta0 = space.extract(params)
    n = max(B, KINDS)
    rng = np.random.default_rng(seed)
    x = theta0 + 0.3 * space.sigmas * torch.as_tensor(
        rng.standard_normal((n, space.dim)), dtype=theta0.dtype,
        device=theta0.device)
    big = space.names.index(
        "seed_exposed" if "seed_exposed" in space.names else "E0_multiplier")
    x[1] = space.upper + 0.37 * (space.upper - space.lower)
    x[1, big] = theta0[big]
    x[2, big] = 1e8
    x[3] = float("nan")
    return [x.roll(-k, 0)[:B].contiguous() for k in range(kinds)]


def bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def assert_bit_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(bits(a), bits(b))


def legacy_pack(prep, prm, y0, B):
    """K1's per-chain inputs ``(y0, agevec, scal, beff)`` from applied
    parameters, as ``FusedPrep._pack`` stacked them before the gather
    table."""
    y0 = y0.expand(B, 11, 4).permute(1, 2, 0).contiguous()
    vecs = [prm.a, prm.h_infec * prep.invN, prm.p, prm.h, prm.icu, prm.d_H,
            prm.d_ICU, prm.d_community]
    agevec = torch.stack([v.expand(B, 4) for v in vecs]) \
        .permute(0, 2, 1).contiguous()
    scal = torch.stack([s.expand(B) for s in (
        prm.theta, prm.sigma, prm.gamma_p, prm.gamma_A, prm.gamma_I,
        prm.gamma_H, prm.gamma_ICU)]).contiguous()
    if prm.beta_values.shape[-1]:
        bsrc = prm.beta_values
    else:
        bsrc = prm.beta.unsqueeze(-1)
    bsrc = bsrc * prm.contact_matrix_scaling_factor.unsqueeze(-1)
    if prm.kappa_values.shape[-1]:
        ksrc = prm.kappa_values
    else:
        ksrc = torch.ones(1, dtype=prep.dtype, device=prep.device)
    beff = torch.stack([(bsrc[..., i] * ksrc[..., k]).expand(B)
                        for i, k in zip(prep.pb, prep.pk)]).contiguous()
    return y0, agevec, scal, beff


def legacy_kernel_args(prep, thetas):
    """``FusedPrep.kernel_args`` as it was with ``ParameterSpace.apply``'s
    list positions: constrain, apply, the initial state, the stacks of
    :func:`legacy_pack`."""
    theta = prep.space.constrain(thetas.to(prep.dtype), prep.mode)
    B = theta.shape[0]
    prm = prep.space.apply(prep.base, theta)
    y0, infeasible = sepaihrd.initial_state_for_params(prm, prep.base_y0)
    return (legacy_pack(prep, prm, y0, B) + (prep.obs, prep.valid, prep.M),
            dict(run_start=prep.run_start, run_count=prep.run_count,
                 runup_offset=prep.runup_offset), infeasible.expand(B))


def fused_prep(space, params, data, ts):
    return sf.FusedPrep(space, params, data, ts, constraint_mode=REFLECT,
                        dtype=space.dtype, device=space.device)


# --- host (tier-1) ----------------------------------------------------------

@pytest.mark.parametrize("runup", [True, False])
def test_prep_positions_on_the_device_equal_the_list_scatter(runup):
    """``FusedPrep.kernel_args`` (its gather table held on the device)
    gives every kernel input and the infeasible mask bit for bit as the list
    scatter; the rows past N are infeasible and no other."""
    space, params, data, ts = spain(runup, torch.float64, "cpu")
    prep = fused_prep(space, params, data, ts)
    assert prep.table.device == prep.gather.device == space.device
    for B in (1, 9):
        for x in batches(space, params, B):
            args, kw, inf = prep.kernel_args(x)
            old, old_kw, old_inf = legacy_kernel_args(prep, x)
            assert kw == old_kw
            for a, b in zip(args[:6], old[:6]):
                assert_bit_equal(a, b)
            assert torch.equal(inf, old_inf)
    x = batches(space, params, 9)[0]
    assert prep.kernel_args(x)[2].tolist() == [i == 2 for i in range(9)]


@pytest.mark.parametrize("runup", [True, False])
def test_prep_gradient_equals_the_list_scatter(runup):
    """The gradient through the prep with device positions equals the list
    scatter's bit for bit (a fixed random weighting of every kernel input)."""
    space, params, data, ts = spain(runup, torch.float64, "cpu")
    prep = fused_prep(space, params, data, ts)
    x = batches(space, params, 6)[1]
    x = x[~torch.isnan(x).any(dim=1)]
    grads = []
    for kernel_args in (prep.kernel_args,
                        lambda t: legacy_kernel_args(prep, t)):
        th = x.clone().requires_grad_(True)
        args = kernel_args(th)[0][:4]
        gen = torch.Generator().manual_seed(3)
        loss = sum(torch.sum(a * torch.randn(a.shape, generator=gen,
                                             dtype=a.dtype)) for a in args)
        grads.append(torch.autograd.grad(loss, th)[0])
    assert grads[0].abs().sum() > 0
    assert_bit_equal(*grads)


@pytest.mark.parametrize("runup", [True, False])
def test_value_and_grad_equals_the_list_scatter(runup, monkeypatch):
    """``build_objective_fused_grad`` (the prep under autograd, then K2 and
    K3's plain versions) gives the values and gradients of the list scatter
    bit for bit, the floored row included."""
    space, params, data, ts = spain(runup, torch.float64, "cpu", num_days=12)
    vg = adj.build_objective_fused_grad(space, params, data, ts, substeps=1,
                                        tableau="rk4", constraint_mode=REFLECT)
    x = batches(space, params, 3)[0]
    ll, g = vg(x)
    monkeypatch.setattr(vg.prep, "kernel_args",
                        lambda t: legacy_kernel_args(vg.prep, t))
    ll_old, g_old = vg(x)
    assert ll[2] == lowest(torch.float64) and torch.isfinite(ll[:2]).all()
    assert_bit_equal(ll, ll_old)
    assert_bit_equal(g, g_old)


def test_host_calls_stay_eager_with_every_prep_span():
    """On the host every call is eager (the counter ``objective.graph``
    counts ``eager`` alone), keeps the prep's spans and has no
    ``objective.replay``; the floored rows read ``finfo.min``."""
    space, params, data, ts = spain(True, torch.float64, "cpu", num_days=12)
    ll = build_objective_fused(space, params, data, ts, substeps=1,
                               tableau="rk4", constraint_mode=REFLECT)
    trace.enable()
    xs = batches(space, params, 4)
    out = [ll(x) for x in xs] + [ll(xs[0][:2])]
    assert_bit_equal(out[0], ll(xs[0]))
    assert trace.counts("objective.graph") == {("eager", 4): 5, ("eager", 2): 1}
    spans = trace.snapshot()["spans"]
    for name in ("objective", "objective.prep", "prep.constrain", "prep.apply",
                 "prep.initial_state", "prep.pack", "k1.launch",
                 "objective.mask"):
        assert spans[name]["count"] == 6, name
    assert "objective.replay" not in spans
    assert out[0][2] == out[0][3] == lowest(torch.float64)
    assert torch.isfinite(out[0][:2]).all() and (out[0][:2] > -1e30).all()


# --- card -------------------------------------------------------------------

def _counted(fn):
    """``(fn(), new K1 launches, new objective.graph counts)``."""
    before = [trace.counts(n) for n in ("launches", "objective.graph")]
    out = fn()
    after = [trace.counts(n) for n in ("launches", "objective.graph")]
    new = [{k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
           for a, b in zip(after, before)]
    return out, {k[1:]: v for k, v in new[0].items() if k[0] == "k1"}, new[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype", [(1, torch.float32), (257, torch.float64),
                                     (1024, torch.float32),
                                     (8192, torch.float32)])
@pytest.mark.parametrize("tableau,substeps", [("dopri5", 4), ("cash_karp", 3)])
def test_replay_equals_the_eager_call(cuda, B, dtype, tableau, substeps):
    """At B = 1, 257 (float64), 1024 (K1 split) and 8192 (wide), with and
    without run-up: every replayed call equals the eager first call of a
    fresh objective on the same thetas bit for bit, the capturing call too;
    results kept across calls stay as they were; an eager call, the capture
    and each replay count one K1 launch, under the regime K1's rule picks."""
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    regime = sf.choose_forward_regime(B, sm)
    for runup in (True, False):
        space, params, data, ts = spain(runup, dtype, cuda)

        def build():
            return build_objective_fused(space, params, data, ts,
                                         substeps=substeps, tableau=tableau,
                                         constraint_mode=REFLECT, dtype=dtype,
                                         device=cuda)

        xs = batches(space, params, B)
        eager = [build()(x) for x in xs]
        ll = build()
        one = {(regime, tableau, B): 1}
        for k, kind in ((0, "eager"), (1, "capture")):
            got, launched, graph = _counted(lambda: ll(xs[k]))
            assert_bit_equal(got, eager[k])
            assert launched == one and graph == {(kind, B): 1}, kind
        kept = []
        for k, x in enumerate(xs + xs):
            got, launched, graph = _counted(lambda: ll(x))
            assert_bit_equal(got, eager[k % KINDS])
            assert launched == one and graph == {("replay", B): 1}
            kept.append(got)
        for k, got in enumerate(kept):
            assert_bit_equal(got, eager[k % KINDS])
        floor = lowest(dtype)
        for k, e in enumerate(eager):            # row i is mixed row i + k
            for i in range(min(B, KINDS)):
                row = (i + k) % max(B, KINDS)
                assert (e[i] == floor) == (row in (2, 3)), (runup, k, i)


@pytest.mark.cuda
def test_value_and_grad_on_the_card_equals_the_list_scatter(cuda, monkeypatch):
    """On the card, at the NUTS recipe's shape (64 chains, float32,
    dopri5@4), ``build_objective_fused_grad`` (the prep under autograd, K2
    and K3; never a graph) gives the values and gradients of the list
    scatter bit for bit; its value objective replays its eager value."""
    space, params, data, ts = spain(True, torch.float32, cuda)
    vg = adj.build_objective_fused_grad(space, params, data, ts, substeps=4,
                                        tableau="dopri5",
                                        constraint_mode=REFLECT)
    x = batches(space, params, 64)[0]
    x[3] = x[0]                                  # no NaN gradient row
    ll, g = vg(x)
    values = [vg.value_batch(x) for _ in range(3)]
    assert trace.counts("objective.graph") == {
        ("eager", 64): 1, ("capture", 64): 1, ("replay", 64): 1}
    for v in values[1:]:
        assert_bit_equal(v, values[0])
    assert values[0][2] == ll[2] == lowest(torch.float32)
    monkeypatch.setattr(vg.prep, "kernel_args",
                        lambda t: legacy_kernel_args(vg.prep, t))
    ll_old, g_old = vg(x)
    assert_bit_equal(ll, ll_old)
    assert_bit_equal(g, g_old)


@pytest.mark.cuda
def test_value_cache_evicts_the_oldest_and_recaptures_it(cuda):
    """At ``VALUE_GRAPHS + 1`` shapes (B = 1 ... 9, float32, dopri5@4) each
    shape's second call captures, and the ninth capture drops the least
    recently used shape's graph (B = 1); B = 1 recaptures when it comes
    back, with no eager call, and drops B = 2 in turn, which recaptures too,
    while B = 9 still replays. Every call, eager, captured, replayed or
    recaptured, equals the eager call of a fresh objective bit for bit."""
    space, params, data, ts = spain(True, torch.float32, cuda)

    def build():
        return build_objective_fused(space, params, data, ts, substeps=4,
                                     tableau="dopri5", constraint_mode=REFLECT,
                                     dtype=torch.float32, device=cuda)

    sizes = range(1, sf.VALUE_GRAPHS + 2)
    xs = {B: batches(space, params, B)[0] for B in sizes}
    fresh = build()
    eager = {B: fresh(x) for B, x in xs.items()}
    assert trace.counts("objective.graph") == {("eager", B): 1 for B in sizes}
    ll = build()
    for B in sizes:
        for kind in ("eager", "capture"):
            got, _launched, graph = _counted(lambda: ll(xs[B]))
            assert graph == {(kind, B): 1}
            assert_bit_equal(got, eager[B])
    for B, kind in ((1, "capture"), (2, "capture"), (9, "replay"),
                    (1, "replay")):
        got, launched, graph = _counted(lambda: ll(xs[B]))
        assert graph == {(kind, B): 1}, B
        assert launched == {(sf.SPLIT, "dopri5", B): 1}
        assert_bit_equal(got, eager[B])
