"""The fused objective's prep and mask (``ops.sepaihrd_fused``): the plain
version that reads the gather table, the prep kernel and the mask kernel.

This file imports nothing of JAX, so the card (which has no JAX) can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prep_kernel.py

Host tests: the plain version (``FusedPrep._prep_plain``) gives K1's inputs
and the infeasible flags bit for bit as the ops-based prep did before the
table (``legacy_kernel_args``), and the same gradients, over float32 and
float64, REFLECT and CLAMP, both initial-state branches (and both in one
batch), rows past the bounds by up to three widths, a degenerate bound,
infeasible and NaN rows, the Spain-2020 space and a small space whose beta
is one scalar that every schedule run shares. Card tests (marked
``cuda``): the prep kernel equals the plain version on the card bit for
bit at the samplers' chain counts, the mask kernel is right on NaN, Inf
and infeasible rows, and a replayed objective call equals the eager one
and counts one launch of each kernel.
"""

import functools

import numpy as np
import pytest
import torch

from mmidv1_tpu_torch.calibration.objective import lowest, make_time_grid
from mmidv1_tpu_torch.calibration.param_space import (CLAMP, REFLECT,
                                                      space_from_numpy)
from mmidv1_tpu_torch.ops import build_objective_fused
from mmidv1_tpu_torch.ops import sepaihrd_fused as sf
from mmidv1_tpu_torch.utils import trace

from test_torch_value_graph import (REPO, assert_bit_equal,
                                    legacy_kernel_args)

torch.set_num_threads(1)
SMALL_NAMES = ("beta", "theta", "gamma_I", "p_1", "h_infec_0",
               "d_community_3", "kappa_3", "I0_multiplier", "R0_multiplier",
               "seed_exposed", "runup_days")
SPACES = ("spain-runup", "spain-multipliers", "small")
MODES = (REFLECT, CLAMP)
F32, F64 = torch.float32, torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the prep and mask kernels have no "
                    "CPU mode (run this file on the card)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def clean():
    trace.disable()
    trace.reset()
    yield
    trace.reset()


@functools.lru_cache(maxsize=None)
def _pipeline(num_days):
    from mmidv1_tpu_torch.cli.common import load_spain_pipeline
    return load_spain_pipeline(REPO, dtype=F64, device="cpu",
                               num_days=num_days)


def problem(kind, dtype, device, space_dtype=None, num_days=None):
    """``(space, params, data, ts)``. ``spain-runup``: the Spain-2020 space,
    run-up's lower bound at -5 days (a chain with none takes the multiplier
    branch), ``seed_exposed`` up to 1e9 (an initial state past N),
    ``D0_multiplier``'s bounds equal (degenerate). ``spain-multipliers``:
    without the run-up names or run-up, ``E0_multiplier`` up to 1e9.
    ``small``: eleven names over parameters with no beta schedule, so one
    scalar beta drives every schedule run, run-up from -5 days and
    ``seed_exposed`` up to 1e9."""
    pipe = _pipeline(num_days)
    params = pipe.params
    if kind == "small":
        params = params.replace(beta_values=params.beta_values[:0],
                                beta_end_times=params.beta_end_times[:0])
        names = list(SMALL_NAMES)
        lo = np.array([0.05, 0.1, 0.05, 0.1, 0.1, 0.0, 0.2, 0.5, 0.0, 1.0,
                       -5.0])
        hi = np.array([0.9, 0.9, 0.5, 0.9, 1.5, 0.2, 1.2, 3.0, 2.0, 1e9,
                       25.0])
        sg = 0.1 * (hi - lo)
        sg[-2] = 10.0
    else:
        names = list(pipe.space.names)
        lo, hi, sg = (t.numpy().copy() for t in (
            pipe.space.lower, pipe.space.upper, pipe.space.sigmas))
        if kind == "spain-multipliers":
            keep = [i for i, n in enumerate(names)
                    if n not in ("seed_exposed", "runup_days")]
            names = [names[i] for i in keep]
            lo, hi, sg = lo[keep], hi[keep], sg[keep]
            params = params.replace(
                runup_days=torch.zeros_like(params.runup_days))
            hi[names.index("E0_multiplier")] = 1e9
        else:
            lo[names.index("runup_days")] = -5.0
            hi[names.index("seed_exposed")] = 1e9
            k = names.index("D0_multiplier")
            lo[k] = hi[k] = 1.0
    params = params.to(device, dtype)
    space = space_from_numpy(names, lo, hi, sg, params,
                             dtype=space_dtype or dtype, device=device)
    ts = make_time_grid(float(params.runup_days), pipe.data.n_data_points)
    return space, params, pipe.data, ts


def fused_prep(kind, dtype, device, mode, space_dtype=None):
    space, params, data, ts = problem(kind, dtype, device, space_dtype)
    return sf.FusedPrep(space, params, data, ts, constraint_mode=mode,
                        dtype=dtype, device=device)


def thetas(prep, B, seed=11):
    """``B`` rows (at least 12, cut to ``B``): the base point jittered by
    0.7 sigmas, then in turn rows past the upper bounds by 0.37 and 3.2
    widths, past the lower bounds by 2.6, exactly on the lower bounds, an
    initial state past N (``seed_exposed`` or ``E0_multiplier`` at 1e8),
    no run-up (the multiplier branch, where run-up is a name) and NaN."""
    space = prep.space
    theta0 = space.extract(prep.base).to(space.dtype)
    width = space.upper - space.lower
    n = max(B, 12)
    rng = np.random.default_rng(seed)
    x = theta0 + 0.7 * space.sigmas * torch.as_tensor(
        rng.standard_normal((n, space.dim)), dtype=space.dtype,
        device=space.device)
    names = space.names
    big = names.index("seed_exposed" if "seed_exposed" in names
                      else "E0_multiplier")
    x[1] = space.upper + 0.37 * width
    x[2] = space.upper + 3.2 * width
    x[3] = space.lower - 2.6 * width
    x[4] = space.lower
    for row in (1, 2, 3, 4):
        x[row, big] = theta0[big]
    x[5, big] = 1e8
    if "runup_days" in names:
        x[6, names.index("runup_days")] = -2.0
    x[7] = float("nan")
    x = x.to(prep.dtype)
    return x[torch.randperm(n, generator=torch.Generator().manual_seed(seed))
             [:B].sort().values].contiguous() if B < n else x


def outputs(prep, x, plain=True):
    """K1's four inputs and the infeasible flags from the plain version or
    the prep kernel."""
    args, infeasible = (prep._prep_plain if plain else prep._prep_kernel)(x)
    return args + (infeasible,)


# --- host (tier-1) ----------------------------------------------------------

@pytest.mark.parametrize("kind", SPACES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [F32, F64])
def test_plain_prep_equals_the_ops_prep(kind, mode, dtype):
    """The plain version gives y0, agevec, scal, beff and the infeasible
    flags bit for bit as the ops-based prep, on every kind of row; rows past
    N are infeasible and every other row is not; both branches of the
    initial state are taken where run-up is a name."""
    prep = fused_prep(kind, dtype, "cpu", mode)
    x = thetas(prep, 12)
    new = outputs(prep, x)
    (*old, _obs, _valid, _M), _kw, old_inf = legacy_kernel_args(prep, x)
    for a, b in zip(new[:4], old):
        assert a.is_contiguous()
        assert_bit_equal(a, b)
    assert torch.equal(new[4], old_inf)
    assert new[4].tolist() == [i == 5 for i in range(12)]
    # CumH holds the data's day-0 value in the multiplier branch, 0 when
    # seeded: row 0 is seeded where run-up is a name, row 6 never is
    cum_h = prep.base_y0[9]
    assert cum_h.abs().sum() > 0
    assert torch.equal(new[0][9, :, 6], cum_h)
    seeded = "runup_days" in prep.space.names
    assert torch.equal(new[0][9, :, 0] == 0, torch.full((4,), seeded))


@pytest.mark.parametrize("kind", SPACES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [F32, F64])
def test_plain_prep_gradient_equals_the_ops_prep(kind, mode, dtype):
    """The gradient through the plain version (a fixed random weighting of
    K1's four inputs) equals the ops-based prep's bit for bit, the shared
    scalar beta of the small space included."""
    prep = fused_prep(kind, dtype, "cpu", mode)
    x = thetas(prep, 12)
    x = x[~torch.isnan(x).any(dim=1)]
    grads = []
    for args_of in (lambda t: outputs(prep, t)[:4],
                    lambda t: legacy_kernel_args(prep, t)[0][:4]):
        th = x.clone().requires_grad_(True)
        gen = torch.Generator().manual_seed(3)
        loss = sum(torch.sum(a * torch.randn(a.shape, generator=gen,
                                             dtype=a.dtype))
                   for a in args_of(th))
        grads.append(torch.autograd.grad(loss, th)[0])
    assert grads[0].abs().sum() > 0
    assert_bit_equal(*grads)


@pytest.mark.parametrize("dtype,space_dtype", [(F64, F32), (F32, F64)])
def test_plain_prep_with_the_space_in_another_dtype(dtype, space_dtype):
    """A space in another dtype than the objective (the float64 MAP
    re-selection runs a float32 space): the constraint runs in the
    promotion of the two, the table holds the space's constants, and the
    plain version equals the ops-based prep bit for bit."""
    for mode in MODES:
        prep = fused_prep("spain-runup", dtype, "cpu", mode, space_dtype)
        x = thetas(prep, 12)
        new = outputs(prep, x)
        (*old, _o, _v, _M), _kw, old_inf = legacy_kernel_args(prep, x)
        for a, b in zip(new[:4], old):
            assert_bit_equal(a, b)
        assert torch.equal(new[4], old_inf)


def test_table_layout():
    """The table's slots: each theta column feeds one slot (the small
    space's ``beta`` the shared beta source, every run reading it), the
    rest read their base values; its sections lie end to end in
    ``PREP_SECTIONS``' order at ``offsets``, which ``head`` passes to the
    kernel, and the slots the kernel reads by position hold their fields."""
    prep = fused_prep("small", F64, "cpu", REFLECT)
    space = prep.space
    fed = sorted(c for c in prep.src if c >= 0)
    assert fed == list(range(space.dim))
    assert prep.src[prep.beta_slots[0]] == space.names.index("beta")
    assert set(prep.run_beta) == {prep.beta_slots[0]}
    assert len(prep.run_beta) == len(prep.run_kappa) == len(prep.run_start) > 2
    S, R, d = len(prep.src), len(prep.run_beta), space.dim
    sizes = dict(src=S, base=S, run_beta=R, run_kappa=R, invN=4, N=4, frac=4,
                 y0=44, lo=d, hi=d, w=d, w2=d, deg=d)
    assert tuple(sizes) == sf.PREP_SECTIONS
    at = 0
    for name in sf.PREP_SECTIONS:
        assert prep.offsets[name] == at, name
        at += sizes[name]
    assert prep.table.shape == (at,) and prep.table.dtype == F64
    assert list(prep.head) == [prep.offsets[n] for n in sf.PREP_SECTIONS]
    section = lambda name: prep.table[prep.offsets[name]:
                                      prep.offsets[name] + sizes[name]]
    w, deg = space.reflect_widths()
    assert torch.equal(section("lo"), space.lower)
    assert torch.equal(section("w2"), 2.0 * w)
    assert not deg.any()
    assert torch.equal(section("src"), torch.tensor(prep.src, dtype=F64))
    k = sf.prep_layout_constants()
    base = section("base")
    names = space.names
    for slot, field in ((k["kRunup"], "runup_days"),
                        (k["kSeed"], "seed_exposed"),
                        (k["kMult"] + 3, "I0_multiplier"),
                        (k["kScal0"], "theta"),
                        (k["kScaling"], None)):
        if field in names:
            assert prep.src[slot] == names.index(field), field
        else:
            assert prep.src[slot] == -1
            assert base[slot] == (1.0 if field is None else
                                  float(getattr(prep.base, field)))
    h = k["kHInfec"] * 4
    assert prep.src[h] == names.index("h_infec_0")
    assert k["kFixedSlots"] == prep.beta_slots[0]


def test_generated_layout_header():
    """The header the build generates for the prep kernel holds every
    constant of ``prep_layout_constants`` and each section's index in the
    kernel's head, in ``PREP_SECTIONS``' order."""
    from mmidv1_tpu_torch.ops import _build
    text = _build.prep_layout_header()
    k = sf.prep_layout_constants()
    for name, value in k.items():
        assert f"constexpr int {name} = {value};" in text
    assert [k[n] for n in ("kSrc", "kBase", "kRunBeta", "kY0", "kDeg")] == [
        sf.PREP_SECTIONS.index(s)
        for s in ("src", "base", "run_beta", "y0", "deg")]
    assert k["kSections"] == len(sf.PREP_SECTIONS)


def _plain_as_kernel(monkeypatch):
    """The prep and mask kernels' launches stood in for by their plain
    versions (outside autograd, as a kernel computes), so that the
    autograd wrappers run on the host."""
    def prep_kernel(self, thetas):
        with torch.no_grad():
            return self._prep_plain(thetas.detach())
    monkeypatch.setattr(sf.FusedPrep, "_prep_kernel", prep_kernel)
    monkeypatch.setattr(sf, "_mask_kernel",
                        lambda ll, inf: sf._mask_where(ll.detach(), inf))


@pytest.mark.parametrize("kind", SPACES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [F32, F64])
def test_autograd_wrapper_gradient_equals_the_plain_prep(monkeypatch, kind,
                                                         mode, dtype):
    """Under autograd the card's prep is the kernel's forward and the plain
    version's backward (``_PrepFn``): its outputs carry the plain version's
    gradient bit for bit, through any subset of the four inputs, and the
    infeasible flags none."""
    _plain_as_kernel(monkeypatch)
    prep = fused_prep(kind, dtype, "cpu", mode)
    x = thetas(prep, 12)
    x = x[~torch.isnan(x).any(dim=1)]
    for used in ((0, 1, 2, 3), (1, 3), (0,)):
        grads = []
        for run in (lambda t: sf._PrepFn.apply(t, prep),
                    lambda t: outputs(prep, t)):
            th = x.clone().requires_grad_(True)
            out = run(th)
            assert not out[4].requires_grad
            gen = torch.Generator().manual_seed(3)
            loss = sum(torch.sum(out[i] * torch.randn(
                out[i].shape, generator=gen, dtype=dtype)) for i in used)
            grads.append(torch.autograd.grad(loss, th)[0])
        assert grads[0].abs().sum() > 0
        assert_bit_equal(*grads)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_autograd_mask_gradient_equals_where(monkeypatch, dtype):
    """The mask's wrapper under autograd (``_MaskFn``) gives
    ``torch.where``'s values and gradient bit for bit: the upstream
    gradient on kept rows, zero on infeasible, NaN and Inf rows."""
    _plain_as_kernel(monkeypatch)
    rng = np.random.default_rng(2)
    base = torch.as_tensor(-1e3 * rng.random(40), dtype=dtype)
    base[3], base[4], base[5] = float("nan"), float("inf"), -float("inf")
    infeasible = torch.as_tensor(rng.random(40) < 0.2)
    g = torch.as_tensor(rng.standard_normal(40), dtype=dtype)
    res = []
    for fn in (sf._MaskFn.apply, sf._mask_where):
        ll = base.clone().requires_grad_(True)
        out = fn(ll * 1.0, infeasible)
        res.append((out.detach(), torch.autograd.grad(out, ll, g)[0]))
    for a, b in zip(*res):
        assert_bit_equal(a, b)
    assert (res[0][1][3:6] == 0).all() and (res[0][1][infeasible] == 0).all()


def test_host_objective_counts_no_kernel_launch():
    """On the host the objective takes the plain version and the mask's
    ``torch.where``: no ``prep`` or ``mask`` launch is counted."""
    space, params, data, ts = problem("small", F64, "cpu", num_days=12)
    ll = build_objective_fused(space, params, data, ts, substeps=1,
                               tableau="rk4", constraint_mode=REFLECT)
    prep = ll.prep
    out = ll(thetas(prep, 12))
    assert out[5] == out[7] == lowest(F64)
    assert {k[0] for k in trace.counts("launches")} == set()


# --- card -------------------------------------------------------------------

CARD_SHAPES = [(1, F32, None), (40, F32, None), (257, F64, F32),
               (1024, F32, None), (2048, F32, None), (8192, F32, None)]


@pytest.mark.cuda
def test_prep_kernel_refuses_a_float32_objective_over_a_float64_space(cuda):
    """No caller runs a float32 objective over a float64 space, and the
    kernel is not built for one: the call raises rather than computing the
    constraint in another precision."""
    prep = fused_prep("small", F32, cuda, REFLECT, space_dtype=F64)
    with pytest.raises(ValueError, match="float32 objective over a "):
        prep._prep_kernel(thetas(prep, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SPACES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,dtype,space_dtype", CARD_SHAPES)
def test_prep_kernel_equals_the_plain_version(cuda, kind, mode, B, dtype,
                                              space_dtype):
    """At B = 1, 40, 257 (float64 over a float32 space, as the MAP
    re-selection runs), 1024, 2048 and 8192: the prep kernel's five outputs
    equal the plain version's on the card bit for bit, and each call counts
    one ``prep`` launch."""
    prep = fused_prep(kind, dtype, cuda, mode, space_dtype)
    x = thetas(prep, B, seed=B)
    want = outputs(prep, x)
    got = outputs(prep, x, plain=False)
    torch.cuda.synchronize()
    for name, a, b in zip(("y0", "agevec", "scal", "beff", "infeasible"),
                          got, want):
        assert a.is_contiguous() and a.shape == b.shape, name
        if a.dtype == torch.bool:
            assert torch.equal(a, b), name
        else:
            assert_bit_equal(a, b)
    assert trace.counts("launches") == {("prep", mode, B): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_mask_kernel(cuda, dtype):
    """The mask kernel gives ``finfo.min`` on infeasible, NaN, +Inf and
    -Inf rows and every other value bit for bit, as ``torch.where`` does."""
    B = 1000
    rng = np.random.default_rng(1)
    ll = torch.as_tensor(-1e5 * rng.random(B), dtype=dtype, device=cuda)
    ll[3], ll[4], ll[5] = float("nan"), float("inf"), -float("inf")
    ll[6] = lowest(dtype)
    infeasible = torch.as_tensor(rng.random(B) < 0.1, device=cuda)
    infeasible[3:7] = False
    got = sf.mask_values(ll, infeasible)
    bad = infeasible | torch.isnan(ll) | torch.isinf(ll)
    want = torch.where(bad, torch.full_like(ll, lowest(dtype)), ll)
    assert_bit_equal(got, want)
    assert (got[3:7] == lowest(dtype)).all() and bad.sum() > 4
    assert trace.counts("launches") == {("mask", B): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SPACES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,dtype", [(64, F32), (257, F64), (1024, F32)])
def test_prep_kernel_gradient_equals_the_plain_version(cuda, kind, mode, B,
                                                       dtype):
    """Under autograd on the card the prep is the kernel (one ``prep``
    launch) and its gradient, a fixed random weighting of K1's four inputs
    pulled back to the thetas, equals the plain version's on the card bit
    for bit."""
    prep = fused_prep(kind, dtype, cuda, mode)
    x = thetas(prep, B, seed=B)
    x = x[~torch.isnan(x).any(dim=1)]
    grads = []
    for run in (lambda t: prep.kernel_args(t)[0][:4],
                lambda t: outputs(prep, t)[:4]):
        th = x.clone().requires_grad_(True)
        gen = torch.Generator(device=cuda).manual_seed(3)
        loss = sum(torch.sum(a * torch.randn(a.shape, generator=gen,
                                             dtype=dtype, device=cuda))
                   for a in run(th))
        grads.append(torch.autograd.grad(loss, th)[0])
    assert grads[0].abs().sum() > 0
    assert_bit_equal(*grads)
    assert trace.counts("launches", ("prep",)) == {(mode, x.shape[0]): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype,mode", [(64, F32, CLAMP), (64, F64, CLAMP),
                                          (1024, F32, REFLECT)])
def test_value_and_grad_equals_the_plain_prep(cuda, B, dtype, mode):
    """``build_objective_fused_grad`` on the card (the prep kernel, K2, K3,
    the mask kernel) gives the values and gradients of the same call with
    the plain prep and ``torch.where`` bit for bit, NaN and infeasible rows
    included; each call counts one launch of ``prep`` and of ``mask``."""
    from mmidv1_tpu_torch.ops import FusedObjectiveFn, build_objective_fused_grad
    space, params, data, ts = problem("spain-runup", dtype, cuda)
    vg = build_objective_fused_grad(space, params, data, ts, substeps=3,
                                    tableau="cash_karp", constraint_mode=mode,
                                    dtype=dtype, device=cuda)
    prep = vg.prep
    x = thetas(prep, B, seed=B + 7)
    spec = dict(run_start=prep.run_start, run_count=prep.run_count,
                runup_offset=prep.runup_offset, substeps=3,
                tableau="cash_karp")
    th = x.clone().requires_grad_(True)
    args, infeasible = prep._prep_plain(th)
    ll = FusedObjectiveFn.apply(*args, prep.obs, prep.valid, prep.M, spec)
    ll = sf._mask_where(ll, infeasible)
    (grad,) = torch.autograd.grad(ll.sum(), th)
    trace.reset()
    got_ll, got_grad = vg(x)
    assert_bit_equal(got_ll, ll.detach())
    assert_bit_equal(got_grad, grad)
    assert (got_ll == lowest(dtype)).sum() >= 2
    assert trace.counts("launches", ("prep",)) == {(mode, B): 1}
    assert trace.counts("launches", ("mask",)) == {(B,): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 1024, 8192])
def test_replay_equals_the_eager_call_and_the_plain_prep(cuda, B):
    """The objective through its three kernels: the eager call, the
    capturing call and every replay equal the same call with the plain
    prep and the ``torch.where`` mask in place of the kernels bit for bit;
    each call counts one launch of ``prep``, ``k1`` and ``mask``."""
    space, params, data, ts = problem("spain-runup", F32, cuda)
    kw = dict(substeps=3, tableau="cash_karp", constraint_mode=REFLECT,
              dtype=F32, device=cuda)
    ll = build_objective_fused(space, params, data, ts, **kw)
    xs = [thetas(ll.prep, B, seed=B + k) for k in range(4)]
    ref = build_objective_fused(space, params, data, ts, **kw)
    prep = ref.prep

    def plain_value(x):
        args, kwargs, infeasible = prep.kernel_args(x.requires_grad_(True))
        out = sf.fused_objective(*args, **kwargs, substeps=3,
                                 tableau="cash_karp")
        bad = infeasible | torch.isnan(out) | torch.isinf(out)
        return torch.where(bad, torch.full_like(out, lowest(F32)), out)

    want = [plain_value(x.clone()).detach() for x in xs]
    trace.reset()
    for k, x in enumerate(xs + xs):
        assert_bit_equal(ll(x), want[k % 4])
    by_kernel = {}
    for key, n in trace.counts("launches").items():
        by_kernel[key[0]] = by_kernel.get(key[0], 0) + n
    assert by_kernel == {"prep": 8, "k1": 8, "mask": 8}
    assert trace.counts("objective.graph") == {
        ("eager", B): 1, ("capture", B): 1, ("replay", B): 6}
