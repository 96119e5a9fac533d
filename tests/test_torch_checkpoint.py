"""Checkpoint/resume and trace CSVs of the port: every test of
``tests/test_checkpoint.py`` pointed at the port (killed-and-resumed runs
equal to the uninterrupted run bit for bit, thinning that does not divide
the segment, NUTS resume), and the files crossing between the packages: an
npz written by either loads in the other with equal fields, an old PT npz
gets the JAX package's synthesized ladder, and the trace CSV has the JAX
writer's bytes."""

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import mh as jmh
from mmidv1_tpu.calibration import tempering as jpt
from mmidv1_tpu.calibration.nuts import NUTSState as JNUTSState
from mmidv1_tpu.utils import checkpoint as jck

from mmidv1_tpu_torch.calibration import tempering as tpt
from mmidv1_tpu_torch.calibration.draws import SeededRunDraws
from mmidv1_tpu_torch.calibration.mh import (MHConfig, run_mh,
                                             run_mh_checkpointed)
from mmidv1_tpu_torch.calibration.nuts import NUTSConfig, run_nuts
from mmidv1_tpu_torch.calibration.param_space import ParameterSpace
from mmidv1_tpu_torch.utils import checkpoint as tck

F64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    """``tests/test_checkpoint.py``'s target: a unit Gaussian at (0.5, -0.5)
    in the box [-5, 5]^2, sigmas 0.3."""
    mu = torch.tensor([0.5, -0.5], dtype=F64)

    def loglik(X):
        return -0.5 * torch.sum((X - mu) ** 2, dim=-1)

    space = ParameterSpace(names=("beta", "theta"),
                           lower=torch.full((2,), -5.0, dtype=F64),
                           upper=torch.full((2,), 5.0, dtype=F64),
                           sigmas=torch.full((2,), 0.3, dtype=F64),
                           _scatter={})
    return loglik, space


def _seg(seed, s, n=8):
    return SeededRunDraws(seed, s, n, 2, F64, "cpu")


def _equal_states(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, int):
            assert x == y, f
        else:
            assert torch.equal(x, y), f


def test_killed_and_resumed_run_reproduces_uninterrupted(tmp_path, problem):
    """Split run (checkpoint to DISK at the midpoint, reload, continue)
    equals the uninterrupted run exactly."""
    loglik, space = problem
    theta0 = torch.zeros(2, dtype=F64)
    cfg_half = MHConfig(iterations=40, burn_in=10, adaptation_period=20,
                        thinning=4)

    r_half1 = run_mh(loglik, space, theta0, cfg_half, n_chains=8,
                     draws=_seg(42, 0))
    ckpt = tmp_path / "mh_state.npz"
    tck.save_mh_state(str(ckpt), r_half1.final_state)
    resumed_state = tck.load_mh_state(str(ckpt))
    _equal_states(resumed_state, r_half1.final_state)    # exact round trip

    r_half2 = run_mh(loglik, space, theta0, cfg_half, n_chains=8,
                     initial_state=resumed_state, draws=_seg(42, 1))
    r_ref1 = run_mh(loglik, space, theta0, cfg_half, n_chains=8,
                    draws=_seg(42, 0))
    r_ref2 = run_mh(loglik, space, theta0, cfg_half, n_chains=8,
                    initial_state=r_ref1.final_state, draws=_seg(42, 1))
    assert torch.equal(r_half2.samples, r_ref2.samples)
    assert r_half2.final_state.step == 80
    assert torch.isfinite(r_half2.samples).all()


def test_posterior_trace_csv(tmp_path, problem):
    loglik, space = problem
    cfg = MHConfig(iterations=24, burn_in=4, thinning=4)
    res = run_mh(loglik, space, torch.zeros(2, dtype=F64), cfg, n_chains=4,
                 generator=torch.Generator().manual_seed(0))
    path = tmp_path / "posterior_trace.csv"
    tck.write_posterior_trace(str(path), res.samples, res.sample_logps,
                              list(space.names))
    rows = path.read_text().strip().splitlines()
    assert rows[0] == "sample,logp,beta,theta"
    assert len(rows) == 1 + 6 * 4     # 6 stored blocks x 4 chains

    # checkpoint-style truncation (last N rows, reference :380-382)
    tck.write_posterior_trace(str(path), res.samples, res.sample_logps,
                              list(space.names), max_rows=5)
    assert len(path.read_text().strip().splitlines()) == 6


def test_progress_callback_fires(problem):
    loglik, space = problem
    seen = []

    def progress(step, acc, best, scale):
        seen.append((int(step), float(acc)))

    cfg = MHConfig(iterations=20, burn_in=0, thinning=5, report_interval=2)
    run_mh(loglik, space, torch.zeros(2, dtype=F64), cfg, n_chains=4,
           generator=torch.Generator().manual_seed(1), progress_fn=progress)
    assert len(seen) == 2            # 4 blocks, every 2nd reports
    assert seen[-1][0] == 20
    assert 0.0 <= seen[-1][1] <= 1.0


def test_checkpoint_progress_fn_logs(problem, capsys):
    loglik, space = problem
    fn = tck.make_checkpoint_progress_fn("unused", list(space.names), every=2)
    cfg = MHConfig(iterations=20, burn_in=0, thinning=5, report_interval=1)
    run_mh(loglik, space, torch.zeros(2, dtype=F64), cfg, n_chains=4,
           generator=torch.Generator().manual_seed(1), progress_fn=fn)
    out = capsys.readouterr()
    lines = [ln for ln in (out.out + out.err).splitlines()
             if "acceptance" in ln]
    assert len(lines) == 2 and "step 20:" in lines[-1]


def test_checkpointed_campaign_resume_matches_uninterrupted(tmp_path, problem):
    """A campaign killed between segments and resumed from its disk
    checkpoint produces exactly the uninterrupted campaign's remaining
    segments."""
    loglik, space = problem
    cfg = MHConfig(iterations=60, burn_in=10, adaptation_period=20, thinning=4)
    theta0 = torch.zeros(2, dtype=F64)

    full = run_mh_checkpointed(loglik, space, theta0, cfg, seed=77,
                               n_chains=8, segments=3,
                               checkpoint_path=str(tmp_path / "full.npz"))
    assert full.final_state.step == 60
    assert full.samples.shape[0] == 15     # 3 segments x 5 stored blocks

    part = run_mh_checkpointed(loglik, space, theta0,
                               MHConfig(iterations=20, burn_in=10,
                                        adaptation_period=20, thinning=4),
                               seed=77, n_chains=8, segments=1,
                               checkpoint_path=str(tmp_path / "ckpt.npz"))
    assert part.final_state.step == 20
    resumed = run_mh_checkpointed(loglik, space, theta0, cfg, seed=77,
                                  n_chains=8, segments=3,
                                  checkpoint_path=str(tmp_path / "ckpt.npz"))
    assert resumed.samples.shape[0] == 10     # segments 1..2 only
    assert torch.equal(resumed.samples, full.samples[5:])
    assert torch.equal(resumed.final_state.x, full.final_state.x)

    # fully-covered checkpoint refuses to run zero segments
    with pytest.raises(ValueError, match="already covers"):
        run_mh_checkpointed(loglik, space, theta0,
                            MHConfig(iterations=20, burn_in=5, thinning=4),
                            seed=77, n_chains=8, segments=1,
                            checkpoint_path=str(tmp_path / "full.npz"))


def test_nuts_checkpoint_resume_is_exact(tmp_path, problem):
    """A NUTS run interrupted mid-campaign and resumed from the on-disk
    NUTSState reproduces the uninterrupted run bit for bit."""
    loglik, space = problem
    theta0 = torch.zeros(2, dtype=F64)
    cfg = NUTSConfig(iterations=12, adaptation_window=4, max_tree_depth=3)
    full = run_nuts(loglik, space, theta0, cfg, seed=7, n_chains=4, segments=4)

    saved = {}

    def grab(state, xs, lps):
        if state.it == 6:
            saved["state"] = state

    part1 = run_nuts(loglik, space, theta0, cfg, seed=7, n_chains=4,
                     segments=4, on_segment=grab)
    ckpt = tmp_path / "nuts_state.npz"
    tck.save_nuts_state(str(ckpt), saved["state"])
    resumed = tck.load_nuts_state(str(ckpt))
    _equal_states(resumed, saved["state"])

    part2 = run_nuts(loglik, space, theta0, cfg, seed=7, n_chains=4,
                     segments=4, initial_state=resumed)
    assert part2.samples.shape[0] == cfg.iterations - 6
    assert torch.equal(torch.cat([full.samples[:6], part2.samples]),
                       full.samples)
    assert torch.equal(part1.samples, full.samples)


def test_checkpointed_resume_when_thinning_not_dividing_segment(tmp_path,
                                                                problem):
    """Each segment runs ceil(per_segment/thinning)*thinning steps; the
    resume index divides by the steps ACTUALLY run (per_segment=10,
    thinning=4: 12 steps a segment, step 60 after 5 segments)."""
    loglik, space = problem
    theta0 = torch.zeros(2, dtype=F64)
    cfg = MHConfig(iterations=60, burn_in=4, adaptation_period=20, thinning=4)

    full = run_mh_checkpointed(loglik, space, theta0, cfg, seed=5, n_chains=8,
                               segments=6,
                               checkpoint_path=str(tmp_path / "full.npz"))
    assert full.final_state.step == 72      # 6 x ceil(10/4)*4

    part = run_mh_checkpointed(loglik, space, theta0,
                               MHConfig(iterations=50, burn_in=4,
                                        adaptation_period=20, thinning=4),
                               seed=5, n_chains=8, segments=5,
                               checkpoint_path=str(tmp_path / "ckpt.npz"))
    assert part.final_state.step == 60
    resumed = run_mh_checkpointed(loglik, space, theta0, cfg, seed=5,
                                  n_chains=8, segments=6,
                                  checkpoint_path=str(tmp_path / "ckpt.npz"))
    assert resumed.samples.shape[0] == 3      # exactly segment 5
    assert torch.equal(resumed.samples, full.samples[15:])
    assert torch.equal(resumed.final_state.x, full.final_state.x)


def _port_state(kind, problem):
    """A small port state of each saver's type: MH and NUTS from short
    runs, PT from ``init_pt_state``."""
    loglik, space = problem
    theta0 = torch.zeros(2, dtype=F64)
    if kind == "mh":
        return run_mh(loglik, space, theta0,
                      MHConfig(iterations=8, burn_in=2, thinning=4),
                      n_chains=4, draws=_seg(3, 0)).final_state
    if kind == "pt":
        z = torch.randn((3 * 4, 2), dtype=F64,
                        generator=torch.Generator().manual_seed(4))
        return tpt.init_pt_state(space, theta0, loglik, z, n_rungs=3,
                                 n_chains=4)
    saved = {}
    run_nuts(loglik, space, theta0,
             NUTSConfig(iterations=4, adaptation_window=2, max_tree_depth=2),
             seed=3, n_chains=4, segments=2,
             on_segment=lambda st, xs, lps: saved.setdefault("s", st))
    return saved["s"]


@pytest.mark.parametrize("kind", ["mh", "pt", "nuts"])
def test_checkpoint_members_are_stored(tmp_path, problem, kind):
    """Every saver writes a stored (not deflated) npz, one member a field,
    atomically: no tmp file is left beside it, and it loads back equal."""
    save = getattr(tck, f"save_{kind}_state")
    load = getattr(tck, f"load_{kind}_state")
    state = _port_state(kind, problem)
    path = str(tmp_path / f"{kind}.npz")
    save(path, state)
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    assert sorted(i.filename for i in infos) == sorted(
        f + ".npy" for f in state._fields)
    assert all(i.compress_type == zipfile.ZIP_STORED for i in infos)
    assert os.listdir(tmp_path) == [f"{kind}.npz"]
    _equal_states(load(path), state)


def test_deflated_checkpoint_resumes_campaign(tmp_path, problem):
    """A deflated MH checkpoint (``np.savez_compressed``, as the JAX package
    and the port's earlier files are written) of a campaign killed after
    one segment resumes it to the bit: the remaining segments' samples and
    the final state equal the uninterrupted campaign's."""
    loglik, space = problem
    cfg = MHConfig(iterations=60, burn_in=10, adaptation_period=20, thinning=4)
    theta0 = torch.zeros(2, dtype=F64)
    full = run_mh_checkpointed(loglik, space, theta0, cfg, seed=77,
                               n_chains=8, segments=3,
                               checkpoint_path=str(tmp_path / "full.npz"))

    part = run_mh_checkpointed(loglik, space, theta0,
                               MHConfig(iterations=20, burn_in=10,
                                        adaptation_period=20, thinning=4),
                               seed=77, n_chains=8, segments=1)
    ckpt = str(tmp_path / "deflated.npz")
    np.savez_compressed(ckpt, **{k: tck._to_numpy(v) for k, v in
                                 part.final_state._asdict().items()})
    with zipfile.ZipFile(ckpt) as zf:
        assert all(i.compress_type == zipfile.ZIP_DEFLATED
                   for i in zf.infolist())
    resumed = run_mh_checkpointed(loglik, space, theta0, cfg, seed=77,
                                  n_chains=8, segments=3,
                                  checkpoint_path=ckpt)
    assert torch.equal(resumed.samples, full.samples[5:])
    assert torch.equal(resumed.sample_logps, full.sample_logps[5:])
    _equal_states(resumed.final_state, full.final_state)


# ------------------------------------------- files across the packages


def _assert_fields_equal(t_state, j_state):
    assert t_state._fields == j_state._fields
    for f in t_state._fields:
        a, b = getattr(t_state, f), np.asarray(getattr(j_state, f))
        if isinstance(a, int):
            assert a == int(b) and b.dtype == np.int32, f
        else:
            assert a.numpy().dtype == b.dtype, f
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


def _jax_mh_state():
    space = jmh.ParameterSpace(names=("a", "b", "c"),
                               lower=jnp.full((3,), -4.0),
                               upper=jnp.full((3,), 4.0),
                               sigmas=jnp.full((3,), 0.5), _scatter={})
    ll = jax.vmap(lambda x: -0.5 * jnp.sum(x * x))
    st = jmh.init_mh_state(space, jnp.zeros(3, jnp.float32), ll,
                           jax.random.PRNGKey(1), 6, jitter=1.0)
    st = jmh.mh_step(st, jax.random.PRNGKey(2), space, ll, jmh.MHConfig())
    return jmh.mh_step(st, jax.random.PRNGKey(3), space, ll, jmh.MHConfig())


def test_mh_npz_crosses_packages(tmp_path):
    """A float32 MHState written by the JAX package loads in the port with
    equal fields and dtypes (step an int), and back."""
    js = _jax_mh_state()
    jck.save_mh_state(str(tmp_path / "j.npz"), js)
    ts_ = tck.load_mh_state(str(tmp_path / "j.npz"), device="cpu")
    assert isinstance(ts_.step, int) and ts_.step == 2
    assert ts_.accept_count.dtype == torch.int32
    _assert_fields_equal(ts_, js)
    tck.save_mh_state(str(tmp_path / "t.npz"), ts_)
    with np.load(str(tmp_path / "t.npz")) as z:
        assert z["step"].dtype == np.int32 and z["x"].dtype == np.float32
    _assert_fields_equal(ts_, jck.load_mh_state(str(tmp_path / "t.npz")))


def _jax_pt_state():
    space = jpt.ParameterSpace(names=("a", "b"), lower=jnp.full((2,), -4.0),
                               upper=jnp.full((2,), 4.0),
                               sigmas=jnp.full((2,), 0.5), _scatter={})
    ll = jax.vmap(lambda x: -0.5 * jnp.sum(x * x))
    st = jpt.init_pt_state(space, jnp.zeros(2), ll, jax.random.PRNGKey(4),
                           n_rungs=4, n_chains=3)
    st = jpt.pt_mh_step(st, jax.random.PRNGKey(5), space, ll,
                        jpt.PTConfig(n_rungs=4), st.betas)
    return jpt.pt_swap_step(st, jax.random.PRNGKey(6), st.betas,
                            jnp.asarray(1))


def test_pt_npz_crosses_packages(tmp_path):
    js = _jax_pt_state()
    jck.save_pt_state(str(tmp_path / "j.npz"), js)
    ts_ = tck.load_pt_state(str(tmp_path / "j.npz"), device="cpu")
    assert ts_.step == 1 and ts_.swap_tries.dtype == torch.int32
    _assert_fields_equal(ts_, js)
    tck.save_pt_state(str(tmp_path / "t.npz"), ts_)
    _assert_fields_equal(ts_, jck.load_pt_state(str(tmp_path / "t.npz")))


def test_old_pt_npz_gets_the_synthesized_ladder(tmp_path):
    """A checkpoint from before ladder adaptation (no betas / ladder_s /
    swap_prob) loads with the JAX package's synthesized geometric ladder."""
    js = _jax_pt_state()
    old = {k: np.asarray(v) for k, v in js._asdict().items()
           if k not in ("betas", "ladder_s", "swap_prob")}
    path = str(tmp_path / "old.npz")
    np.savez_compressed(path, **old)
    ts_ = tck.load_pt_state(path)
    _assert_fields_equal(ts_, jck.load_pt_state(path))
    assert float(ts_.betas[0]) == 1.0
    np.testing.assert_allclose(float(ts_.betas[-1]), 0.05, rtol=1e-12)
    assert not ts_.swap_prob.any()


def test_nuts_npz_crosses_packages(tmp_path, problem):
    """A NUTSState of the port loads in the JAX package (``it`` int32) and
    a JAX-written one loads back with equal fields."""
    loglik, space = problem
    saved = {}
    run_nuts(loglik, space, torch.zeros(2, dtype=F64),
             NUTSConfig(iterations=4, adaptation_window=2, max_tree_depth=2),
             seed=3, n_chains=4, segments=2,
             on_segment=lambda st, xs, lps: saved.setdefault("s", st))
    ts_ = saved["s"]
    tck.save_nuts_state(str(tmp_path / "t.npz"), ts_)
    js = jck.load_nuts_state(str(tmp_path / "t.npz"))
    assert isinstance(js, JNUTSState)
    _assert_fields_equal(ts_, js)
    jck.save_nuts_state(str(tmp_path / "j.npz"), js)
    _equal_states(tck.load_nuts_state(str(tmp_path / "j.npz")), ts_)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_posterior_trace_bytes_match_jax(tmp_path, dtype):
    """The port's trace CSV has the JAX writer's bytes on the same arrays,
    whole and truncated to the last rows."""
    rng = np.random.default_rng(0)
    samples = (rng.normal(size=(5, 7, 3)) * 10.0 ** rng.integers(
        -6, 6, size=(5, 7, 3))).astype(dtype)
    logps = (-1e6 * rng.uniform(size=(5, 7))).astype(dtype)
    names = ["beta", "theta", "sigma"]
    for kw in ({}, {"max_rows": 11}):
        a, b = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
        jck.write_posterior_trace(a, samples, logps, names, **kw)
        tck.write_posterior_trace(b, torch.as_tensor(samples),
                                  torch.as_tensor(logps), names, **kw)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    jck.write_posterior_trace(a, samples[0])
    tck.write_posterior_trace(b, samples[0])
    assert open(a, "rb").read() == open(b, "rb").read()
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
