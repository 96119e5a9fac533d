"""The PyTorch port's serovalid mode against the JAX package, in float64 on
the CPU.

- ``relax_bounds`` only copies bounds and divides some by 10: equal exactly;
- the ENE-COVID penalty and its gradient (``torch.autograd`` through the
  eager solve against ``jax.value_and_grad`` through XLA) at the committed
  serovalid MAP, on the Spain grid cut at day 70: the same float64 solve on
  both sides, so rtol 1e-9;
- the penalty added onto the K2/K3 engine's plain value-and-grad, against
  JAX's value-and-grad of the sum: rtol 1e-9;
- ``sero_of`` on the full grid gives the committed ``sero_day64`` to rtol
  5e-3, the bar of ``tests/test_serovalid.py:152``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import serovalid as jsv
from mmidv1_tpu.calibration.objective import build_objective, make_time_grid
from mmidv1_tpu.calibration.param_space import CLAMP
from mmidv1_tpu.cli.common import load_spain_pipeline
from mmidv1_tpu.data import read_sepaihrd_parameters

from mmidv1_tpu_torch.calibration import serovalid as tsv
from mmidv1_tpu_torch.cli.common import \
    load_spain_pipeline as load_torch_pipeline
from mmidv1_tpu_torch.data import \
    read_sepaihrd_parameters as t_read_parameters
from mmidv1_tpu_torch.ops import build_objective_fused_grad

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import to_torch_params, to_torch_space  # noqa: E402

torch.set_num_threads(1)
T = lambda a: torch.as_tensor(np.array(a))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SV = os.path.join(REPO, "results", "spain2020_serovalid")


@pytest.fixture(scope="module")
def problem():
    """Both packages' Spain-2020 problems (observations cut at day 70, grid
    t = -20 ... 70), their relaxed spaces, and the committed serovalid MAP
    plus two draws near it."""
    n_days = 71
    pipe = load_spain_pipeline(REPO, dtype=jnp.float64, num_days=n_days)
    tpipe = load_torch_pipeline(REPO, num_days=n_days, dtype=torch.float64,
                                device="cpu")
    tparams = to_torch_params(pipe.params)
    tspace = to_torch_space(pipe.space, tparams)
    jrel, jidx = jsv.relax_bounds(pipe.space)
    trel, tidx = tsv.relax_bounds(tspace)
    calib = read_sepaihrd_parameters(
        os.path.join(SV, "calibrated_parameters.txt"), 4,
        N=pipe.data.population_by_age, M_baseline=np.asarray(
            pipe.params.M_baseline))
    theta = np.asarray(pipe.space.extract(calib), np.float64)
    rng = np.random.default_rng(8)
    sig = np.asarray(pipe.space.sigmas)
    thetas = np.stack([theta, theta + 0.02 * sig * rng.normal(size=sig.size),
                       theta + 0.02 * sig * rng.normal(size=sig.size)])
    return dict(pipe=pipe, tpipe=tpipe, tparams=tparams, tspace=tspace,
                jrel=jrel, jidx=jidx, trel=trel, tidx=tidx, thetas=thetas)


def test_relax_bounds_matches_jax_exactly(problem):
    p = problem
    assert p["tidx"] == p["jidx"] and len(p["tidx"]) == 18
    np.testing.assert_array_equal(p["trel"].lower.numpy(),
                                  np.asarray(p["jrel"].lower, np.float64))
    np.testing.assert_array_equal(p["trel"].upper.numpy(),
                                  np.asarray(p["jrel"].upper, np.float64))
    np.testing.assert_array_equal(p["trel"].sigmas.numpy(),
                                  p["tspace"].sigmas.numpy())
    assert p["trel"].names == p["tspace"].names
    # the space it was made from is unchanged
    assert not torch.equal(p["trel"].lower, p["tspace"].lower)


@pytest.mark.parametrize("mode", ["reflect", "clamp"])
def test_sero_penalty_and_grad_match_jax(problem, mode):
    p = problem
    pipe = p["pipe"]
    kw = dict(substeps=4, tableau="dopri5", constraint_mode=mode)
    jpen = jsv.make_sero_penalty(p["jrel"], pipe.params, pipe.data, pipe.ts,
                                 dtype=jnp.float64, **kw)
    tpen = tsv.make_sero_penalty(p["trel"], p["tparams"], p["tpipe"].data,
                                 pipe.ts, **kw)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jpen)))(
        jnp.asarray(p["thetas"]))
    tv, tg = tpen.value_and_grad(T(p["thetas"]))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tpen(T(p["thetas"])).numpy(), tv.numpy(),
                               rtol=0)
    np.testing.assert_allclose(
        tpen.sero_of(T(p["thetas"][0])).item(),
        float(jpen.sero_of(jnp.asarray(p["thetas"][0]))), rtol=1e-9)
    assert np.isfinite(tg.numpy()).all() and np.abs(tg.numpy()).max() > 0


def test_penalty_adds_onto_kernel_value_and_grad(problem):
    """Poisson LL + sero term through the K2/K3 engine (its plain versions
    here) and autograd, against ``jax.value_and_grad`` of JAX's sum."""
    p = problem
    pipe = p["pipe"]
    jll = build_objective(p["jrel"], pipe.params, pipe.data, pipe.ts,
                          substeps=4, constraint_mode=CLAMP)
    jpen = jsv.make_sero_penalty(p["jrel"], pipe.params, pipe.data, pipe.ts,
                                 constraint_mode=CLAMP, dtype=jnp.float64)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda th: jll(th) + jpen(th))))(jnp.asarray(p["thetas"]))
    vg = build_objective_fused_grad(p["trel"], p["tparams"], p["tpipe"].data,
                                    pipe.ts, substeps=4, constraint_mode=CLAMP,
                                    device="cpu")
    tpen = tsv.make_sero_penalty(p["trel"], p["tparams"], p["tpipe"].data,
                                 pipe.ts, constraint_mode=CLAMP)
    lv, lg = vg(T(p["thetas"]))
    pv, pg = tpen.value_and_grad(T(p["thetas"]))
    np.testing.assert_allclose((lv + pv).numpy(), np.asarray(jv), rtol=1e-9)
    g = np.asarray(jg)
    np.testing.assert_allclose((lg + pg).numpy(), g, rtol=1e-9,
                               atol=1e-9 * np.abs(g).max())


def test_sero_of_the_committed_map():
    """On the full grid the committed serovalid MAP reads the recorded
    day-64 seroprevalence (``serovalid_metadata.json``) to rtol 5e-3."""
    with open(os.path.join(SV, "serovalid_metadata.json")) as f:
        meta = json.load(f)
    tpipe = load_torch_pipeline(REPO, dtype=torch.float64, device="cpu")
    rel, _ = tsv.relax_bounds(tpipe.space)
    tcalib = t_read_parameters(
        os.path.join(SV, "calibrated_parameters.txt"), 4,
        N=tpipe.data.population_by_age,
        M_baseline=tpipe.params.M_baseline.numpy(), dtype=torch.float64,
        device="cpu")
    ts = make_time_grid(float(tpipe.params.runup_days), tpipe.data.n_data_points)
    pen = tsv.make_sero_penalty(rel, tpipe.params, tpipe.data, ts)
    theta = rel.extract(tcalib)
    sero = float(pen.sero_of(theta))
    np.testing.assert_allclose(sero, meta["sero_day64"], rtol=5e-3)
    v, g = pen.value_and_grad(theta[None])
    assert abs(float(v)) < 2.0 and torch.isfinite(g).all()
