"""The port's seroprevalence probes (``cli/_sero_probe.py`` and
``cli/sero_{profile_probe,ridge_scan,sensitivity,force_profile}.py``)
against the JAX package's scripts, on the host:

- the shared core, on each of the three boxes (the reference bounds, "B"
  and "C"), on a 71-day grid that holds the sero day 64, float64, rk4@1: the
  Poisson LL (K1's plain version), the day-64 seroprevalence and the joint
  value and gradient (K2 / K3's plain versions plus autograd of the sero
  term) equal ``build_objective`` + ``sepaihrd.solve`` +
  ``jax.value_and_grad`` of the scripts' ``joint`` at rtol 1e-9 (the
  gradient floored at 1e-9 of its largest entry);
- the ridge projection's clipped names equal ``results/sero_ridge.json``
  (the script's output) at every k; the nudge off the walls and the
  relaxed coordinates' whitening floors equal the scripts' lines;
- (slow) each probe's ``main`` against its JAX script at ``--maxiter 1
  --rounds 1`` on the full grid, dopri5@4: every number of the two JSON
  files at rtol 1e-9 (a difference of two log-likelihoods at 1e-9 of its
  row's LL), every name list equal, ``grad_runup_days`` exactly 0.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmidv1_tpu.analysis.metrics import SERO_TARGET_DAY
from mmidv1_tpu.calibration.objective import build_objective
from mmidv1_tpu.calibration.param_space import REFLECT
from mmidv1_tpu.cli.common import load_spain_pipeline
from mmidv1_tpu.models import sepaihrd as jsep

from mmidv1_tpu_torch.calibration.serovalid import SEVERITY_PREFIXES
from mmidv1_tpu_torch.cli import (_sero_probe as sp, sero_force_profile,
                                  sero_profile_probe, sero_ridge_scan,
                                  sero_sensitivity)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
DAYS, SUBSTEPS, TABLEAU = 71, 1, "rk4"
TARGET, SE = 0.048, 0.0028


@pytest.fixture(scope="module")
def pipes():
    pl = sp.Pipeline(device="cpu", substeps=SUBSTEPS, tableau=TABLEAU,
                     num_days=DAYS)
    jp = load_spain_pipeline(REPO, dtype=jnp.float64, num_days=DAYS)
    return pl, jp


def jax_box(jp, variant):
    """The scripts' box: ``dataclasses.replace`` of the reference space
    (``sero_sensitivity.py:98-105``, ``sero_force_profile.py:112-119``)."""
    space0 = jp.space
    names = list(space0.names)
    lo = np.asarray(space0.lower, np.float64).copy()
    hi = np.asarray(space0.upper, np.float64).copy()
    if variant != "reference":
        hi[names.index("seed_exposed")] = 50000.0
        lo[names.index("runup_days")] = 5.0
    if variant == "C":
        for i, n in enumerate(names):
            if n.startswith(SEVERITY_PREFIXES):
                lo[i] = lo[i] / 10.0
    return dataclasses.replace(space0, lower=lo, upper=hi), lo, hi


def jax_engines(jp, space):
    """The scripts' ``ll_fn``, ``sero_of`` and ``joint``
    (``sero_profile_probe.py:92-131``)."""
    data, base, ts = jp.data, jp.params, jp.ts
    ts_j = jnp.asarray(ts, jnp.float64)
    base_y0 = jnp.asarray(data.initial_sepaihrd_state(
        sigma=base.sigma, gamma_p=base.gamma_p, gamma_A=base.gamma_A,
        gamma_I=base.gamma_I, p=base.p, h=base.h), jnp.float64)
    ll = build_objective(space, base, data, ts, substeps=SUBSTEPS,
                         tableau=TABLEAU, constraint_mode=REFLECT,
                         dtype=jnp.float64)
    t_idx = int(np.argmin(np.abs(np.asarray(ts) - SERO_TARGET_DAY)))
    total_pop = float(np.sum(np.asarray(data.population_by_age)))

    def sero_of(theta):
        params = space.apply(base, space.constrain(theta, REFLECT))
        y0, _ = jsep.initial_state_for_params(params, base_y0)
        traj = jsep.solve(params, y0, ts_j, method="fixed",
                          substeps=SUBSTEPS, tableau=TABLEAU)
        return (total_pop - jnp.sum(traj[t_idx, 0])) / total_pop

    def joint(theta):
        return ll(theta) - 0.5 * ((sero_of(theta) - TARGET) / SE) ** 2

    return jax.jit(ll), jax.jit(sero_of), jax.jit(jax.value_and_grad(joint))


@pytest.mark.parametrize("variant", ["reference", "B", "C"])
def test_core_matches_the_scripts_engines(pipes, variant):
    pl, jp = pipes
    box = pl.box(variant)
    jspace, lo, hi = jax_box(jp, variant)
    np.testing.assert_array_equal(box.lo, lo)
    np.testing.assert_array_equal(box.hi, hi)
    jll, jsero, jvg = jax_engines(jp, jspace)
    theta_map = sp.nudge(pl.theta_from_txt(sp.MAP_TXT), lo, hi)
    rng = np.random.default_rng(11)
    sig = pl.space0.sigmas.numpy()
    near = np.clip(theta_map + 0.05 * sig * rng.normal(size=62), lo, hi)
    vg = box.joint_vg(SE, TARGET)
    for th in (theta_map, near):
        x = jnp.asarray(th)
        np.testing.assert_allclose(box.ll(th), float(jll(x)), rtol=1e-9)
        np.testing.assert_allclose(box.sero(th), float(jsero(x)), rtol=1e-9)
        v, g = vg(th)
        jv, jg = jvg(x)
        jg = np.asarray(jg)
        np.testing.assert_allclose(v, float(jv), rtol=1e-9)
        np.testing.assert_allclose(g, jg, rtol=1e-9,
                                   atol=1e-9 * np.abs(jg).max())


def test_ridge_projection_and_clip_lists_match_the_script(pipes):
    pl, _ = pipes
    box = pl.box("reference")
    with open(os.path.join(REPO, "results", "sero_ridge.json")) as f:
        ref = json.load(f)                 # written by the JAX script
    assert ref["names_up"] == sero_ridge_scan.RIDGE_UP
    assert ref["names_down"] == sero_ridge_scan.RIDGE_DOWN
    theta_map = pl.theta_from_txt(sp.MAP_TXT)
    names = pl.names
    for row in ref["ridge"]:
        th, clipped = sero_ridge_scan.ridge_point(theta_map, row["k"], names,
                                                  box.lo, box.hi)
        assert clipped == row["clipped"], row["k"]
        # scripts/sero_ridge_scan.py:133-139
        want = theta_map.copy()
        up = [names.index(n) for n in sero_ridge_scan.RIDGE_UP]
        dn = [names.index(n) for n in sero_ridge_scan.RIDGE_DOWN]
        want[up] *= row["k"]
        want[dn] /= row["k"]
        np.testing.assert_array_equal(th, np.clip(want, box.lo, box.hi))


def test_nudge_and_whitening_floors_match_the_scripts(pipes):
    pl, _ = pipes
    names = pl.names
    i_seed, i_run = names.index("seed_exposed"), names.index("runup_days")
    std0 = sp.laplace_std(sp.LAPLACE)
    lap = np.load(sp.LAPLACE)
    np.testing.assert_array_equal(std0, np.maximum(
        lap["std"].astype(np.float64), 1e-12))
    theta_map = pl.theta_from_txt(sp.MAP_TXT)
    ref = pl.box("reference")
    for variant in ("B", "C"):
        box = pl.box(variant)
        lo, hi = box.lo, box.hi
        # the nudge: scripts/sero_sensitivity.py:121-123
        width = hi - lo
        want = np.clip(theta_map, lo + 1e-9 * width, hi - 1e-9 * width)
        np.testing.assert_array_equal(sp.nudge(theta_map, lo, hi), want)
        # scripts/sero_force_profile.py:149-153
        std = std0.copy()
        changed = (lo != ref.lo) | (hi != ref.hi)
        std[changed] = np.maximum(std[changed], 0.05 * width[changed])
        np.testing.assert_array_equal(
            sero_force_profile.whitening(std0, lo, hi, ref.lo, ref.hi), std)
        # the scripts print "2 bounds relaxed" (B) and "18" (C)
        assert changed.sum() == (2 if variant == "B" else 18)
    # scripts/sero_sensitivity.py:143-146
    std = std0.copy()
    std[i_seed] = max(std[i_seed], 0.05 * 50000.0)
    std[i_run] = max(std[i_run], 1.0)
    np.testing.assert_array_equal(
        sero_sensitivity.whitening(std0, i_seed, i_run, 50000.0), std)


def _leaves(x, pre=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{pre}/{k}")
    elif isinstance(x, list) and x and isinstance(x[0], dict):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{pre}[{i}]")
    else:
        yield pre, x


PROBES = {
    "sero_profile_probe": (sero_profile_probe, ["--maxiter", "1",
                                                "--rounds", "1"]),
    "sero_ridge_scan": (sero_ridge_scan, ["--maxiter", "1"]),
    "sero_sensitivity": (sero_sensitivity, ["--maxiter", "1", "--rounds",
                                            "1"]),
    "sero_force_profile": (sero_force_profile, ["--maxiter", "1",
                                                "--se-ladder", "0.01"]),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(PROBES))
def test_probe_main_matches_the_script(name, tmp_path):
    module, argv = PROBES[name]
    sys.path.insert(0, SCRIPTS)
    try:
        script = __import__(name)
    finally:
        sys.path.remove(SCRIPTS)
    assert script.main(argv + ["--out", str(tmp_path / "jax.json")]) == 0
    assert module.main(argv + ["--device", "cpu", "--out",
                               str(tmp_path / "port.json")]) == 0
    want = dict(_leaves(json.loads((tmp_path / "jax.json").read_text())))
    got = dict(_leaves(json.loads((tmp_path / "port.json").read_text())))
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        row, field = key.rsplit("/", 1)
        if field.startswith("delta_ll"):
            # a difference of two log-likelihoods: its bar is the row's LL's
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * abs(
                want[f"{row}/ll"]), err_msg=key)
        elif isinstance(w, float) and not isinstance(w, bool):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, err_msg=key)
        else:
            assert g == w, key
    if name == "sero_sensitivity":
        assert got["/map/grad_runup_days"] == 0.0
