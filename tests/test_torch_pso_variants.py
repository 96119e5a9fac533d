"""PSO's QUANTUM, LEVY_FLIGHT and HYBRID variants of the port against the
JAX package, in float64 on the CPU.

As in ``tests/test_torch_calibration.py``, each step is fed the draws the JAX
step makes from its key: ``split(key, 8)``, the quantum update's
``split(k, 3)`` (key 2, or 5 for HYBRID), the Levy pick (key 3), the
Mantegna normals' ``split(k)`` (key 4) and HYBRID's uniform (key 6). Given
the same draws and state, a step runs the same arithmetic, the float32
success rates and Levy step scale of the JAX package's int32 counters
included: rtol 1e-12 over two iterations.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu.calibration import pso as jpso

from mmidv1_tpu_torch.calibration import pso as tpso

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_calibration import _pso_to_torch, problem  # noqa: E402,F401

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.array(a))


def _draws(key, S, d, variant):
    """The JAX step's draws of ``key``, as ``tpso.PSODraws``."""
    keys = jax.random.split(key, 8)
    f64 = jnp.float64
    uni = lambda k, shape, **kw: T(jax.random.uniform(k, shape, dtype=f64,
                                                      **kw))
    r1, r2 = jax.random.uniform(keys[2], (2, S, d), dtype=f64)
    out = dict(u=uni(keys[0], (3,)), r1=T(r1), r2=T(r2),
               neighbours=T(jax.random.randint(keys[1], (S, 4), 0, S)).long())
    V = jpso.PSOVariant
    if variant in (V.QUANTUM, V.HYBRID):
        k1, k2, k3 = jax.random.split(keys[2 if variant == V.QUANTUM else 5], 3)
        out.update(phi=uni(k1, (S, 1)), u_log=uni(k2, (S, d), minval=1e-12),
                   u_sign=uni(k3, (S, d)))
    if variant in (V.LEVY_FLIGHT, V.HYBRID):
        ku, kv = jax.random.split(keys[4])
        out.update(levy_u=T(jax.random.normal(ku, (S, d), dtype=f64)),
                   levy_v=T(jax.random.normal(kv, (S, d), dtype=f64)))
    if variant == V.LEVY_FLIGHT:
        out.update(levy_pick=uni(keys[3], (S,)))
    if variant == V.HYBRID:
        out.update(hybrid_u=uni(keys[6], (S,)))
    return tpso.PSODraws(**out)


@pytest.mark.parametrize("variant,topology", [
    (jpso.PSOVariant.QUANTUM, jpso.Topology.GLOBAL_BEST),
    (jpso.PSOVariant.LEVY_FLIGHT, jpso.Topology.LOCAL_BEST),
    (jpso.PSOVariant.HYBRID, jpso.Topology.RANDOM_DYNAMIC),
    (jpso.PSOVariant.HYBRID, jpso.Topology.VON_NEUMANN)])
def test_variant_step_matches_jax_given_draws(problem, variant, topology):  # noqa: F811
    space, tspace = problem["space"], problem["tspace"]
    jll, tll = problem["clamp"]
    S, d = 12, space.dim
    kw = dict(swarm_size=S, iterations=10, quantum_beta=0.8, levy_alpha=1.3)
    cfg = jpso.PSOConfig(variant=variant, topology=topology, **kw)
    tcfg = tpso.PSOConfig(variant=tpso.PSOVariant(int(variant)),
                          topology=tpso.Topology(int(topology)), **kw)
    js = jpso.init_pso_state(space, jax.random.PRNGKey(6), cfg, jll,
                             space.extract(problem["params"]),
                             dtype=jnp.float64)
    # a nonzero stagnation count: the Levy step scale is 0.01 * (1 - 3/20)
    js = js._replace(stagnation=jnp.asarray(3, jnp.int32))
    ts_ = _pso_to_torch(js)
    x0 = ts_.x.clone()
    tab = jpso._neighbor_table(cfg)
    for it in range(2):
        key = jax.random.PRNGKey(40 + it)
        js = jpso.pso_step(js, key, it, cfg, space, jll, tab)
        ts_ = tpso.pso_step(ts_, _draws(key, S, d, variant), it, tcfg, tspace,
                            tll, tpso._neighbor_table(tcfg))
        for f in ("x", "v", "fitness", "pbest_x", "pbest_f", "gbest_x",
                  "gbest_f"):
            np.testing.assert_allclose(getattr(ts_, f).numpy(),
                                       np.asarray(getattr(js, f)), rtol=1e-12,
                                       err_msg=f"{f} at iteration {it}")
        for f in ("success_count", "total_updates"):
            np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                          np.asarray(getattr(js, f)))
        assert ts_.evals == int(js.evals)
    # the step moved the swarm, and kept it in bounds
    assert not torch.equal(ts_.x, x0)
    assert bool(tspace.in_bounds(ts_.x).all())


def test_levy_helpers_match_jax():
    for alpha in (1.1, 1.5, 1.9):
        assert tpso._levy_sigma(alpha) == jpso._levy_sigma(alpha)
    key = jax.random.PRNGKey(9)
    a = np.asarray(jpso._levy_vector(key, (64, 5), 1.5, jnp.float64))
    ku, kv = jax.random.split(key)
    b = tpso._levy_vector(T(jax.random.normal(ku, (64, 5), dtype=jnp.float64)),
                          T(jax.random.normal(kv, (64, 5), dtype=jnp.float64)),
                          1.5).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12)
    assert np.abs(b).max() <= 100.0


def test_config_reads_variant_settings():
    s = {"variant": 4.0, "topology": 3.0, "quantum_beta": 0.7,
         "levy_alpha": 1.2}
    a, b = jpso.PSOConfig.from_settings(s), tpso.PSOConfig.from_settings(s)
    assert (int(b.variant), int(b.topology)) == (4, 3)
    assert (b.quantum_beta, b.levy_alpha) == (a.quantum_beta, a.levy_alpha)
