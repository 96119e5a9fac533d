"""The zero-coefficient rule of the SEPAIHRD kernels, on the host.

The Pallas kernel (``mmidv1_tpu/ops/sepaihrd_pallas.py``, ``if a_tab[i, j]
!= 0.0`` when it is traced) skips every zero tableau coefficient, and so do
the port's plain versions. The CUDA kernels K1, K2 and K3 compile each
tableau's zero pattern in: ``ops/_build.py`` generates it from
``ode/tableaus.py`` into ``sepaihrd_tableaus.cuh`` at every build, and
``csrc/sepaihrd_common.cuh`` emits no instruction for a zero entry. Here:

- the generated header holds each tableau's zero pattern, stage count and
  FSAL flag as the JAX package's tableaus have them, under the ids the
  wrappers pass, and a changed header changes the library's hash;
- ``stage_use`` names the dead stages: fehlberg78's stage 10 in both
  directions, dopri5's last in the adjoint;
- at the stiff input of ``tests/torch_stiff.py`` the Pallas kernel in
  interpret mode (as ``tests/test_pallas.py`` runs it) and the port's plain
  version give the same finite log-likelihood, rtol 1e-12 in float64 (both
  run the same float64 arithmetic) and 5e-6 in float32 (the kernels' bar at
  full width; the sums over streams and ages go in another order). A model
  of the rule the kernels had before, ``fma(0, k, y)``, gives NaN there, so
  the input tells the two rules apart;
- there too, the plain model of K3's chunk-parallel regime equals the plain
  K3: the last chunk's Jacobian, which overflows there, is not read.

The CUDA kernels at the same input: ``tests/test_torch_kernels.py`` (on the
card) and phase 30 of ``chip_smoke.py``.
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmidv1_tpu import make_params as j_make_params
from mmidv1_tpu.calibration.objective import make_time_grid
from mmidv1_tpu.calibration.param_space import REFLECT, ParameterSpace
from mmidv1_tpu.data import CalibrationData
from mmidv1_tpu.ode.tableaus import get_tableau as j_get_tableau
from mmidv1_tpu.ops import build_objective_pallas

from mmidv1_tpu_torch.calibration.objective import lowest
from mmidv1_tpu_torch.ode import integrate as t_integrate
from mmidv1_tpu_torch.ops import _build
from mmidv1_tpu_torch.ops import sepaihrd_fused as sf

sys.path.insert(0, os.path.dirname(__file__))
import torch_stiff as stiff  # noqa: E402

torch.set_num_threads(1)
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-12),
          "float32": (torch.float32, jnp.float32, 5e-6)}


def _header_patterns():
    """``{name: (id, S, fsal, a != 0, b != 0)}`` read back from the text of
    the generated header."""
    out = {}
    for block in _build.tableau_header().split("struct ")[1:]:
        name = re.search(r"// (\w+)", block).group(1)
        S = int(re.search(r"S = (\d+);", block).group(1))
        rows = {int(i): int(m, 16) for i, m in
                re.findall(r"case (\d+): return (0x[0-9a-f]+)u;", block)}
        b_bits = int(re.search(r"b_bits = (0x[0-9a-f]+)u", block).group(1), 16)
        a = np.array([[(rows.get(i, 0) >> j) & 1 for j in range(S)]
                      for i in range(S)], dtype=bool)
        b = np.array([(b_bits >> j) & 1 for j in range(S)], dtype=bool)
        out[name] = (int(re.search(r"id = (\d+);", block).group(1)), S,
                     "fsal = true" in block, a, b)
    return out


@pytest.mark.parametrize("tableau", _build.KERNEL_TABLEAUS)
def test_generated_header_holds_each_zero_pattern(tableau):
    """The masks the kernels compile are the JAX package's ``a != 0`` (below
    the diagonal) and ``b != 0``; the id is the wrappers' ``tableau_id``."""
    tid, S, fsal, a, b = _header_patterns()[tableau]
    ref = j_get_tableau(tableau)
    assert (S, fsal) == (ref.stages, ref.fsal)
    np.testing.assert_array_equal(a, np.tril(np.asarray(ref.a), -1) != 0.0)
    np.testing.assert_array_equal(b, np.asarray(ref.b) != 0.0)
    assert tid == _build.tableau_id(tableau) == _build.KERNEL_TABLEAUS.index(tableau)
    assert f"X({tid}, " in _build.tableau_header().splitlines()[-3]


def test_dispatch_tells_cash_karp_from_rkf45():
    """Same stage count, different zero patterns: two instantiations."""
    pat = _header_patterns()
    assert pat["cash_karp"][1] == pat["rkf45"][1] == 6
    assert pat["cash_karp"][0] != pat["rkf45"][0]
    assert not np.array_equal(pat["cash_karp"][4], pat["rkf45"][4])
    with pytest.raises(ValueError):
        _build.tableau_id("euler")


def test_library_hash_covers_the_generated_header(monkeypatch):
    before = _build.library_path("sepaihrd_fused")
    monkeypatch.setattr(_build, "tableau_header",
                        lambda: "// another zero pattern\n")
    assert _build.library_path("sepaihrd_fused") != before


def test_stage_use_names_the_dead_stages():
    feeds, live, evaluated = sf.stage_use("dopri5")
    assert feeds == [True] * 6 + [False] and live == feeds
    assert evaluated == [True] * 7                  # FSAL carries stage 6
    feeds, live, evaluated = sf.stage_use("fehlberg78")
    dead = [i for i in range(13) if not evaluated[i]]
    assert dead == [10] and not live[10] and not feeds[12] and live[12]
    for name in ("rk4", "cash_karp", "rkf45"):
        assert all(sf.stage_use(name)[1])
    # fehlberg78's forward evaluates 12 of its 13 stages a substep
    assert sf.dependent_stages("fehlberg78", 2, 10) == 10 * 2 * 12


def _jax_pallas(dtype_name, thetas):
    _t, jdtype, _tol = DTYPES[dtype_name]
    prm = stiff.stiff_prm(dtype_name)
    params = j_make_params(**stiff.stiff_param_kwargs(prm), dtype=jdtype)
    data = CalibrationData.from_arrays(**stiff.stiff_data_kwargs(prm))
    space = ParameterSpace.create(stiff.NAMES, stiff.BOUNDS, stiff.SIGMAS,
                                  params)
    ll = build_objective_pallas(space, params, data,
                                make_time_grid(0.0, stiff.STIFF_DAYS),
                                substeps=stiff.SUBSTEPS, tableau=stiff.TABLEAU,
                                constraint_mode=REFLECT, dtype=jdtype,
                                interpret=True, block_b=stiff.STIFF_CHAINS)
    return np.asarray(ll(jnp.asarray(thetas, jdtype)), dtype=np.float64)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_pallas_and_plain_agree_at_the_stiff_input(dtype_name):
    dtype, _j, rtol = DTYPES[dtype_name]
    ll, thetas = stiff.stiff_objective(dtype, "cpu")
    port = ll(thetas).double().numpy()
    ref = _jax_pallas(dtype_name, thetas.double().numpy())
    assert np.isfinite(ref).all() and (ref > -1e30).all()
    np.testing.assert_allclose(port, ref, rtol=rtol)


class _EveryCoefficient(t_integrate._Coefs):
    """The rule the CUDA kernels had before: every coefficient is applied,
    a zero one too (``y + 0 * k``)."""

    def __init__(self, tab, dt, like):
        super().__init__(tab, dt, like)
        t = lambda c: torch.tensor(dt * c, dtype=like.dtype, device=like.device)
        self.a = [[(j, t(float(tab.a[i, j]))) for j in range(i)]
                  for i in range(tab.stages)]
        self.b = [(i, t(float(tab.b[i]))) for i in range(tab.stages)]


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_the_stiff_input_separates_the_two_rules(dtype_name, monkeypatch):
    """Skipping a zero gives a finite log-likelihood on every chain; an FMA
    by zero gives NaN on every chain, and the objective ``finfo.min``."""
    dtype = DTYPES[dtype_name][0]
    ll, thetas = stiff.stiff_objective(dtype, "cpu")
    args, kw, _inf = ll.prep.kernel_args(thetas)
    kw = dict(kw, substeps=stiff.SUBSTEPS, tableau=stiff.TABLEAU)
    assert torch.isfinite(sf.fused_objective_reference(*args, **kw)).all()
    monkeypatch.setattr(t_integrate, "_Coefs", _EveryCoefficient)
    assert torch.isnan(sf.fused_objective_reference(*args, **kw)).all()
    assert (ll(thetas) == lowest(dtype)).all()


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_chunked_model_holds_at_the_stiff_input(dtype_name):
    """K3's chunk-parallel regime forms each chunk's Jacobian. At the stiff
    input it overflows, though the gradient does not; no lambda enters the
    last chunk, so its Jacobian is not read, and the plain model of the
    regime equals the plain K3 (the sequential sweep): float64 rtol 1e-9
    floored at the chain's largest entry, float32 per-chain 2-norm 1e-3."""
    from mmidv1_tpu_torch.ops import sepaihrd_adjoint as adj

    dtype = DTYPES[dtype_name][0]
    ll, thetas = stiff.stiff_objective(dtype, "cpu")
    (y0, agevec, scal, beff, obs, valid, M), kw, _inf = \
        ll.prep.kernel_args(thetas)
    kw = dict(kw, substeps=stiff.SUBSTEPS, tableau=stiff.TABLEAU)
    _ll, ck = adj.fused_forward_ckpt_reference(y0, agevec, scal, beff, obs,
                                               valid, M, **kw)
    g = torch.ones(thetas.shape[0], dtype=dtype)
    args = (agevec, scal, beff, obs, valid, ck, g, M)
    want = adj.fused_adjoint_reference(*args, **kw)
    got = adj.fused_adjoint_chunked_reference(*args, **kw)
    for a, b in zip(got, want):
        a = a.double().numpy().reshape(-1, a.shape[-1])
        b = b.double().numpy().reshape(-1, b.shape[-1])
        assert np.isfinite(a).all() and np.isfinite(b).all()
        for c in range(b.shape[1]):
            if dtype == torch.float64:
                np.testing.assert_allclose(a[:, c], b[:, c], rtol=1e-9,
                                           atol=1e-9 * np.abs(b[:, c]).max())
            else:
                assert np.linalg.norm(a[:, c] - b[:, c]) <= \
                    1e-3 * np.linalg.norm(b[:, c])
