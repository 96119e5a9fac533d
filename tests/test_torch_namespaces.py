"""The port's package namespaces against the JAX package's.

Each port subpackage's ``__all__`` holds every name of its JAX
counterpart's, so that code written against ``mmidv1_tpu`` runs when only
the package name changes. The exceptions are documented:

- the kernel-backed objectives are named for CUDA, not Pallas
  (``build_objective_pallas(_grad)`` is ``build_objective_fused(_grad)``);
- ``parallel.batch_sharding`` / ``replicated_sharding`` are JAX shardings,
  which ``torch.distributed`` has no counterpart of.
"""

import importlib
import os
import subprocess
import sys

import pytest

RENAMED = {"build_objective_pallas": "build_objective_fused",
           "build_objective_pallas_grad": "build_objective_fused_grad"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ONLY = {"parallel": {"batch_sharding", "replicated_sharding"}}
SUBPACKAGES = ["", "analysis", "calibration", "data", "models", "ode", "ops",
               "parallel", "utils"]


def _module(package, sub):
    return importlib.import_module(package + (f".{sub}" if sub else ""))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "root")
def test_all_holds_the_jax_names(sub):
    jax_mod = _module("mmidv1_tpu", sub)
    port = _module("mmidv1_tpu_torch", sub)
    want = {RENAMED.get(n, n) for n in jax_mod.__all__} - JAX_ONLY.get(sub, set())
    missing = sorted(want - set(port.__all__))
    assert not missing, missing
    undefined = [n for n in port.__all__ if not hasattr(port, n)]
    assert not undefined, undefined
    assert len(set(port.__all__)) == len(port.__all__)


def test_version_matches_jax():
    import mmidv1_tpu
    import mmidv1_tpu_torch
    assert mmidv1_tpu_torch.__version__ == mmidv1_tpu.__version__ == "0.1.0"


def test_namespaces_import_without_kernels():
    """Every subpackage but ``ops`` imports without loading ``ops`` (whose
    kernels need CUDA), JAX or the JAX package."""
    subs = [s for s in SUBPACKAGES if s not in ("", "ops")] + ["cli"]
    code = ("import importlib, sys\n"
            f"for s in {subs!r}:\n"
            "    importlib.import_module('mmidv1_tpu_torch.' + s)\n"
            "bad = [m for m in sys.modules if m.startswith('jax')\n"
            "       or m.split('.')[0] == 'mmidv1_tpu'\n"
            "       or m.startswith('mmidv1_tpu_torch.ops')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
