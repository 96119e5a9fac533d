"""mmidv1_tpu_torch — the PyTorch + CUDA port of ``mmidv1_tpu``.

Runs the Spain-2020 SEPAIHRD calibration (PSO -> ensemble adaptive
Metropolis) on an NVIDIA H100, with the fused objective as a hand-written
CUDA kernel (``csrc/sepaihrd_fused.cu``). It imports ``torch`` and NumPy and
never the JAX package: its module paths mirror ``mmidv1_tpu``'s so that each
module's counterpart is easy to find, and the tests hold each one against it.

Entry points default to ``device="cuda"`` and raise when no card is present;
pass ``device="cpu"`` to run on the host (the tests do).
"""

from . import constants
from .params import (SEPAIHRDParams, beta_at, kappa_at, make_params,
                     params_from_numpy, piecewise_value)

__all__ = ["constants", "SEPAIHRDParams", "make_params", "params_from_numpy",
           "beta_at", "kappa_at", "piecewise_value"]

__version__ = "0.1.0"
