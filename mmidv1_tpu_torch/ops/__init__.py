"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from .sepaihrd_fused import (build_objective_fused, fused_objective,
                             fused_objective_reference)

__all__ = ["build_objective_fused", "fused_objective",
           "fused_objective_reference"]
