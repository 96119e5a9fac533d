"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from .sepaihrd_adjoint import (FusedObjectiveFn, build_objective_fused_grad,
                               fused_adjoint, fused_adjoint_chunked_reference,
                               fused_adjoint_reference, fused_forward_ckpt,
                               fused_forward_ckpt_reference)
from .sepaihrd_fused import (build_objective_fused, fused_objective,
                             fused_objective_reference)

__all__ = ["FusedObjectiveFn", "build_objective_fused",
           "build_objective_fused_grad", "fused_adjoint",
           "fused_adjoint_chunked_reference", "fused_adjoint_reference",
           "fused_forward_ckpt", "fused_forward_ckpt_reference",
           "fused_objective", "fused_objective_reference"]
