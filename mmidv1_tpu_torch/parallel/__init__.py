"""The multi-device layer: the ensemble's chain axis over ``torch.distributed``.

Port of ``mmidv1_tpu/parallel/``; see :mod:`.mesh` for the design and
:mod:`.ensemble` for the sharded runners.
"""

from . import multihost
from .ensemble import (run_mala_gspmd, run_mh_gspmd, run_mh_sharded,
                       run_nuts_gspmd, run_nuts_logit_gspmd,
                       run_pso_sharded, run_pt_gspmd)
from .mesh import (CHAINS_AXIS, EnsembleMesh, check_divisible, ensemble_mesh,
                   gather_fields, shard_ensemble_pytree, shard_state_fields)

__all__ = [
    "CHAINS_AXIS",
    "EnsembleMesh",
    "check_divisible",
    "ensemble_mesh",
    "gather_fields",
    "shard_ensemble_pytree",
    "shard_state_fields",
    "run_mh_gspmd",
    "run_mh_sharded",
    "run_pso_sharded",
    "run_pt_gspmd",
    "run_mala_gspmd",
    "run_nuts_gspmd",
    "run_nuts_logit_gspmd",
    "multihost",
]
