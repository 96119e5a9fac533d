"""Parameter space, objective, PSO, ensemble adaptive Metropolis (AM and
DE-MC), parallel tempering, NUTS, MALA, calibrator.

The names are those of ``mmidv1_tpu.calibration`` plus the tempering
runner's state and stepper and its campaign driver. The fused (kernel)
objectives live in ``ops`` and are not re-exported here, so that this
package imports without CUDA.
"""

from .param_space import ParameterSpace, CLAMP, REFLECT
from .objective import build_objective, build_incidence_fn, make_time_grid, lowest
from .mh import MHConfig, MHResult, run_mh
from .mala import MALAConfig, MALAResult, run_mala
from .tempering import (PTConfig, PTResult, PTState, init_pt_state,
                        make_pt_runner, run_pt, run_pt_checkpointed)
from .pso import PSOConfig, PSOResult, PSOVariant, Topology, run_pso
from .hill import HillClimbConfig, HillClimbResult, run_hill_climb
from .nuts import (NUTSConfig, NUTSResult, run_nuts, run_nuts_dense,
                   run_nuts_whitened)
from .calibrator import CalibrationResult, calibrate, condition_covariance
from .sir_space import SIRParameterSpace
from .sir_objective import build_sir_objective

__all__ = [
    "ParameterSpace", "CLAMP", "REFLECT",
    "build_objective", "build_incidence_fn", "make_time_grid", "lowest",
    "MHConfig", "MHResult", "run_mh",
    "MALAConfig", "MALAResult", "run_mala",
    "PTConfig", "PTResult", "PTState", "init_pt_state", "make_pt_runner",
    "run_pt", "run_pt_checkpointed",
    "PSOConfig", "PSOResult", "PSOVariant", "Topology", "run_pso",
    "HillClimbConfig", "HillClimbResult", "run_hill_climb",
    "NUTSConfig", "NUTSResult", "run_nuts", "run_nuts_dense",
    "run_nuts_whitened",
    "CalibrationResult", "calibrate", "condition_covariance",
    "SIRParameterSpace", "build_sir_objective",
]
