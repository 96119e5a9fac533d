"""Parameter space, objective, PSO, ensemble adaptive Metropolis (AM and
DE-MC), parallel tempering, NUTS, MALA, calibrator."""

from .tempering import (PTConfig, PTResult, PTState, init_pt_state,
                        make_pt_runner, run_pt)

__all__ = ["PTConfig", "PTResult", "PTState", "init_pt_state",
           "make_pt_runner", "run_pt"]
