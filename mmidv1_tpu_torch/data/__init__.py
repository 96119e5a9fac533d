"""Reference-format configuration and data IO (NumPy on the host)."""

from .calibration_data import AGE_BANDS, CalibrationData
from .config_io import (read_hill_climbing_settings,
                        read_metropolis_hastings_settings, read_nuts_settings,
                        read_param_bounds, read_params_to_calibrate,
                        read_particle_swarm_settings, read_proposal_sigmas,
                        read_scalar_sir_parameters, read_sepaihrd_parameters,
                        read_sepaihrd_parameters_dict, read_settings,
                        save_calibration_results)
from .contact_matrix import read_matrix_from_csv

__all__ = ["CalibrationData", "AGE_BANDS", "read_matrix_from_csv",
           "read_sepaihrd_parameters", "read_sepaihrd_parameters_dict",
           "read_param_bounds", "read_proposal_sigmas",
           "read_params_to_calibrate", "read_settings",
           "read_metropolis_hastings_settings", "read_hill_climbing_settings",
           "read_particle_swarm_settings", "read_nuts_settings",
           "save_calibration_results", "read_scalar_sir_parameters"]
