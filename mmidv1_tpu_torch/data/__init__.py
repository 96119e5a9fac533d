"""Reference-format configuration and data IO (NumPy on the host)."""

from .calibration_data import CalibrationData
from .config_io import (read_param_bounds, read_params_to_calibrate,
                        read_proposal_sigmas, read_scalar_sir_parameters,
                        read_sepaihrd_parameters,
                        read_sepaihrd_parameters_dict, read_settings,
                        save_calibration_results)
from .contact_matrix import read_matrix_from_csv

__all__ = ["CalibrationData", "read_param_bounds", "read_params_to_calibrate",
           "read_proposal_sigmas", "read_scalar_sir_parameters",
           "read_sepaihrd_parameters",
           "read_sepaihrd_parameters_dict", "read_settings",
           "save_calibration_results", "read_matrix_from_csv"]
