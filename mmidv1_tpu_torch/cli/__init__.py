"""Command-line entry points of the port: the reference's seven executables.

| reference executable                  | here                                              |
|---------------------------------------|---------------------------------------------------|
| sepaihrd_age_structured_main          | python -m mmidv1_tpu_torch.cli.sepaihrd_main      |
| sepaihrd_objective_benchmark          | python -m mmidv1_tpu_torch.cli.benchmark_main     |
| sir_age_structured_main               | python -m mmidv1_tpu_torch.cli.sir_age_structured_main |
| sir_age_structured_calibration_demo   | python -m mmidv1_tpu_torch.cli.sir_calibration_demo |
| sir_model / sir_pop_var / sir_stochastic | python -m mmidv1_tpu_torch.cli.sir_mains {deterministic,popvar,stochastic} |

Or dispatch through ``python -m mmidv1_tpu_torch.cli <name> [args...]``. Each
runs on the card unless given ``--device cpu``. ``calibrate_spain`` and
``production_campaign`` are scripts of this repository, not reference
executables, and stay out of the table.
"""

COMMANDS = {
    "sepaihrd_age_structured_main": "mmidv1_tpu_torch.cli.sepaihrd_main",
    "sepaihrd_objective_benchmark": "mmidv1_tpu_torch.cli.benchmark_main",
    "sir_age_structured_main": "mmidv1_tpu_torch.cli.sir_age_structured_main",
    "sir_age_structured_calibration_demo":
        "mmidv1_tpu_torch.cli.sir_calibration_demo",
    "sir_model": ("mmidv1_tpu_torch.cli.sir_mains", ["deterministic"]),
    "sir_pop_var": ("mmidv1_tpu_torch.cli.sir_mains", ["popvar"]),
    "sir_stochastic": ("mmidv1_tpu_torch.cli.sir_mains", ["stochastic"]),
}
