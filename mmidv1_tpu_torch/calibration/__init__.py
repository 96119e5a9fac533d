"""Parameter space, objective, PSO, ensemble adaptive Metropolis, calibrator."""
