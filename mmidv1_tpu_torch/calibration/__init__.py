"""Parameter space, objective, PSO, ensemble adaptive Metropolis, NUTS,
MALA, calibrator."""
