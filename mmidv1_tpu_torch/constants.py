"""Model-wide constants of the PyTorch port (a copy of
``mmidv1_tpu/constants.py``, kept here so the port never imports the JAX
package).

The constants of the C++ reference
(``include/model/ModelConstants.hpp:7-22``). The SEPAIHRD state is laid out as a
``(NUM_COMPARTMENTS, n_ages)`` array (compartment-major, age-minor), matching the
reference's SoA flat layout ``[S0..Sn, E0..En, ...]`` when raveled in C order.
"""

DEFAULT_NUM_AGE_CLASSES = 4

NUMERICAL_EPSILON = 1e-9
MIN_POPULATION_FOR_DIVISION = 1e-9

DEFAULT_NPI_LOWER_BOUND = 0.1
DEFAULT_NPI_UPPER_BOUND = 1.5
DEFAULT_BASELINE_PERIOD_END_TIME = 13.0
DEFAULT_BASELINE_KAPPA = 1.0

# SEPAIHRD compartment layout: S,E,P,A,I,H,ICU,R,D,CumH,CumICU
COMPARTMENTS = ("S", "E", "P", "A", "I", "H", "ICU", "R", "D", "CumH", "CumICU")
NUM_COMPARTMENTS = len(COMPARTMENTS)  # 11
# Compartments that represent people and must sum to the population size
# (excludes cumulative bookkeeping compartments CumH / CumICU).
NUM_POPULATION_COMPARTMENTS = 9

# Compartment indices (row index in the (11, n_ages) state array).
IDX = {name: i for i, name in enumerate(COMPARTMENTS)}
S, E, P, A, I, H, ICU, R, D, CUMH, CUMICU = range(NUM_COMPARTMENTS)

# Poisson log-likelihood epsilon (reference:
# src/model/objectives/SEPAIHRDObjectiveFunction.cpp:251)
POISSON_EPSILON = 1e-10

# Value returned for infeasible/failed objective evaluations, mirroring
# std::numeric_limits<double>::lowest() semantics under torch.where masking.
NEG_INF_OBJECTIVE = -1.0e300
