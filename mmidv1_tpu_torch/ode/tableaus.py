"""Explicit Runge-Kutta Butcher tableaus.

Replaces the reference's pluggable Boost.Odeint solver strategies
(``src/sir_age_structured/solvers/{Dopri5,CashKarp,Fehlberg}SolverStrategy.cpp``)
with data: a tableau is a NamedTuple of numpy coefficient arrays consumed by the
generic steppers in :mod:`mmidv1_tpu_torch.ode.integrate` and, as coefficient
tables, by the fused CUDA kernel (``csrc/sepaihrd_fused.cu``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Tableau(NamedTuple):
    name: str
    c: np.ndarray          # (s,) stage times
    a: np.ndarray          # (s, s) strictly lower-triangular stage coefficients
    b: np.ndarray          # (s,) propagating weights (higher order)
    b_err: Optional[np.ndarray]  # (s,) b - b_lower for embedded error estimate
    order: int             # order of the propagated solution
    error_order: int       # boost's error_order_value for the stepper
    #                        (explicit_error_stepper_base template arg:
    #                        4 for dopri5/cash_karp/rkf45, 8 for fehlberg78
    #                        — drives the reject-shrink exponent
    #                        -1/(error_order-1) in the adaptive controller)

    @property
    def stages(self) -> int:
        return len(self.c)

    @property
    def fsal(self) -> bool:
        """First-Same-As-Last: the final stage evaluates f at (t+dt, y_new),
        so it can seed stage 0 of the next step (true for Dopri5)."""
        return bool(self.c[-1] == 1.0 and np.allclose(self.a[-1], self.b))


def _tab(name, c, a_rows, b, b_low, order, error_order):
    s = len(c)
    a = np.zeros((s, s))
    for i, row in enumerate(a_rows):
        a[i, : len(row)] = row
    b = np.asarray(b, dtype=np.float64)
    b_err = None if b_low is None else b - np.asarray(b_low, dtype=np.float64)
    return Tableau(name, np.asarray(c, dtype=np.float64), a, b, b_err, order, error_order)


# Dormand-Prince 5(4), the reference's default solver
# (``Dopri5SolverStrategy.cpp:27-37`` -> boost runge_kutta_dopri5). FSAL: the last
# stage evaluates f at (t+dt, y_new).
DOPRI5 = _tab(
    "dopri5",
    c=[0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1],
    a_rows=[
        [],
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ],
    b=[35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    b_low=[5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40],
    order=5,
    error_order=4,
)

# Cash-Karp 5(4) (``CashKarpSolverStrategy.cpp`` -> boost runge_kutta_cash_karp54)
CASH_KARP = _tab(
    "cash_karp",
    c=[0, 1 / 5, 3 / 10, 3 / 5, 1, 7 / 8],
    a_rows=[
        [],
        [1 / 5],
        [3 / 40, 9 / 40],
        [3 / 10, -9 / 10, 6 / 5],
        [-11 / 54, 5 / 2, -70 / 27, 35 / 27],
        [1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096],
    ],
    b=[37 / 378, 0, 250 / 621, 125 / 594, 0, 512 / 1771],
    b_low=[2825 / 27648, 0, 18575 / 48384, 13525 / 55296, 277 / 14336, 1 / 4],
    order=5,
    error_order=4,
)

# Runge-Kutta-Fehlberg 7(8) (``FehlbergSolverStrategy.cpp`` ->
# boost runge_kutta_fehlberg78); propagates the 8th-order solution.
FEHLBERG78 = _tab(
    "fehlberg78",
    c=[0, 2 / 27, 1 / 9, 1 / 6, 5 / 12, 1 / 2, 5 / 6, 1 / 6, 2 / 3, 1 / 3, 1, 0, 1],
    a_rows=[
        [],
        [2 / 27],
        [1 / 36, 1 / 12],
        [1 / 24, 0, 1 / 8],
        [5 / 12, 0, -25 / 16, 25 / 16],
        [1 / 20, 0, 0, 1 / 4, 1 / 5],
        [-25 / 108, 0, 0, 125 / 108, -65 / 27, 125 / 54],
        [31 / 300, 0, 0, 0, 61 / 225, -2 / 9, 13 / 900],
        [2, 0, 0, -53 / 6, 704 / 45, -107 / 9, 67 / 90, 3],
        [-91 / 108, 0, 0, 23 / 108, -976 / 135, 311 / 54, -19 / 60, 17 / 6, -1 / 12],
        [2383 / 4100, 0, 0, -341 / 164, 4496 / 1025, -301 / 82, 2133 / 4100, 45 / 82,
         45 / 164, 18 / 41],
        [3 / 205, 0, 0, 0, 0, -6 / 41, -3 / 205, -3 / 41, 3 / 41, 6 / 41, 0],
        [-1777 / 4100, 0, 0, -341 / 164, 4496 / 1025, -289 / 82, 2193 / 4100, 51 / 82,
         33 / 164, 12 / 41, 0, 1],
    ],
    b=[0, 0, 0, 0, 0, 34 / 105, 9 / 35, 9 / 35, 9 / 280, 9 / 280, 0, 41 / 840, 41 / 840],
    b_low=[41 / 840, 0, 0, 0, 0, 34 / 105, 9 / 35, 9 / 35, 9 / 280, 9 / 280, 41 / 840,
           0, 0],
    order=8,
    error_order=8,
)

# Runge-Kutta-Fehlberg 4(5) — the GSL ``gsl_odeiv2_step_rkf45`` the reference's
# scalar SIR models use (``src/base/SIRModel.cpp:38``,
# ``SIR_population_variable.cpp``). Propagates the 5th-order solution.
RKF45 = _tab(
    "rkf45",
    c=[0, 1 / 4, 3 / 8, 12 / 13, 1, 1 / 2],
    a_rows=[
        [],
        [1 / 4],
        [3 / 32, 9 / 32],
        [1932 / 2197, -7200 / 2197, 7296 / 2197],
        [439 / 216, -8, 3680 / 513, -845 / 4104],
        [-8 / 27, 2, -3544 / 2565, 1859 / 4104, -11 / 40],
    ],
    b=[16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55],
    b_low=[25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0],
    order=5,
    error_order=4,
)

# Classic RK4 (no embedded error): cheapest fixed-grid stepper.
RK4 = _tab(
    "rk4",
    c=[0, 1 / 2, 1 / 2, 1],
    a_rows=[[], [1 / 2], [0, 1 / 2], [0, 0, 1]],
    b=[1 / 6, 1 / 3, 1 / 3, 1 / 6],
    b_low=None,
    order=4,
    error_order=4,
)

TABLEAUS = {t.name: t for t in (DOPRI5, CASH_KARP, FEHLBERG78, RKF45, RK4)}


def get_tableau(name) -> Tableau:
    if isinstance(name, Tableau):
        return name
    try:
        return TABLEAUS[name]
    except KeyError:
        raise ValueError(f"Unknown tableau '{name}'. Available: {sorted(TABLEAUS)}")
