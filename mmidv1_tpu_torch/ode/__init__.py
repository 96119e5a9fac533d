"""RK tableaus and the fixed-grid and adaptive integrators."""

from .integrate import (fold_times, fold_times_fixed, integrate_times,
                        integrate_times_fixed, rk_step)
from .tableaus import (CASH_KARP, DOPRI5, FEHLBERG78, RK4, TABLEAUS, Tableau,
                       get_tableau)

__all__ = ["DOPRI5", "CASH_KARP", "FEHLBERG78", "RK4", "TABLEAUS", "Tableau",
           "get_tableau", "integrate_times", "integrate_times_fixed",
           "fold_times", "fold_times_fixed", "rk_step"]
