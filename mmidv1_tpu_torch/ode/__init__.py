"""RK tableaus and the fixed-grid integrators."""

from .integrate import fold_times_fixed, integrate_times_fixed
from .tableaus import TABLEAUS, Tableau, get_tableau

__all__ = ["fold_times_fixed", "integrate_times_fixed", "TABLEAUS", "Tableau",
           "get_tableau"]
