from .runge_kutta import AbstractERK, Tsit5
from .tableaus import TABLEAUS, ButcherTableau

__all__ = ["AbstractERK", "Tsit5", "TABLEAUS", "ButcherTableau"]
