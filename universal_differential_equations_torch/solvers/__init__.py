from .rkc import RKC1, RKC2
from .rock import ROCK2, ROCK4
from .runge_kutta import AbstractERK, Bosh3, Dopri5, Euler, Heun, Tsit5, Vern7
from .tableaus import TABLEAUS, ButcherTableau

__all__ = ["AbstractERK", "Tsit5", "Vern7", "Dopri5", "Bosh3", "Euler", "Heun", "TABLEAUS",
           "ButcherTableau", "RKC1", "RKC2", "ROCK2", "ROCK4"]
