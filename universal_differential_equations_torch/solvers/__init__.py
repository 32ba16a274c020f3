from .bdf import daeint, initialize_dae
from .esdirk import Kvaerno3, SDIRK4
from .rkc import RKC1, RKC2
from .rock import ROCK2, ROCK4
from .rosenbrock import Rosenbrock23
from .runge_kutta import AbstractERK, Bosh3, Dopri5, Euler, Heun, Tsit5, Vern7
from .sdirk import SDIRK3
from .tableaus import TABLEAUS, ButcherTableau

__all__ = ["AbstractERK", "Tsit5", "Vern7", "Dopri5", "Bosh3", "Euler", "Heun", "TABLEAUS",
           "ButcherTableau", "RKC1", "RKC2", "ROCK2", "ROCK4",
           "Rosenbrock23", "SDIRK3", "Kvaerno3", "SDIRK4", "daeint", "initialize_dae"]
