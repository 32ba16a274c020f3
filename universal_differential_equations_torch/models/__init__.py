from . import fisher_kpp
from .neural_ode import NeuralODE, neural_ode

__all__ = ["fisher_kpp", "NeuralODE", "neural_ode"]
