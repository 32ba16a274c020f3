from . import climate_datagen, climate_npde, fisher_kpp
from .neural_ode import NeuralODE, neural_ode

__all__ = ["climate_datagen", "climate_npde", "fisher_kpp", "NeuralODE", "neural_ode"]
