"""universal_differential_equations_torch — the PyTorch/CUDA port.

A port of ``universal_differential_equations_tpu`` (JAX/XLA/Pallas on a TPU)
to PyTorch and hand-written CUDA kernels on an NVIDIA H100.  The JAX package
stays the reference the port is tested against.  This package holds these
slices of the port:

* A: the Fisher-KPP universal PDE trained by Levenberg-Marquardt, with
  forward-mode sensitivities through the adaptive Tsit5 stepper behind
  ``solve``, and the fused reaction+stencil RHS kernel (``ops/stencil.py``,
  ``csrc/updet_rhs.cu``);
* B: Lotka-Volterra scenario 1 — Vern7 truth, a UDE trained by ADAM then
  BFGS through the continuous adjoints, SINDy recovery, refit and
  extrapolation (``examples/lv_scenario_1.py``);
* C1: ``torch.func.vmap`` over adaptive solves with every adjoint (lanes
  share one loop; a finished lane passes through), multiple shooting
  (``train/shooting.py``), simulation-judged SINDy selection
  (``sindy/select.py``), LV scenario 2 (``examples/lv_scenario_2.py``) and
  the Hudson Bay pipeline (``examples/hudson_bay.py``);
* C2: the SEIR exposure case study (``models/seir.py``,
  ``utils.rescale_problem``, ``examples/seir_exposure.py``), weak-form SINDy
  (``sindy/weak.py``), stability selection and the SR3→STRRidge two-stage
  recovery (``sindy/select.py``), and LV scenario 3, the universal PDE with
  reaction recovery (``examples/lv_scenario_3.py``);
* A′ and D0: the Fisher-KPP case study in all seven variants
  (``examples/fisher_kpp.py``; its MLP variants train by ADAM through the
  fused kernel's reverse rule, then LM), the headline benchmark
  (``bench.py``), the remaining explicit RK tables (Dopri5, Bosh3, Euler,
  Heun), ``StencilConv1D``, ``neural_ode``, checkpoint archives that both
  packages read (``io/``) and the vmapped ensemble runner (``ensemble/``);
* D: the Lotka-Volterra 500-lane noise study (``examples/run_loops.py``);
* E: the climate case study — the stabilized explicit solvers (RKC1, RKC2,
  ROCK2, ROCK4; ``solvers/rkc.py``, ``solvers/rock.py``), the neural-PDE
  column (``models/climate_npde.py``), the 3-D data generators
  (``models/climate_datagen.py``) and the four ``examples/climate_*.py``
  scripts;
* F: the implicit solvers (Rosenbrock23, SDIRK3, Kvaerno3, SDIRK4;
  ``solvers/rosenbrock.py``, ``sdirk.py``, ``esdirk.py``), the
  variable-order BDF DAE solver (``solvers/bdf.py``: ``daeint``,
  ``initialize_dae``) behind ``solve``'s DAE dispatch, and the FENE-P case
  study (``models/fenep.py``, ``examples/fenep.py``).

Its directory layout and module names mirror the JAX package's.
"""

import torch as _torch

# Scientific-computing default: full-f32 matmuls, the counterpart of the JAX
# package's jax_default_matmul_precision=float32.  TF32 keeps about three
# decimal digits and caps the accuracy of the small nets inside these RHS.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .api import solve
from .core.problem import DAEProblem, ODEProblem, remake
from .core.solution import DenseInterpolation, Solution
from .core.controller import PIController
from .solvers.runge_kutta import Bosh3, Dopri5, Euler, Heun, Tsit5, Vern7
from .solvers.rkc import RKC1, RKC2
from .solvers.rock import ROCK2, ROCK4
from .solvers.rosenbrock import Rosenbrock23
from .solvers.sdirk import SDIRK3
from .solvers.esdirk import Kvaerno3, SDIRK4
from .solvers.bdf import daeint, initialize_dae
from .adjoint.sensitivity import (
    BacksolveAdjoint,
    DiscreteAdjoint,
    ForwardSensitivity,
    InterpolatingAdjoint,
    NoAdjoint,
    QuadratureAdjoint,
)
from .nn.layers import Chain, Dense, FourierBasis, MLP, StencilConv1D, TensorLayer, rbf
from .train import (
    BFGSResult,
    FitResult,
    LMResult,
    bfgs_minimize,
    bfgs_minimize_lanes,
    fit,
    fit_bfgs,
    levenberg_marquardt,
    levenberg_marquardt_lanes,
    multiple_shoot,
    reduce_on_plateau,
    shooting_windows,
)
from .io.checkpoint import BestCheckpoint, KeyedArchive, load_pytree, save_pytree
from .models.neural_ode import NeuralODE, neural_ode
from .convert import params_from_jax, theta_from_jax

__version__ = "0.1.0"
__all__ = [
    "solve", "remake", "ODEProblem", "DAEProblem",
    "Solution", "DenseInterpolation", "PIController",
    "Tsit5", "Vern7", "Dopri5", "Bosh3", "Euler", "Heun",
    "RKC1", "RKC2", "ROCK2", "ROCK4",
    "Rosenbrock23", "SDIRK3", "Kvaerno3", "SDIRK4", "daeint", "initialize_dae",
    "NoAdjoint", "DiscreteAdjoint", "ForwardSensitivity",
    "InterpolatingAdjoint", "BacksolveAdjoint", "QuadratureAdjoint",
    "Chain", "Dense", "MLP", "FourierBasis", "StencilConv1D", "TensorLayer", "rbf",
    "levenberg_marquardt", "levenberg_marquardt_lanes", "LMResult",
    "fit", "fit_bfgs", "FitResult", "reduce_on_plateau",
    "bfgs_minimize", "bfgs_minimize_lanes", "BFGSResult",
    "multiple_shoot", "shooting_windows",
    "BestCheckpoint", "KeyedArchive", "save_pytree", "load_pytree",
    "NeuralODE", "neural_ode",
    "params_from_jax", "theta_from_jax",
]
