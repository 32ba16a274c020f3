"""universal_differential_equations_torch — the PyTorch/CUDA port.

A port of ``universal_differential_equations_tpu`` (JAX/XLA/Pallas on a TPU)
to PyTorch and hand-written CUDA kernels on an NVIDIA H100.  The JAX package
stays the reference the port is tested against.  This package holds two
slices of the port:

* A: the Fisher-KPP universal PDE trained by Levenberg-Marquardt, with
  forward-mode sensitivities through the adaptive Tsit5 stepper behind
  ``solve``, and the fused reaction+stencil RHS kernel (``ops/stencil.py``,
  ``csrc/updet_rhs.cu``);
* B: Lotka-Volterra scenario 1 — Vern7 truth, a UDE trained by ADAM then
  BFGS through the continuous adjoints, SINDy recovery, refit and
  extrapolation (``examples/lv_scenario_1.py``).

Its directory layout and module names mirror the JAX package's.
"""

import torch as _torch

# Scientific-computing default: full-f32 matmuls, the counterpart of the JAX
# package's jax_default_matmul_precision=float32.  TF32 keeps about three
# decimal digits and caps the accuracy of the small nets inside these RHS.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .api import solve
from .core.problem import ODEProblem, remake
from .core.solution import DenseInterpolation, Solution
from .core.controller import PIController
from .solvers.runge_kutta import Tsit5, Vern7
from .adjoint.sensitivity import (
    BacksolveAdjoint,
    DiscreteAdjoint,
    ForwardSensitivity,
    InterpolatingAdjoint,
    NoAdjoint,
    QuadratureAdjoint,
)
from .nn.layers import Chain, Dense, FourierBasis, MLP, TensorLayer, rbf
from .train import (
    BFGSResult,
    FitResult,
    LMResult,
    bfgs_minimize,
    bfgs_minimize_lanes,
    fit,
    fit_bfgs,
    levenberg_marquardt,
    reduce_on_plateau,
)
from .convert import params_from_jax

__version__ = "0.1.0"
__all__ = [
    "solve", "remake", "ODEProblem",
    "Solution", "DenseInterpolation", "PIController",
    "Tsit5", "Vern7",
    "NoAdjoint", "DiscreteAdjoint", "ForwardSensitivity",
    "InterpolatingAdjoint", "BacksolveAdjoint", "QuadratureAdjoint",
    "Chain", "Dense", "MLP", "FourierBasis", "TensorLayer", "rbf",
    "levenberg_marquardt", "LMResult",
    "fit", "fit_bfgs", "FitResult", "reduce_on_plateau",
    "bfgs_minimize", "bfgs_minimize_lanes", "BFGSResult",
    "params_from_jax",
]
