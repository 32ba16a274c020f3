"""Problem abstractions: ODE / SDE / DAE problems and ``remake``.

Port of ``universal_differential_equations_tpu/core/problem.py``.  Problems are
immutable dataclasses; ``remake`` (reference ``scenario_1.jl:83``) is a
functional update.  ``u0`` may be a tensor or a pytree of tensors (dicts,
lists, tuples); ``solve`` ravels it to a flat vector and unravels on output.

``solve`` takes ``ODEProblem`` and ``DAEProblem`` (the latter through
``solvers/bdf.py:daeint``); an ``SDEProblem`` goes to ``solvers/sde.py``
(``sdeint``, ``AdaptiveEM``), which take its Brownian noise, and ``solve``
rejects it with a ``TypeError`` that says so.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

__all__ = ["ODEProblem", "SDEProblem", "DAEProblem", "remake"]


@dataclasses.dataclass(frozen=True)
class ODEProblem:
    """An initial value problem ``du/dt = f(t, u, args)`` over ``tspan``.

    ``f`` is out-of-place: it returns ``du`` as a pytree matching ``u``.
    """

    f: Callable[[Any, Any, Any], Any]
    u0: Any
    tspan: Tuple[Any, Any]
    args: Any = None

    def __post_init__(self):
        if not callable(self.f):
            raise TypeError("ODEProblem.f must be callable f(t, u, args) -> du")


@dataclasses.dataclass(frozen=True)
class SDEProblem:
    """``du = f(t, u, args) dt + g(t, u, args) dW`` over ``tspan``."""

    f: Callable[[Any, Any, Any], Any]
    g: Callable[[Any, Any, Any], Any]
    u0: Any
    tspan: Tuple[Any, Any]
    args: Any = None
    noise_dim: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DAEProblem:
    """Implicit DAE ``F(t, u, du, args) = 0`` with a differential-variables mask."""

    f: Callable[[Any, Any, Any, Any], Any]  # F(t, u, du, args) -> residual
    u0: Any
    du0: Any
    tspan: Tuple[Any, Any]
    args: Any = None
    differential_vars: Any = None


def remake(problem, **updates):
    """Functional update of any problem type (reference ``scenario_1.jl:83``)."""
    return dataclasses.replace(problem, **updates)
