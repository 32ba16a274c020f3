"""Rosenbrock stiff ODE solver.

Port of ``universal_differential_equations_tpu/solvers/rosenbrock.py``:
``Rosenbrock23``, the Shampine-Reichelt 2(3) linearly-implicit pair (the
``ode23s`` / OrdinaryDiffEq ``Rosenbrock23`` method): one Jacobian and one LU
factorization per step, three triangular solves, no Newton iteration.

The Jacobian ``∂f/∂y`` is ``torch.func.jacrev`` of ``f(t, ·, args)`` (see
``solvers/sdirk.py`` for why reverse mode); with ``autodiff_time`` the time
derivative ``∂f/∂t`` comes from the same ``jacrev`` call, over ``(t, y)``,
where the JAX package runs ``jax.jvp`` in ``t``.  ``t`` is made a tensor of
the state's dtype.  The factorization is
``torch.linalg.lu_factor_ex`` (``sdirk._factor``): no host sync, and an
exactly singular ``I − dt·d·J`` gives inf/NaN solves that the controller
rejects, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from .sdirk import _factor, _jacobian

__all__ = ["Rosenbrock23"]

_D = 1.0 / (2.0 + math.sqrt(2.0))
_E32 = 6.0 + math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class Rosenbrock23:
    """L-stable 2nd-order Rosenbrock-W pair with 3rd-order error companion.

    ``autodiff_time=True`` also differentiates the RHS in ``t`` (needed for
    non-autonomous stiffness; costs one extra JVP per step).
    """

    autodiff_time: bool = True

    reverse_jacobian: ClassVar[bool] = True
    order: int = dataclasses.field(default=2, init=False)
    error_order: int = dataclasses.field(default=3, init=False)

    @property
    def name(self):
        return "Rosenbrock23"

    def step(self, f, t, y, f0, dt, args):
        n = y.shape[0]
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
        if self.autodiff_time:
            ft, J = torch.func.jacrev(lambda tt, yy: f(tt, yy, args), argnums=(0, 1))(t, y)
        else:
            J = _jacobian(f, t, y, args)
            ft = torch.zeros_like(y)

        solve = _factor(torch.eye(n, dtype=y.dtype, device=y.device) - (dt * _D) * J)

        k1 = solve(f0 + (dt * _D) * ft)
        f1 = f(t + 0.5 * dt, y + 0.5 * dt * k1, args)
        k2 = solve(f1 - k1) + k1
        y1 = y + dt * k2
        f2 = f(t + dt, y1, args)
        k3 = solve(f2 - _E32 * (k2 - f1) - 2.0 * (k1 - f0) + (dt * _D) * ft)
        y_err = (dt / 6.0) * (k1 - 2.0 * k2 + k3)
        return y1, y_err, f2, 2  # f1, f2 fresh evals (J/JVP counted separately)
