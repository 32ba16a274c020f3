"""SDIRK3: L-stable singly-diagonally-implicit stiff ODE solver.

Port of ``universal_differential_equations_tpu/solvers/sdirk.py``:
Alexander's 3-stage stiffly-accurate SDIRK (R. Alexander, SINUM 14, 1977).
The diagonal ``γ`` is the root of ``x³ - 3x² + 3x/2 - 1/6`` in (1/6, 1/2),
computed by host Newton in float64, which makes the method L-stable; the
last stage row equals ``b``, so ``k₃`` is the end-point derivative.  All
three stages solve ``k = f(tᵢ, base + γ·dt·k)`` by modified Newton on one
``I - γ·dt·J`` LU factorization.  The embedded 2nd-order companion ``b̂``
(``b̂₃ = 0``) gives the O(h³) error estimate.

The JAX scan of 6 Newton iterations is a Python loop of 6 iterations.  The
Jacobian is taken with respect to the stage input only, so gradients still
reach ``args`` through ``W`` under the discrete adjoint.  It is
``torch.func.jacrev`` where the JAX package runs ``jax.jacfwd``: the same
dense matrix, at a quarter of the host time, because PyTorch's forward mode
gives every operation with a constant operand (``2.0 * y``) a zero tangent
whose arithmetic runs through Python reference decompositions (FENE-P
residual, CPU: 6.8 ms for ``jacfwd``, 1.6 ms for ``jacrev``, 0.16 ms for one
evaluation).  ``torch.func.jacrev`` refuses the saved-tensor hooks of
``torch.utils.checkpoint``, so the solvers carry ``reverse_jacobian`` and the
discrete adjoint does not checkpoint their attempts.  It composes with
autograd, ``torch.func.jacfwd`` (``ForwardSensitivity``) and
``torch.func.vmap``.  The factorization is ``torch.linalg.lu_factor_ex``, which
neither checks its ``info`` on the host (no device sync) nor raises on an
exactly singular ``W``: the solves then give inf/NaN, as
``jax.scipy.linalg.lu_factor`` does, and the step controller rejects the
attempt.  ``_factor`` and ``_newton_stage`` are shared with
``solvers/esdirk.py`` and ``solvers/rosenbrock.py``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

__all__ = ["SDIRK3"]


def _gamma():
    # root of x^3 - 3x^2 + 1.5x - 1/6 in (1/6, 1/2), by Newton in f64 host
    g = 0.44
    for _ in range(60):
        fval = g**3 - 3.0 * g**2 + 1.5 * g - 1.0 / 6.0
        dval = 3.0 * g**2 - 6.0 * g + 1.5
        g_new = g - fval / dval
        if abs(g_new - g) < 1e-17:
            return g_new
        g = g_new
    return g


_G = _gamma()
_C = (_G, (1.0 + _G) / 2.0, 1.0)
_A21 = (1.0 - _G) / 2.0
_B = (-1.5 * _G**2 + 4.0 * _G - 0.25, 1.5 * _G**2 - 5.0 * _G + 1.25, _G)
# embedded order-2 weights with b̂₃ = 0: Σb̂ = 1, Σb̂c = 1/2
_BH2 = (1.0 - 2.0 * _G) / (1.0 - _G)
_BH = (1.0 - _BH2, _BH2, 0.0)

_NEWTON_ITERS = 6


def _jacobian(f, t, y, args):
    """``∂f/∂y`` at ``(t, y)``, dense ``(n, n)``."""
    return torch.func.jacrev(lambda yy: f(t, yy, args))(y)


def _factor(W):
    """The solve ``b ↦ W⁻¹ b`` on one LU factorization of ``W``."""
    lu, piv, _ = torch.linalg.lu_factor_ex(W)
    return lambda b: torch.linalg.lu_solve(lu, piv, b.unsqueeze(-1)).squeeze(-1)


def _iteration_matrix(f, t, y, dt, g, args):
    """The solve on ``I - (dt·g)·J``, the matrix every implicit stage shares."""
    J = _jacobian(f, t, y, args)
    n = y.shape[0]
    return _factor(torch.eye(n, dtype=y.dtype, device=y.device) - (dt * g) * J)


def _newton_stage(f, solve, t_i, base, k_init, dt, g, args):
    """Solve ``k = f(t_i, base + γ·dt·k)`` by 6 modified-Newton iterations."""
    k = k_init
    dtg = dt * g
    for _ in range(_NEWTON_ITERS):
        r = k - f(t_i, base + dtg * k, args)
        k = k - solve(r)
    return k


@dataclasses.dataclass(frozen=True)
class SDIRK3:
    """Alexander's L-stable, stiffly-accurate 3-stage SDIRK of order 3."""

    reverse_jacobian: ClassVar[bool] = True
    order: int = dataclasses.field(default=3, init=False)
    error_order: int = dataclasses.field(default=3, init=False)

    @property
    def name(self):
        return "SDIRK3"

    def step(self, f, t, y, f0, dt, args):
        solve = _iteration_matrix(f, t, y, dt, _G, args)

        def stage(t_i, base, k_init):
            return _newton_stage(f, solve, t_i, base, k_init, dt, _G, args)

        k1 = stage(t + _C[0] * dt, y, f0)
        k2 = stage(t + _C[1] * dt, y + dt * _A21 * k1, k1)
        k3 = stage(t + dt, y + dt * (_B[0] * k1 + _B[1] * k2), k2)
        y1 = y + dt * (_B[0] * k1 + _B[1] * k2 + _B[2] * k3)
        y_err = dt * (
            (_B[0] - _BH[0]) * k1 + (_B[1] - _BH[1]) * k2 + (_B[2] - _BH[2]) * k3
        )
        # stiff accuracy: k3 = f(t+dt, y1) at Newton convergence
        nfe = 3 * _NEWTON_ITERS
        return y1, y_err, k3, nfe
