"""Kvaerno3 / SDIRK4: higher-order L-stable DIRK stiff solvers.

Port of ``universal_differential_equations_tpu/solvers/esdirk.py``:

- ``Kvaerno3`` — Kvaerno (BIT 44, 2004): 4-stage ESDIRK, explicit first
  stage (it reuses the incoming ``f0``), stiffly accurate, L-stable, order 3
  with an embedded order-2 companion.  Its coefficients are derived at
  import from the order conditions, with γ from ``sdirk._gamma`` (the same
  constant SDIRK3 uses):

      c = (0, 2γ, 1, 1),  a₃₂ = (1/2 − γ)/(2γ),  a₃₁ = 1 − γ − a₃₂,
      b₂ = 1/(12γ(1 − 2γ)),  b₃ = 1/3 − γ − 4γ²b₂,  b₁ = 1 − γ − b₂ − b₃,
      b̂ = (a₃₁, a₃₂, γ, 0)                       (the 3rd-stage row).

- ``SDIRK4`` — Hairer & Wanner II, Table 6.5 (γ = 1/4): 5-stage SDIRK,
  L-stable, stiffly accurate, order 4 with an embedded order-3 companion;
  every coefficient an exact rational, copied digit for digit.

Every implicit stage solves ``k = f(tᵢ, y + dt·Σaᵢⱼkⱼ)`` by 6 modified-Newton
iterations on one ``I − γ·dt·J`` LU factorization (``sdirk._iteration_matrix``:
``torch.func.jacrev`` and ``torch.linalg.lu_factor_ex``).  ``nfe`` counts
``1 + 6`` per implicit stage, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from .sdirk import _NEWTON_ITERS, _gamma, _iteration_matrix, _newton_stage

__all__ = ["Kvaerno3", "SDIRK4"]


def _kvaerno3_tableau():
    g = _gamma()
    a32 = (0.5 - g) / (2.0 * g)
    a31 = 1.0 - g - a32
    b2 = 1.0 / (12.0 * g * (1.0 - 2.0 * g))
    b3 = 1.0 / 3.0 - g - 4.0 * g * g * b2
    b1 = 1.0 - g - b2 - b3
    A = (
        (0.0, 0.0, 0.0, 0.0),
        (g, g, 0.0, 0.0),
        (a31, a32, g, 0.0),
        (b1, b2, b3, g),
    )
    b = (b1, b2, b3, g)
    bh = (a31, a32, g, 0.0)
    c = (0.0, 2.0 * g, 1.0, 1.0)
    return g, A, b, bh, c


_K3_G, _K3_A, _K3_B, _K3_BH, _K3_C = _kvaerno3_tableau()

# Hairer & Wanner II Table 6.5, γ = 1/4 (exact rationals)
_S4_G = 0.25
_S4_A = (
    (0.25, 0.0, 0.0, 0.0, 0.0),
    (0.5, 0.25, 0.0, 0.0, 0.0),
    (17.0 / 50.0, -1.0 / 25.0, 0.25, 0.0, 0.0),
    (371.0 / 1360.0, -137.0 / 2720.0, 15.0 / 544.0, 0.25, 0.0),
    (25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, 0.25),
)
_S4_B = _S4_A[4]
_S4_BH = (59.0 / 48.0, -17.0 / 96.0, 225.0 / 32.0, -85.0 / 12.0, 0.0)
_S4_C = (0.25, 0.75, 11.0 / 20.0, 0.5, 1.0)


def _dirk_step(A, b, bh, c, gamma, explicit_first, f, t, y, f0, dt, args):
    """One adaptive DIRK step on one shared ``I - γ·dt·J`` factorization."""
    solve = _iteration_matrix(f, t, y, dt, gamma, args)

    s = len(b)
    ks = []
    nfe = 1  # the Jacobian's primal eval, counted as the JAX package counts it
    for i in range(s):
        base = y
        for j, k_j in enumerate(ks):
            a_ij = A[i][j]
            if a_ij != 0.0:
                base = base + (dt * a_ij) * k_j
        if i == 0 and explicit_first:
            ks.append(f0)  # ESDIRK: first stage is the incoming derivative
            continue
        k_init = ks[-1] if ks else f0
        ks.append(_newton_stage(f, solve, t + c[i] * dt, base, k_init, dt, gamma, args))
        nfe += _NEWTON_ITERS

    y1 = y
    y_err = torch.zeros_like(y)
    for i in range(s):
        if b[i] != 0.0:
            y1 = y1 + (dt * b[i]) * ks[i]
        d = b[i] - bh[i]
        if d != 0.0:
            y_err = y_err + (dt * d) * ks[i]
    # stiff accuracy: k_s = f(t+dt, y1) at Newton convergence
    return y1, y_err, ks[-1], nfe


@dataclasses.dataclass(frozen=True)
class Kvaerno3:
    """Kvaerno (2004) 4-stage ESDIRK: L-stable, stiffly accurate, order 3.

    The explicit first stage reuses ``f0``: one implicit solve per step
    fewer than :class:`~.sdirk.SDIRK3` at the same order.
    """

    reverse_jacobian: ClassVar[bool] = True
    order: int = dataclasses.field(default=3, init=False)
    error_order: int = dataclasses.field(default=3, init=False)

    @property
    def name(self):
        return "Kvaerno3"

    def step(self, f, t, y, f0, dt, args):
        return _dirk_step(
            _K3_A, _K3_B, _K3_BH, _K3_C, _K3_G, True, f, t, y, f0, dt, args
        )


@dataclasses.dataclass(frozen=True)
class SDIRK4:
    """Hairer-Wanner 5-stage SDIRK (γ=1/4): L-stable, stiffly accurate,
    order 4 with an embedded order-3 error estimate — the high-order
    implicit option for tight-tolerance stiff solves (FENE-P truth runs)."""

    reverse_jacobian: ClassVar[bool] = True
    order: int = dataclasses.field(default=4, init=False)
    error_order: int = dataclasses.field(default=4, init=False)

    @property
    def name(self):
        return "SDIRK4"

    def step(self, f, t, y, f0, dt, args):
        return _dirk_step(
            _S4_A, _S4_B, _S4_BH, _S4_C, _S4_G, False, f, t, y, f0, dt, args
        )
