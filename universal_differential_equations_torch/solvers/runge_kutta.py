"""Explicit Runge-Kutta solvers as static step objects (slice A: Tsit5).

Port of ``universal_differential_equations_tpu/solvers/runge_kutta.py``.  The
stage loop is unrolled in Python over the tableau's static coefficients; every
stage combination is a scalar-weighted tensor sum.  All solvers share one
interface so the adaptive drivers in ``core/integrate.py`` are
solver-agnostic:

    y1, y_err, f1, nfe = solver.step(f, t, y, f0, dt, args)

where ``f0 = f(t, y, args)`` is carried between steps (free for FSAL methods).
"""
from __future__ import annotations

import dataclasses

from .tableaus import TABLEAUS, ButcherTableau

__all__ = ["AbstractERK", "Tsit5"]


@dataclasses.dataclass(frozen=True)
class AbstractERK:
    """Adaptive embedded explicit RK method defined by a Butcher tableau."""

    tableau: ButcherTableau

    @property
    def order(self):
        return self.tableau.order

    @property
    def error_order(self):
        return self.tableau.error_order

    @property
    def dense_nodes(self):
        """Hermite-window size for order-matched dense output: ``m`` step
        points give a degree-``2m−1`` interpolant, ``m = ceil((order+1)/2)``
        (quintic for Tsit5)."""
        return min(4, max(2, (self.tableau.order + 2) // 2))

    def step(self, f, t, y, f0, dt, args):
        """One attempted step of size ``dt`` (a 0-d tensor) from ``(t, y)``.

        Returns ``(y1, y_err, f1, nfe)`` where ``f1 = f(t+dt, y1, args)``
        (free for FSAL tableaus) and ``nfe`` is the number of fresh RHS
        evaluations (excluding the carried ``f0``).
        """
        tab = self.tableau
        ks = [f0]
        for i in range(1, tab.num_stages):
            yi = y
            for j, aij in enumerate(tab.a[i]):
                if aij != 0.0:
                    yi = yi + (dt * aij) * ks[j]
            ks.append(f(t + tab.c[i] * dt, yi, args))
        y1 = y
        for j, bj in enumerate(tab.b):
            if bj != 0.0:
                y1 = y1 + (dt * bj) * ks[j]
        y_err = None
        for j, ej in enumerate(tab.b_err):
            if ej != 0.0:
                contrib = (dt * ej) * ks[j]
                y_err = contrib if y_err is None else y_err + contrib
        if y_err is None:  # fixed-step tableaus have a zero estimator
            y_err = y1 - y1
        if tab.fsal:
            f1 = ks[-1]
            nfe = tab.num_stages - 1
        else:
            f1 = f(t + dt, y1, args)
            nfe = tab.num_stages
        return y1, y_err, f1, nfe


@dataclasses.dataclass(frozen=True, init=False)
class Tsit5(AbstractERK):
    """Tsitouras 5(4) — the reference's workhorse (``scenario_1.jl:191``)."""

    def __init__(self):
        AbstractERK.__init__(self, TABLEAUS["Tsit5"])
