"""Explicit Runge-Kutta solvers as static step objects: Tsit5, Vern7, Dopri5,
Bosh3, Euler and Heun.

Port of ``universal_differential_equations_tpu/solvers/runge_kutta.py``.  The
stage loop is unrolled in Python over the tableau's static coefficients; every
stage combination is a scalar-weighted tensor sum.  All solvers share one
interface so the adaptive drivers in ``core/integrate.py`` are
solver-agnostic:

    y1, y_err, f1, nfe = solver.step(f, t, y, f0, dt, args)

where ``f0 = f(t, y, args)`` is carried between steps (free for FSAL methods).
A non-FSAL tableau (Vern7, Euler, Heun) pays one more RHS evaluation per attempt for
``f1`` and counts it in ``nfe``.
"""
from __future__ import annotations

import dataclasses

from .tableaus import TABLEAUS, ButcherTableau

__all__ = ["AbstractERK", "Tsit5", "Vern7", "Dopri5", "Bosh3", "Euler", "Heun"]


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
    def name(self):
        return self.tableau.name

    @property
    def dense_nodes(self):
        """Hermite-window size for order-matched dense output: ``m`` step
        points give a degree-``2m−1`` interpolant, ``m = ceil((order+1)/2)``
        (quintic for Tsit5, septic for Vern7)."""
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


def _make(name, doc):
    def __init__(self):
        AbstractERK.__init__(self, TABLEAUS[name])

    cls = type(name, (AbstractERK,), {"__init__": __init__, "__doc__": doc})
    return dataclasses.dataclass(frozen=True, init=False)(cls)


Tsit5 = _make("Tsit5", "Tsitouras 5(4) — the reference's workhorse (``scenario_1.jl:191``).")
Vern7 = _make("Vern7", "Verner 'most efficient' 7(6), not FSAL — truth generation at 1e-12 "
              "tolerances (``scenario_1.jl:41``).")
Dopri5 = _make("Dopri5", "Dormand–Prince 5(4).")
Bosh3 = _make("Bosh3", "Bogacki–Shampine 3(2).")
Euler = _make("Euler", "Explicit Euler (fixed-step use only).")
Heun = _make("Heun", "Heun 2(1) trapezoidal.")
