"""Butcher tableaus for the explicit Runge-Kutta family (slice A: Tsit5).

A verbatim copy of the Tsit5 table in
``universal_differential_equations_tpu/solvers/tableaus.py``.  The JAX file
itself imports no JAX, but importing it through its package runs that
package's ``__init__``, which imports ``jax``; the port must not.  A CPU test
(``tests/test_torch_solve.py``) checks the two tables are equal digit for
digit.

A tableau is a static (hashable) container of Python float tuples; the RK
stepper reads its coefficients as Python scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ButcherTableau", "TABLEAUS"]


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    name: str
    order: int  # order of the propagated solution
    error_order: int  # order of the embedded error estimator + 1 (controller k)
    c: Tuple[float, ...]
    a: Tuple[Tuple[float, ...], ...]  # a[i] has i entries (strictly lower tri)
    b: Tuple[float, ...]
    b_err: Tuple[float, ...]  # b - b_hat: weights of the error estimate
    fsal: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.b)


# ---------------------------------------------------------------------------
# Tsitouras 5(4) — "Runge–Kutta pairs of order 5(4) satisfying only the first
# column simplifying assumption", C. Tsitouras, 2011.  FSAL.
# ---------------------------------------------------------------------------
_TSIT5 = ButcherTableau(
    name="Tsit5",
    order=5,
    error_order=5,
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    a=(
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (
            5.325864828439257,
            -11.748883564062828,
            7.4955393428898365,
            -0.09249506636175525,
        ),
        (
            5.86145544294642,
            -12.92096931784711,
            8.159367898576159,
            -0.071584973281401,
            -0.028269050394068383,
        ),
        (
            0.09646076681806523,
            0.01,
            0.4798896504144996,
            1.379008574103742,
            -3.290069515436081,
            2.324710524099774,
        ),
    ),
    b=(
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ),
    b_err=(
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    ),
    fsal=True,
)

TABLEAUS = {"Tsit5": _TSIT5}
