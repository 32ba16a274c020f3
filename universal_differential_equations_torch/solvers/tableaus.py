"""Butcher tableaus for the explicit Runge-Kutta family: Tsit5, Dopri5, Bosh3,
Vern7, Euler and Heun.

A verbatim copy of the tables in
``universal_differential_equations_tpu/solvers/tableaus.py``.  The JAX file
itself imports no JAX, but importing it through its package runs that
package's ``__init__``, which imports ``jax``; the port must not.  CPU tests
(``tests/test_torch_solve.py``, ``tests/test_torch_surface.py``) check the
tables are equal digit for digit.

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

# ---------------------------------------------------------------------------
# Dormand–Prince 5(4) ("RK45").  FSAL.
# ---------------------------------------------------------------------------
_DOPRI5 = ButcherTableau(
    name="Dopri5",
    order=5,
    error_order=5,
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_err=(
        35 / 384 - 5179 / 57600,
        0.0,
        500 / 1113 - 7571 / 16695,
        125 / 192 - 393 / 640,
        -2187 / 6784 + 92097 / 339200,
        11 / 84 - 187 / 2100,
        -1 / 40,
    ),
    fsal=True,
)

# ---------------------------------------------------------------------------
# Bogacki–Shampine 3(2).  FSAL.
# ---------------------------------------------------------------------------
_BOSH3 = ButcherTableau(
    name="Bosh3",
    order=3,
    error_order=3,
    c=(0.0, 1 / 2, 3 / 4, 1.0),
    a=((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    b=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_err=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    fsal=True,
)

# ---------------------------------------------------------------------------
# Verner-style "most efficient" 7(6) pair — the reference's Vern7 role:
# 1e-12-tolerance truth generation (``scenario_1.jl:41``).  Not FSAL.
# Coefficients certified by directly solving the full order-condition system
# (all 85 rooted-tree conditions for b at order 7, all 37 for the embedded
# 6th-order b_err companion, plus non-autonomous consistency c = A·1) to a
# residual of 9e-15 — see tools/derive_tableaus.py.  Order re-checked
# empirically in tests/test_solver_convergence.py.
# ---------------------------------------------------------------------------
_VERN7 = ButcherTableau(
    name="Vern7",
    order=7,
    error_order=7,
    c=(
        0.0,
        0.005,
        0.10888888888888903,
        0.16333333333333333,
        0.4555,
        0.609509448997837,
        0.884,
        0.925,
        1.0,
        1.0,
    ),
    a=(
        (),
        (0.005,),
        (-1.076790123456801, 1.18567901234569),
        (0.04083333333333167, 0.0, 0.12250000000000166),
        (0.6389139236256121, 0.0, -2.4556726382237826, 2.2722587145981707),
        (
            -2.6615773750225533,
            0.0,
            10.804513886470994,
            -8.353914657407904,
            0.8204875949572996,
        ),
        (
            6.067741434710549,
            0.0,
            -24.711273635966275,
            20.42751793083305,
            -1.9061579788196872,
            1.0061722492423653,
        ),
        (
            12.054670076280276,
            0.0,
            -49.75478495057776,
            41.142888638691815,
            -4.4617601499798445,
            2.042334822239497,
            -0.09834843665398443,
        ),
        (
            10.138146522915598,
            0.0,
            -42.64113603185584,
            35.76384004003483,
            -4.348022840402217,
            2.009862268378625,
            0.34874904603396045,
            -0.27143900510496327,
        ),
        (
            -45.03007203439894,
            0.0,
            187.32724376586148,
            -154.0288236938242,
            18.564653063496642,
            -7.141809679296019,
            1.3088085781610208,
            0.0,
            0.0,
        ),
    ),
    b=(
        0.047155618486278965,
        0.0,
        0.0,
        0.2575056429843211,
        0.2621665397741882,
        0.15216092656730212,
        0.4939969170035218,
        -0.29430311714060786,
        0.08131747232499571,
        0.0,
    ),
    b_err=(
        0.002547011879937708,
        0.0,
        0.0,
        -0.009658394872816722,
        0.04206470975646179,
        -0.06668224374701659,
        0.2650097464624077,
        -0.29430311714060786,
        0.08131747232499571,
        -0.02029518466336179,
    ),
    fsal=False,
)

# ---------------------------------------------------------------------------
# Fixed-step helpers (also used by the SDE drift and shooting warmups).
# ---------------------------------------------------------------------------
_EULER = ButcherTableau(
    name="Euler", order=1, error_order=2, c=(0.0,), a=((),), b=(1.0,), b_err=(0.0,)
)
_HEUN = ButcherTableau(
    name="Heun",
    order=2,
    error_order=2,
    c=(0.0, 1.0),
    a=((), (1.0,)),
    b=(0.5, 0.5),
    b_err=(-0.5, 0.5),
)

TABLEAUS = {
    t.name: t for t in (_TSIT5, _DOPRI5, _BOSH3, _VERN7, _EULER, _HEUN)
}
