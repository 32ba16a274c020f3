"""Sensitivity algorithms, part 1: differentiating through ``solve``.

Port of ``universal_differential_equations_tpu/adjoint/sensitivity.py:61-124``:

* ``NoAdjoint`` — forward-only solve (truth generation at tight tolerances).
* ``DiscreteAdjoint`` — autograd straight through the bounded stepping loop
  (the analogue of Tracker's ``diffeq_rd`` discrete adjoint, C10).
* ``ForwardSensitivity`` — the same loop for forward mode
  (``ForwardDiffSensitivity``, C7): use it under ``torch.func.jacfwd`` /
  ``torch.func.jvp``, as the LM trainer does.

The continuous adjoints (interpolating, backsolve, quadrature) are not
ported yet.
"""
from __future__ import annotations

import dataclasses

from ..core.integrate import integrate_scan, integrate_while

__all__ = ["AbstractAdjoint", "NoAdjoint", "DiscreteAdjoint", "ForwardSensitivity"]


class AbstractAdjoint:
    default_max_steps: int = 4096

    def run(self, f, y0, t0, t1, args, ts_save, solver, controller, rtol, atol,
            dt0, max_steps, tstops=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NoAdjoint(AbstractAdjoint):
    """Forward-only solve. Fastest; gradients unavailable."""

    default_max_steps: int = 4096

    def run(self, f, y0, t0, t1, args, ts_save, solver, controller, rtol, atol,
            dt0, max_steps, tstops=None):
        res = integrate_while(
            f, y0, t0, t1, args, solver, rtol, atol, dt0, max_steps, controller,
            tstops,
        )
        return res.dense.evaluate(ts_save), res


@dataclasses.dataclass(frozen=True)
class DiscreteAdjoint(AbstractAdjoint):
    """Reverse/forward AD straight through the bounded stepping loop.

    ``checkpoint=True`` recomputes each attempt in the backward pass,
    keeping reverse-mode memory at one state per step instead of all RK
    stages.

    Caveat (as in the JAX package): if a *rejected* attempt overflows to
    inf/NaN, the backward pass still differentiates that attempt, and the
    masked zero cotangent times a NaN partial is NaN.
    """

    checkpoint: bool = True
    default_max_steps: int = 512

    def run(self, f, y0, t0, t1, args, ts_save, solver, controller, rtol, atol,
            dt0, max_steps, tstops=None):
        res = integrate_scan(
            f, y0, t0, t1, args, solver, rtol, atol, dt0, max_steps, controller,
            checkpoint=self.checkpoint, tstops=tstops,
        )
        return res.dense.evaluate(ts_save), res


@dataclasses.dataclass(frozen=True)
class ForwardSensitivity(DiscreteAdjoint):
    """Forward-mode sensitivity: the ``DiscreteAdjoint`` loop without
    per-step recomputation (it buys nothing in forward mode)."""

    checkpoint: bool = False
