"""Adaptive step-size control (PI controller + Hairer initial-dt heuristic).

Port of ``universal_differential_equations_tpu/core/controller.py``.  Pure
0-d tensor arithmetic on the state's device: no value leaves the device, so
the stepping loop never waits on the host to decide a step.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PIController", "hairer_norm", "initial_step_size"]


def hairer_norm(err, y0, y1, rtol, atol, weights=None):
    """Scaled RMS error norm: sqrt(mean((err / (atol + rtol*max|y|))^2)).

    ``weights`` (optional, same shape as the state) turns this into a
    *seminorm*: components with weight 0 are excluded from step control.  The
    continuous adjoints use it to drop the passively integrated
    parameter-quadrature rows from the backward error test (arXiv:2009.09457).
    """
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    ratio = err / scale
    if weights is None:
        norm = torch.sqrt(torch.mean(ratio * ratio))
    else:
        w = weights.to(ratio.dtype)
        norm = torch.sqrt(torch.sum(w * ratio * ratio) / torch.clamp(w.sum(), min=1.0))
    # non-finite errors (NaN blowups) map to a huge-but-finite value so the
    # controller rejects and shrinks instead of poisoning dt with NaN
    return torch.where(torch.isfinite(norm), norm, torch.full_like(norm, 1e10))


@dataclasses.dataclass(frozen=True)
class PIController:
    """Proportional–integral step controller (Hairer & Wanner II.4).

    On acceptance: ``dt *= clip(safety * err^-alpha * err_prev^beta)`` with
    ``alpha = 1/k - 0.75*beta``, ``beta = 0.4/k``, ``k`` the solver's error
    order.  On rejection: pure P shrink, capped at factor 1.
    """

    safety: float = 0.9
    factor_min: float = 0.2
    factor_max: float = 10.0
    err_floor: float = 1e-10
    err_prev_init: float = 1e-4

    def next_dt(self, dt, err, err_prev, accept, error_order):
        k = float(error_order)
        beta = 0.4 / k
        alpha = 1.0 / k - 0.75 * beta
        e = torch.clamp(err, min=self.err_floor)
        fac_acc = torch.clamp(
            self.safety * e ** (-alpha) * err_prev**beta,
            self.factor_min,
            self.factor_max,
        )
        fac_rej = torch.clamp(self.safety * e ** (-1.0 / k), self.factor_min, 1.0)
        factor = torch.where(accept, fac_acc, fac_rej)
        err_prev_new = torch.where(
            accept, torch.clamp(err, min=self.err_prev_init), err_prev)
        return dt * factor, err_prev_new


def initial_step_size(f, t0, y0, f0, error_order, rtol, atol, args):
    """Hairer's automatic initial step selection (Hairer I.II.4, HINIT)."""
    scale = atol + rtol * y0.abs()
    d0 = torch.sqrt(torch.mean((y0 / scale) ** 2))
    d1 = torch.sqrt(torch.mean((f0 / scale) ** 2))
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp(d1, min=1e-30))
    y1 = y0 + h0 * f0
    f1 = f(t0 + h0, y1, args)
    d2 = torch.sqrt(torch.mean(((f1 - f0) / scale) ** 2)) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(
        dmax <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.clamp(dmax, min=1e-30)) ** (1.0 / float(error_order)),
    )
    return torch.minimum(100.0 * h0, h1)
