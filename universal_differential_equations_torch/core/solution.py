"""Solution containers and dense output.

Port of ``universal_differential_equations_tpu/core/solution.py``.  Dense
output is a buffer of accepted steps ``(t_i, y_i, f_i)`` followed by ``+inf``
time slots, with order-matched Hermite interpolation between them: ``nodes``
stored step points enter a Hermite–Birkhoff window of degree ``2·nodes − 1``
(quintic for Tsit5).  Where JAX ``vmap``s a scalar evaluator over the query
times, this module evaluates a vector of query times directly: every gather
and polynomial term carries a leading query dimension.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

__all__ = ["DenseInterpolation", "Solution"]


@dataclasses.dataclass(frozen=True)
class DenseInterpolation:
    """Hermite dense output over the accepted-step grid.

    ``num_points`` (a 0-d integer tensor) gives the number of valid entries;
    entries past it hold ``t = +inf`` so that ``searchsorted`` lands queries
    in the last valid interval.  ``nodes`` sets the interpolation window; a
    solve with fewer than ``nodes`` stored points falls back to the cubic.
    """

    ts: torch.Tensor  # (cap,)
    ys: torch.Tensor  # (cap, dim)
    fs: torch.Tensor  # (cap, dim)  RHS values at ts
    num_points: torch.Tensor  # 0-d int
    direction: torch.Tensor  # 0-d, +1.0 or -1.0
    nodes: int = 2

    def _interval(self, t):
        """Interval index for each internal (direction-scaled) time in ``t``."""
        cap = self.ts.shape[0]
        hi = torch.clamp(self.num_points - 1, 1, cap - 1)
        idx = torch.searchsorted(self.ts, t, right=True) - 1
        return torch.minimum(torch.clamp(idx, min=0), hi - 1)

    def _cubic(self, i, t, derivative: bool):
        """Cubic Hermite on intervals ``[ts[i], ts[i+1]]`` at times ``t``."""
        t0, t1 = self.ts[i], self.ts[i + 1]
        y0, y1 = self.ys[i], self.ys[i + 1]
        f0, f1 = self.fs[i], self.fs[i + 1]
        # Degenerate intervals: a zero-step solve pairs the initial point
        # with an untouched +inf buffer slot — guard h == 0 AND h == inf or
        # the f-weighted terms produce 0·inf = NaN at s = 0.
        h = t1 - t0
        h = torch.where(torch.isfinite(h) & (h != 0), h, torch.ones_like(h))
        s = ((t - t0) / h)[:, None]
        h = h[:, None]
        if not derivative:
            h00 = (1 + 2 * s) * (1 - s) ** 2
            h10 = s * (1 - s) ** 2
            h01 = s * s * (3 - 2 * s)
            h11 = s * s * (s - 1)
            return h00 * y0 + (h10 * f0 + h11 * f1) * h + h01 * y1
        dh00 = 6 * s * (s - 1) / h
        dh10 = (3 * s * s - 4 * s + 1) / h
        dh01 = -6 * s * (s - 1) / h
        dh11 = (3 * s * s - 2 * s) / h
        val = dh00 * y0 + (dh10 * f0 + dh11 * f1) * h + dh01 * y1
        return val * self.direction

    def _windowed(self, i, t, derivative: bool):
        """Degree-``2m−1`` Hermite–Birkhoff window around intervals ``i``.

        Newton divided differences over the doubled node sequence
        ``[t_w, t_w, t_{w+1}, t_{w+1}, …]``; adjacent intervals share their
        knot's data, so value and slope stay continuous across knots.
        """
        m = self.nodes
        cap = self.ts.shape[0]
        n = self.num_points
        ok = n >= m
        w = torch.minimum(torch.clamp(i - (m - 2) // 2, min=0),
                          torch.clamp(n - m, min=0))
        idx = torch.clamp(w[:, None] + torch.arange(m, device=w.device), 0, cap - 1)
        tn = self.ts[idx]  # (T, m)
        # Short solves (n < m) divert to the cubic; distinct dummy nodes keep
        # the untaken divided differences finite (no inf − inf).
        tn = torch.where(ok, tn, torch.arange(m, dtype=tn.dtype, device=tn.device))
        yn = torch.where(ok, self.ys[idx], 0.0)  # (T, m, dim)
        fn = torch.where(ok, self.fs[idx], 0.0)

        z = [tn[:, k // 2] for k in range(2 * m)]
        col = []
        for j in range(2 * m - 1):
            k = j // 2
            if j % 2 == 0:
                col.append(fn[:, k])
            else:
                col.append((yn[:, k + 1] - yn[:, k]) / (tn[:, k + 1] - tn[:, k])[:, None])
        coeffs = [yn[:, 0], col[0]]
        for r in range(2, 2 * m):
            col = [
                (col[j + 1] - col[j]) / (z[j + r] - z[j])[:, None]
                for j in range(2 * m - r)
            ]
            coeffs.append(col[0])

        # Horner evaluation of the Newton form with analytic derivative.
        p = coeffs[-1]
        dp = torch.zeros_like(p)
        for k in range(2 * m - 2, -1, -1):
            dt = (t - z[k])[:, None]
            dp = dp * dt + p
            p = coeffs[k] + p * dt
        if derivative:
            return dp * self.direction, ok
        return p, ok

    def _hermite(self, t, derivative: bool):
        t = t * self.direction
        # Clamp to the covered range: a truncated solve holds its last valid
        # state instead of extrapolating the local polynomial.
        cap = self.ts.shape[0]
        # a 1-element index: under vmap of grad a 0-d index tensor is read
        # back as a Python int, which vmap refuses
        last = self.ts[torch.clamp(self.num_points - 1, 0, cap - 1).reshape(1)]
        t = torch.minimum(torch.maximum(t, self.ts[0]), last)
        i = self._interval(t)
        if self.nodes <= 2:
            return self._cubic(i, t, derivative)
        win, ok = self._windowed(i, t, derivative)
        return torch.where(ok, win, self._cubic(i, t, derivative))

    def _eval(self, t, derivative: bool):
        t = torch.as_tensor(t, dtype=self.ts.dtype, device=self.ts.device)
        if t.ndim == 0:
            return self._hermite(t.reshape(1), derivative)[0]
        return self._hermite(t, derivative)

    def evaluate(self, t):
        """y(t) for a scalar or 1-D ``t``."""
        return self._eval(t, derivative=False)

    def derivative(self, t):
        """dy/dt(t) — the reference's ``sol(t, Val{1})``."""
        return self._eval(t, derivative=True)

    def __call__(self, t, nu: int = 0):
        if nu == 0:
            return self.evaluate(t)
        if nu == 1:
            return self.derivative(t)
        raise ValueError("only nu in (0, 1) supported")


@dataclasses.dataclass(frozen=True)
class Solution:
    """Result of ``solve``.

    ``ts``/``ys`` are the ``saveat`` grid (or the ``(t0, t1)`` endpoints).
    ``success`` is False where the integrator hit ``max_steps`` or a dt
    underflow.  ``error_sum`` is the differentiable Σ of tolerance-normalized
    local error norms over step attempts, populated on the bounded-scan paths
    (``DiscreteAdjoint``/``ForwardSensitivity``) and None elsewhere.
    """

    ts: torch.Tensor
    ys: Any
    t_final: torch.Tensor
    y_final: Any
    success: torch.Tensor
    num_accepted: torch.Tensor
    num_rejected: torch.Tensor
    num_rhs_evals: torch.Tensor
    dense: Optional[DenseInterpolation] = None
    error_sum: Optional[torch.Tensor] = None
    _unravel: Optional[Callable] = None

    def __call__(self, t, nu: int = 0):
        if self.dense is None:
            raise ValueError("solve(..., dense=True) required for interpolation")
        flat = self.dense(t, nu)
        if self._unravel is None:
            return flat
        return self._unravel(flat)
