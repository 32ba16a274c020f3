"""Stabilized explicit solvers for mildly stiff (parabolic, method-of-lines)
systems: the Runge-Kutta-Chebyshev family.

Port of ``universal_differential_equations_tpu/solvers/rkc.py``.  An
``s``-stage first- or second-order method whose stability interval along the
negative real axis grows like O(s²), so diffusion operators integrate with
steps far beyond the classic RK bounds, Jacobian-free (Sommeijer, Shampine &
Verwer 1998).  The recurrence coefficients are closed-form Chebyshev
expressions in Python floats; they are computed once per configuration
(``stages``, ``damping``) and cached, so an eager ``step`` is the bare
three-term recurrence.

``rho`` is the spectral-radius bound (the reference's ``eigen_est`` hook;
``models/climate_npde.eigen_est`` estimates it).  ``dt_stab`` is the step
the stability interval allows; the adaptive drivers cap every attempt there.
``RKC2.for_problem(rho, tspan, n_steps_hint)`` picks the stage count.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

__all__ = ["RKC1", "RKC2"]


def _cheb_table(s: int, w0: float):
    """T_j(w0), T_j'(w0), T_j''(w0) for j = 0..s (float64 host arithmetic)."""
    T = [1.0, w0]
    dT = [0.0, 1.0]
    ddT = [0.0, 0.0]
    for j in range(2, s + 1):
        T.append(2.0 * w0 * T[-1] - T[-2])
        dT.append(2.0 * T[j - 1] + 2.0 * w0 * dT[j - 1] - dT[j - 2])
        ddT.append(4.0 * dT[j - 1] + 2.0 * w0 * ddT[j - 1] - ddT[j - 2])
    return T, dT, ddT


@functools.lru_cache(maxsize=None)
def _rkc2_coeffs(s: int, eps: float):
    w0 = 1.0 + eps / (s * s)
    T, dT, ddT = _cheb_table(s, w0)
    w1 = dT[s] / ddT[s]
    b = [0.0] * (s + 1)
    for j in range(2, s + 1):
        b[j] = ddT[j] / (dT[j] ** 2)
    b[0] = b[1] = b[2]
    return w0, w1, tuple(T), tuple(dT), tuple(ddT), tuple(b)


@functools.lru_cache(maxsize=None)
def _rkc1_coeffs(s: int, eps: float):
    w0 = 1.0 + eps / (s * s)
    T, dT, _ = _cheb_table(s, w0)
    return w0, tuple(T), tuple(dT)


@dataclasses.dataclass(frozen=True)
class RKC2:
    """Second-order Runge-Kutta-Chebyshev with ``s`` internal stages.

    Stability along the negative real axis ≈ 0.653·s² (with the standard 2/13
    damping), so ``dt_stab = 0.653 s² / rho``.  The adaptive driver caps steps
    at ``dt_stab``; the embedded Sommeijer-Shampine estimate controls accuracy
    below that.
    """

    stages: int = 16
    rho: Optional[float] = None  # spectral-radius bound (the eigen_est hook)
    damping: float = 2.0 / 13.0

    order: int = dataclasses.field(default=2, init=False)
    error_order: int = dataclasses.field(default=3, init=False)

    @property
    def name(self):
        return f"RKC2(s={self.stages})"

    @property
    def dt_stab(self):
        if self.rho is None:
            return None
        # conservative damped stability interval β(s) ≈ 0.653·s² (SSV98)
        return 0.653 * self.stages**2 / self.rho

    @staticmethod
    def for_problem(rho: float, tspan: Tuple[float, float], n_steps_hint: int = 50,
                    max_stages: int = 128) -> "RKC2":
        """Pick a stage count so one stability-limited step covers roughly
        ``(t1-t0)/n_steps_hint`` (the stage count is fixed per solver, so it
        is sized up front)."""
        dt_target = abs(tspan[1] - tspan[0]) / n_steps_hint
        s = max(3, math.ceil(math.sqrt(dt_target * rho / 0.653)) + 1)
        return RKC2(stages=min(s, max_stages), rho=rho)

    def _coeffs(self):
        """``(w0, w1, T, dT, ddT, b)``, cached per (stages, damping)."""
        return _rkc2_coeffs(self.stages, self.damping)

    def step(self, f, t, y, f0, dt, args):
        s = self.stages
        w0, w1, T, dT, ddT, b = self._coeffs()
        mu1_t = b[1] * w1

        Y_jm2 = y
        Y_jm1 = y + dt * mu1_t * f0
        t_jm2, t_jm1 = 0.0, mu1_t  # stage-time fractions (c_j)
        for j in range(2, s + 1):
            mu = 2.0 * b[j] * w0 / b[j - 1]
            nu = -b[j] / b[j - 2]
            mu_t = mu * w1 / w0
            a_jm1 = 1.0 - b[j - 1] * T[j - 1]
            gamma_t = -a_jm1 * mu_t
            f_jm1 = f(t + t_jm1 * dt, Y_jm1, args)
            Y_j = (
                (1.0 - mu - nu) * y
                + mu * Y_jm1
                + nu * Y_jm2
                + dt * mu_t * f_jm1
                + dt * gamma_t * f0
            )
            c_j = mu * t_jm1 + nu * t_jm2 + mu_t + gamma_t
            Y_jm2, Y_jm1 = Y_jm1, Y_j
            t_jm2, t_jm1 = t_jm1, c_j

        y1 = Y_jm1
        f1 = f(t + dt, y1, args)
        # Sommeijer-Shampine asymptotically-correct estimate
        y_err = 0.8 * (y - y1) + 0.4 * dt * (f0 + f1)
        nfe = s  # s-1 stage evals + the final f1
        return y1, y_err, f1, nfe


@dataclasses.dataclass(frozen=True)
class RKC1:
    """First-order damped Chebyshev iteration (stability ≈ 1.9·s²/rho).

    Occasionally useful as a cheap smoother-style integrator for very stiff
    diffusion when accuracy demands are minimal.
    """

    stages: int = 16
    rho: Optional[float] = None
    damping: float = 0.05

    order: int = dataclasses.field(default=1, init=False)
    error_order: int = dataclasses.field(default=2, init=False)

    @property
    def name(self):
        return f"RKC1(s={self.stages})"

    @property
    def dt_stab(self):
        if self.rho is None:
            return None
        s = self.stages
        w0, T, dT = _rkc1_coeffs(s, self.damping)
        beta = (1.0 + w0) * dT[s] / T[s]
        return beta / self.rho

    def step(self, f, t, y, f0, dt, args):
        s = self.stages
        w0, T, dT = _rkc1_coeffs(s, self.damping)
        w1 = T[s] / dT[s]
        mu1_t = w1 / w0

        Y_jm2 = y
        Y_jm1 = y + dt * mu1_t * f0
        t_jm2, t_jm1 = 0.0, mu1_t
        for j in range(2, s + 1):
            mu = 2.0 * w0 * T[j - 1] / T[j]
            nu = -T[j - 2] / T[j]
            mu_t = 2.0 * w1 * T[j - 1] / T[j]
            f_jm1 = f(t + t_jm1 * dt, Y_jm1, args)
            Y_j = mu * Y_jm1 + nu * Y_jm2 + dt * mu_t * f_jm1
            c_j = mu * t_jm1 + nu * t_jm2 + mu_t
            Y_jm2, Y_jm1 = Y_jm1, Y_j
            t_jm2, t_jm1 = t_jm1, c_j
        y1 = Y_jm1
        f1 = f(t + dt, y1, args)
        y_err = 0.8 * (y - y1) + 0.4 * dt * (f0 + f1)
        return y1, y_err, f1, s
