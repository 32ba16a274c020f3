"""Levenberg-Marquardt for small-parameter least-squares UDE fits.

Port of ``universal_differential_equations_tpu/train/lm.py``.  Residuals are
(solution − data) on the save grid, so Gauss-Newton curvature costs one
forward-mode Jacobian per iteration: ``torch.func.jacfwd`` of the flat
residual function, through the differentiable stepping loop
(``ForwardSensitivity``).  The acceptance, damping, stall and ``loss_tol``
logic is the JAX package's, value for value.

The JAX core is one ``lax.while_loop`` on the device; here each iteration is
host-driven and reads one flag (``done``) back from the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd

from ..flatten_util import ravel_pytree

__all__ = ["levenberg_marquardt", "LMResult"]


class LMResult(NamedTuple):
    params: object
    loss: torch.Tensor  # final sum of squared residuals
    iterations: int
    lam: torch.Tensor
    converged: bool


def levenberg_marquardt(
    residual_fn: Callable,
    params0,
    *,
    maxiters: int = 100,
    lam0: float = 1e-3,
    lam_up: float = 3.0,
    lam_down: float = 0.3,
    gtol: float = 1e-9,
    loss_tol: float = 0.0,
    max_stall: int = 8,
    callback: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> LMResult:
    """Minimize ``‖residual_fn(params)‖²`` over a pytree of parameters.

    ``loss_tol``: early exit when the loss drops below it (the reference's
    ``l < 0.01`` callbacks).  A step is accepted when it reduces the loss;
    rejected steps raise λ toward gradient descent.  ``callback(k, loss)``,
    if given, runs on the host after iteration ``k`` (0-based) with the
    current loss.
    """
    x, unravel = ravel_pytree(params0)
    dtype, device = x.dtype, x.device

    def r_flat(x):
        # pin residuals to the parameter dtype, as the JAX core does
        return ravel_pytree(residual_fn(unravel(x.to(dtype))))[0].to(dtype)

    r = r_flat(x)
    loss = torch.sum(r * r)
    lam = torch.tensor(lam0, dtype=dtype, device=device)
    stall = torch.zeros((), dtype=torch.int32, device=device)
    done = False
    k = 0
    while not done and k < maxiters:
        # (m, n), pinned like the residuals: torch.func gives 0-d float32
        # values combined with Python scalars (the penalty term) float64 tangents
        J = jacfwd(r_flat)(x).to(dtype)
        g = J.T @ r
        H = J.T @ J
        diag = torch.diagonal(H)
        A = H + lam * torch.diag(torch.clamp(diag, min=1e-12))
        step = torch.linalg.solve(A, g)
        x_new = x - step
        r_new = r_flat(x_new)
        loss_new = torch.sum(r_new * r_new)
        accept = (loss_new < loss) & torch.all(torch.isfinite(r_new))
        lam = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up), 1e-12, 1e12)
        stall = torch.where(accept, torch.zeros_like(stall), stall + 1)
        gnorm = torch.max(torch.abs(g))
        done_t = (accept & (loss_new < loss_tol)) | (gnorm < gtol) | (stall >= max_stall)
        x = torch.where(accept, x_new, x)
        r = torch.where(accept, r_new, r)
        loss = torch.where(accept, loss_new, loss)
        k += 1
        done = bool(done_t)  # the one device-to-host read per iteration
        if callback is not None:
            callback(k - 1, loss)
    return LMResult(
        params=unravel(x),
        loss=loss,
        iterations=k,
        lam=lam,
        # terminated via a tolerance (loss_tol / gtol), not via stall or the
        # iteration budget
        converged=done and int(stall) < max_stall,
    )
