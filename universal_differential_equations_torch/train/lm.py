"""Levenberg-Marquardt for small-parameter least-squares UDE fits.

Port of ``universal_differential_equations_tpu/train/lm.py``.  Residuals are
(solution − data) on the save grid, so Gauss-Newton curvature costs one
forward-mode Jacobian per iteration: ``torch.func.jacfwd`` of the flat
residual function, through the differentiable stepping loop
(``ForwardSensitivity``).  The acceptance, damping, stall and ``loss_tol``
logic is the JAX package's, value for value.

The JAX core is one ``lax.while_loop`` on the device; here each iteration is
host-driven and reads one flag (``done``) back from the device.

:func:`levenberg_marquardt_lanes` runs ``L`` independent problems as lanes of
one loop, the counterpart of ``jax.vmap(levenberg_marquardt)``: a finished
lane is frozen, as ``vmap`` of ``while_loop`` freezes it, and the loop reads
"every lane done" once per iteration.  Its Jacobians come from
:func:`lane_jacobian`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jacfwd

from ..flatten_util import ravel_pytree

__all__ = ["lane_jacobian", "levenberg_marquardt", "levenberg_marquardt_lanes", "LMResult"]


class LMResult(NamedTuple):
    params: object
    loss: torch.Tensor  # final sum of squared residuals
    iterations: int  # an (L,) tensor from levenberg_marquardt_lanes
    lam: torch.Tensor
    converged: bool  # an (L,) tensor from levenberg_marquardt_lanes


def lane_jacobian(residual_lanes: Callable, x: torch.Tensor) -> torch.Tensor:
    """Per-lane Jacobians ``(L, m, n)`` of ``residual_lanes: (L, n) -> (L, m)``
    at ``x``, where lane ``l``'s residuals depend on ``x[l]`` only: one shift
    ``v`` of every lane at once gives each lane's Jacobian column, so
    ``jacfwd`` pushes ``n`` tangents, not ``L·n``."""
    return jacfwd(lambda v: residual_lanes(x + v))(torch.zeros_like(x[0]))


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


def levenberg_marquardt_lanes(
    residual_fn: Callable,
    x0: torch.Tensor,
    *,
    maxiters: int = 100,
    lam0: float = 1e-3,
    lam_up: float = 3.0,
    lam_down: float = 0.3,
    gtol: float = 1e-9,
    loss_tol: float = 0.0,
    max_stall: int = 8,
    jacobian_fn: Optional[Callable] = None,
) -> LMResult:
    """``L`` independent minimizations of ``‖r_l(x_l)‖²`` at once: the
    counterpart of ``jax.vmap(levenberg_marquardt)``.

    ``x0`` is ``(L, n)``; ``residual_fn`` maps ``(L, n)`` to the ``(L, m)``
    residuals, lane ``l``'s depending on ``x[l]`` only; ``jacobian_fn``, if
    given, maps ``(L, n)`` to their ``(L, m, n)`` Jacobians (default
    :func:`lane_jacobian` of ``residual_fn``).  Each lane follows
    :func:`levenberg_marquardt`'s rules; once done (``loss_tol``, ``gtol`` or
    ``max_stall``) it stops changing.  The loop ends when every lane is done
    or after ``maxiters`` iterations.  Every field of the result has a
    leading lane dimension.
    """
    x = x0.detach()
    dtype, device = x.dtype, x.device
    L = x.shape[0]

    def r_lanes(x):
        return residual_fn(x).to(dtype)

    r = r_lanes(x)
    loss = (r * r).sum(-1)
    lam = torch.full((L,), lam0, dtype=dtype, device=device)
    stall = torch.zeros(L, dtype=torch.int32, device=device)
    k = torch.zeros_like(stall)
    done = torch.zeros(L, dtype=torch.bool, device=device)
    for _ in range(maxiters):
        J = (lane_jacobian(r_lanes, x) if jacobian_fn is None else jacobian_fn(x)).to(dtype)
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        H = J.transpose(1, 2) @ J
        diag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-12)
        A = H + lam[:, None, None] * torch.diag_embed(diag)
        # a singular system gives inf/NaN, as jnp.linalg.solve does, and the
        # step is then rejected
        x_new = x - torch.linalg.solve_ex(A, g).result
        r_new = r_lanes(x_new)
        loss_new = (r_new * r_new).sum(-1)
        accept = (loss_new < loss) & torch.isfinite(r_new).all(-1)
        lam_t = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up), 1e-12, 1e12)
        stall_t = torch.where(accept, torch.zeros_like(stall), stall + 1)
        gnorm = g.abs().amax(-1)
        done_t = (accept & (loss_new < loss_tol)) | (gnorm < gtol) | (stall_t >= max_stall)
        # a finished lane is frozen, as vmap of while_loop freezes it
        run = ~done
        step = run & accept
        x = torch.where(step[:, None], x_new, x)
        r = torch.where(step[:, None], r_new, r)
        loss = torch.where(step, loss_new, loss)
        lam = torch.where(run, lam_t, lam)
        stall = torch.where(run, stall_t, stall)
        k = k + run.to(k.dtype)
        done = done | done_t
        if bool(done.all()):  # the one device-to-host read per iteration
            break
    return LMResult(params=x, loss=loss, iterations=k, lam=lam,
                    converged=done & (stall < max_stall))
