"""Multiple shooting for long-horizon UDE training (SURVEY.md C18).

Port of ``universal_differential_equations_tpu/train/shooting.py``.  The
reference uses library ``multiple_shoot(p, ode_data, tsteps, prob, loss,
continuity_term; group_size)`` (``hudson_bay.jl:107-117``).  Every segment
starts at its data point, and all segments are solved together by one
``torch.func.vmap`` over ``solve``: one adaptive loop whose lanes are the
segments (a lane that finishes early waits, unchanged, for the others).  A
continuity penalty ties each segment's end to the next segment's start.

With ``mesh`` the segments are split over the mesh's ranks, this domain's
sequence-parallel axis: each rank solves its contiguous share in the same
one ``vmap`` and the loss's sums go through ``parallel.collectives.psum``
(the JAX package's GSPMD ``psum``); the parameters enter through
``grad_psum``, so the gradient is the global one on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..adjoint.sensitivity import DiscreteAdjoint
from ..api import solve
from ..core.problem import ODEProblem
from ..parallel.collectives import grad_psum, psum
from ..solvers.runge_kutta import Tsit5

__all__ = ["multiple_shoot", "shooting_windows"]


def shooting_windows(num_points: int, group_size: int, device=None):
    """Segment index windows with one-point overlap (DiffEqFlux semantics):
    starts at 0, g-1, 2(g-1), …; a ragged tail is clamped to the last index
    and masked out of the loss.  Returns ``(idx, mask)``, both
    ``(n_seg, group_size)``; the mask is float32 (1 = a real point)."""
    if group_size < 2:
        raise ValueError(f"group_size must be >= 2, got {group_size}")
    stride = group_size - 1
    n_seg = max(1, -(-(num_points - 1) // stride))
    starts = torch.arange(n_seg, device=device) * stride
    idx = starts[:, None] + torch.arange(group_size, device=device)[None, :]
    mask = idx <= num_points - 1
    return idx.clamp(0, num_points - 1), mask.to(torch.float32)


def multiple_shoot(
    params,
    data,
    ts,
    rhs: Callable,
    *,
    group_size: int = 5,
    continuity_term: float = 100.0,
    solver=None,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    adjoint=None,
    max_steps: int = 256,
    loss_fn: Optional[Callable] = None,
    mesh=None,
    mesh_axis: Optional[str] = None,
):
    """Segmented trajectory loss (``hudson_bay.jl:115-117``).

    Args:
      params: RHS parameters (differentiable pytree).
      data: (N, dim) observations at times ``ts`` (N,).
      rhs: ``f(t, u, params)``.
      group_size / continuity_term: reference's knobs (e.g. 5 / 200).
      adjoint: defaults to ``DiscreteAdjoint()``; any adjoint works under
        the segment ``vmap`` (``ForwardSensitivity`` for ``jacfwd``).
      loss_fn: per-segment data loss ``(pred, target, mask) -> scalar``;
        defaults to masked squared error.  Under a mesh it sees this rank's
        segments and the ranks' values are summed, so it must be a sum over
        segments, as the default is.
      mesh / mesh_axis: an optional ``parallel.Mesh`` (+ axis name, default
        its axis): the segments are split over its ranks, every rank of the
        mesh makes the call and gets the global loss.  A segment count that
        does not divide by the mesh size is padded with masked segments, as
        GSPMD pads in the JAX package.  Works under ``torch.autograd``,
        ``torch.func.grad`` and ``torch.func.jacfwd``.

    Returns scalar loss = Σ segment data loss + continuity_term · Σ
    ‖pred_end(i) − data_start(i+1)‖² + a failed-segment penalty.
    """
    solver = Tsit5() if solver is None else solver
    adjoint = DiscreteAdjoint() if adjoint is None else adjoint
    data = torch.as_tensor(data)
    ts = torch.as_tensor(ts, device=data.device)
    idx, mask = shooting_windows(data.shape[0], group_size, device=data.device)
    n_seg = idx.shape[0]
    if mesh is not None:
        mesh.axis(mesh_axis)
        mesh.check(data, "data")
        per = -(-n_seg // mesh.size)
        seg = mesh.member() * per + torch.arange(per, device=data.device)  # global index
        # segments past the last are padding: a copy of the last, masked out
        real = seg < n_seg
        mask = mask[seg.clamp(max=n_seg - 1)] * real[:, None]
        idx = idx[seg.clamp(max=n_seg - 1)]
        params = grad_psum(params, mesh)
    seg_ts = ts[idx]  # (n_seg, g)
    seg_data = data[idx]  # (n_seg, g, dim)
    u0s = seg_data[:, 0, :]

    def solve_segment(u0, tw):
        prob = ODEProblem(rhs, u0, (tw[0], tw[-1]), params)
        sol = solve(prob, solver, saveat=tw, rtol=rtol, atol=atol,
                    adjoint=adjoint, max_steps=max_steps)
        # error_sum (populated on the bounded-loop adjoints) is the
        # differentiable handle on "how hard was this segment to integrate"
        err = sol.error_sum if sol.error_sum is not None else torch.zeros_like(tw[0])
        return sol.ys, sol.success, err

    preds, seg_ok, seg_err = torch.func.vmap(solve_segment)(u0s, seg_ts)

    if loss_fn is None:
        def loss_fn(pred, target, m):
            return torch.sum(m[..., None] * (pred - target) ** 2)

    data_loss = loss_fn(preds, seg_data, mask)
    # continuity: end of segment i vs data start of segment i+1, for the
    # fully covered segment ends
    if mesh is None:
        ends, starts, seg_valid = preds[:-1, -1, :], seg_data[1:, 0, :], mask[:-1, -1]
    else:
        has_next = (seg < n_seg - 1)[:, None]
        ends = torch.where(has_next, preds[:, -1, :], 0.0)
        # a window's last point is the next window's first
        starts = torch.where(has_next, data[idx[:, -1]], 0.0)
        seg_valid = mask[:, -1]
    continuity = torch.sum(seg_valid[:, None] * (ends - starts) ** 2)
    # A segment that exhausts max_steps clamps its dense-output tail: finite
    # but wrong values.  A large finite penalty per failed segment makes line
    # searches and LM reject the region while keeping ADAM's gradients finite;
    # the flat 1e4 term has no gradient, so the failed segments' error_sum
    # (the differentiable sum of tolerance-normalized local errors) gives
    # first-order optimizers a restoring direction.
    failed = (~seg_ok).to(data_loss.dtype)
    seg_err = seg_err.to(data_loss.dtype)
    if mesh is not None:
        failed = torch.where(real, failed, 0.0)
        seg_err = torch.where(real, seg_err, 0.0)
    restoring = torch.sum(failed * seg_err) / max_steps
    n_failed = torch.sum(failed)
    if mesh is not None:
        data_loss, continuity, n_failed, restoring = psum(
            torch.stack([data_loss, continuity.to(data_loss.dtype), n_failed, restoring]),
            mesh).unbind()
    return data_loss + continuity_term * continuity + (1e4 * n_failed + restoring)
