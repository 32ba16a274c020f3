"""SDE solvers: the Euler-Maruyama family on given or drawn Brownian paths.

Port of ``universal_differential_equations_tpu/solvers/sde.py``.  The
reference solves the deep-BSDE forward system with ``LambaEM`` (adaptive
Euler-Maruyama) over ``trajectories=m`` paths (``highdim_pde/lambaem.jl:33-34``).

* ``sdeint`` integrates on a fixed grid with ``EulerMaruyama`` (Itô) or
  ``EulerHeun`` (Stratonovich); it is differentiable through the path.
* ``AdaptiveEM`` chooses step sizes by error control on a Brownian path
  pinned to a fixed fine grid (partial sums of grid increments), so the
  accepted path does not depend on the step sequence (the LambaEM role).

Noise comes from a ``torch.Generator`` (``generator=``) or is given as the
increments themselves (``dws=``, what the JAX package's
``sdeint(..., return_increments=True)`` returns), so both packages can take
the same path.  Trajectories batch with ``torch.func.vmap`` over ``dws``
(or a plain loop).

Noise forms: diagonal (``g`` returns a tree matching ``u``) or general
(``g`` returns ``(dim, m)``, declared by ``SDEProblem.noise_dim``).

``AdaptiveEM`` keeps its step control on the device: the JAX
``lax.while_loop`` becomes blocks of ``_BLOCK`` masked attempts, and the
host reads one flag per block, "has every lane finished" (through
``core/integrate.py``'s ``_AllDone``, whose ``vmap`` rule reduces over the
lanes).  An attempt after a lane's end leaves that lane unchanged, as the
JAX loop's ``cond`` would have stopped it.  ``host_reads`` counts these
reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.utils._pytree as _pytree
from torch._C import _functorch
from torch.utils.checkpoint import checkpoint as _checkpoint

from ..core.integrate import _AllDone, _has_lanes
from ..core.problem import SDEProblem
from ..flatten_util import ravel_pytree

__all__ = ["EulerMaruyama", "EulerHeun", "AdaptiveEM", "sdeint", "SDESolution"]

_BLOCK = 16  # AdaptiveEM attempts between two host reads
host_reads = 0  # AdaptiveEM's "every lane done" reads since import


@dataclasses.dataclass(frozen=True)
class SDESolution:
    ts: torch.Tensor  # (n_save,)
    ys: Any  # (n_save, *state)
    y_final: Any
    success: torch.Tensor
    num_steps: torch.Tensor


# a tree node, as JAX registers it, so torch.func.vmap can return a solution
_FIELDS = [f.name for f in dataclasses.fields(SDESolution)]
_pytree.register_pytree_node(SDESolution, lambda s: ([getattr(s, f) for f in _FIELDS], None),
                             lambda xs, _: SDESolution(*xs))


@dataclasses.dataclass(frozen=True)
class EulerMaruyama:
    """Fixed-grid strong-order-0.5 Euler-Maruyama (Itô)."""

    def step(self, f, g, t, y, dt, dw, args, noise_dim):
        drift = f(t, y, args)
        if noise_dim is None:
            diff = g(t, y, args) * dw
        else:
            diff = g(t, y, args) @ dw
        return y + dt * drift + diff


@dataclasses.dataclass(frozen=True)
class EulerHeun:
    """Stratonovich Euler-Heun predictor-corrector."""

    def step(self, f, g, t, y, dt, dw, args, noise_dim):
        def diffuse(yy):
            gv = g(t, yy, args)
            return gv * dw if noise_dim is None else gv @ dw

        drift = f(t, y, args)
        d1 = diffuse(y)
        y_pred = y + d1
        d2 = diffuse(y_pred)
        return y + dt * drift + 0.5 * (d1 + d2)


def _brownian_increments(generator, dws, n, m, dt, dtype, device):
    """(n, m) increments ~ N(0, dt): ``dws`` as given, or standard normals
    drawn on the generator's device, moved to ``device`` and scaled by
    ``sqrt(dt)`` in ``dtype``.  Exactly one of the two is given."""
    if (generator is None) == (dws is None):
        raise ValueError("give exactly one of generator= and dws=")
    if dws is not None:
        dws = torch.as_tensor(dws, dtype=dtype, device=device)
        if tuple(dws.shape) != (n, m):
            raise ValueError(f"dws has shape {tuple(dws.shape)}; this problem needs ({n}, {m})")
        return dws
    z = torch.randn((n, m), generator=generator, dtype=dtype, device=generator.device)
    return z.to(device) * torch.sqrt(torch.as_tensor(dt, dtype=dtype, device=device))


def _flat_problem(problem):
    """``(y0_flat, unravel, f_flat, g_flat, m)``: the problem on the raveled
    state; ``m`` is the noise's width."""
    y0_flat, unravel = ravel_pytree(problem.u0)
    user_f, user_g = problem.f, problem.g

    def f_flat(t, yf, args):
        return ravel_pytree(user_f(t, unravel(yf), args))[0]

    if problem.noise_dim is None:
        def g_flat(t, yf, args):
            return ravel_pytree(user_g(t, unravel(yf), args))[0]
        m = y0_flat.shape[0]
    else:
        def g_flat(t, yf, args):
            return user_g(t, unravel(yf), args)
        m = problem.noise_dim
    return y0_flat, unravel, f_flat, g_flat, m


def sdeint(
    problem: SDEProblem,
    solver=None,
    *,
    generator: Optional[torch.Generator] = None,
    dws=None,
    dt: Optional[float] = None,
    n_steps: Optional[int] = None,
    saveat=None,
    checkpoint: bool = True,
    return_increments: bool = False,
):
    """Fixed-grid SDE integration, differentiable through the path.

    Provide ``n_steps`` (or ``dt``; with ``dws`` alone, ``n_steps`` is its
    length); ``saveat`` defaults to the endpoints.  Noise: exactly one of
    ``generator`` (a ``torch.Generator``; standard normals are drawn on its
    device) and ``dws``, the ``(n_steps, m)`` increments themselves.  Batch
    trajectories with ``torch.func.vmap`` over ``dws``, e.g.
    ``vmap(lambda w: sdeint(prob, dws=w).y_final)(dws)``.

    ``checkpoint=True`` recomputes each step in the backward pass instead of
    storing its intermediates (``torch.utils.checkpoint``, non-reentrant); the
    values do not change.  Under a ``torch.func`` transform, which refuses the
    checkpoint's saved-tensor hooks, the steps run uncheckpointed.

    ``return_increments=True`` returns ``(solution, dws)``: the increments
    the stepper consumed.
    """
    solver = EulerMaruyama() if solver is None else solver
    y0_flat, unravel, f_flat, g_flat, m = _flat_problem(problem)
    dtype, device = y0_flat.dtype, y0_flat.device
    t0 = torch.as_tensor(problem.tspan[0], dtype=dtype, device=device)
    t1 = torch.as_tensor(problem.tspan[1], dtype=dtype, device=device)
    if n_steps is None:
        if dt is not None:
            n_steps = int(abs((float(t1) - float(t0)) / dt) + 0.5)
        elif dws is not None:
            n_steps = int(dws.shape[0])
        else:
            raise ValueError("provide dt or n_steps")
    h = (t1 - t0) / n_steps
    noise_dim = problem.noise_dim
    dws = _brownian_increments(generator, dws, n_steps, m, h.abs(), dtype, device)
    ts_grid = t0 + h * torch.arange(n_steps + 1, dtype=dtype, device=device)

    def body(t, y, dw):
        return solver.step(f_flat, g_flat, t, y, h, dw, problem.args, noise_dim)

    checkpoint = (checkpoint and torch.is_grad_enabled()
                  and _functorch.peek_interpreter_stack() is None)
    y, ys_grid = y0_flat, [y0_flat]
    for k in range(n_steps):
        if checkpoint:
            y = _checkpoint(body, ts_grid[k], y, dws[k], use_reentrant=False)
        else:
            y = body(ts_grid[k], y, dws[k])
        ys_grid.append(y)
    ys_grid = torch.stack(ys_grid)  # (n+1, dim)

    if saveat is None:
        ts = torch.stack([t0, t1])
        idx = torch.tensor([0, n_steps], device=device)
    else:
        ts = torch.as_tensor(saveat, dtype=dtype, device=device)
        idx = torch.clamp(torch.round((ts - t0) / h).to(torch.int64), 0, n_steps)
    ys = ys_grid[idx]
    sol = SDESolution(
        ts=ts,
        ys=unravel(ys),
        y_final=unravel(y),
        success=torch.all(torch.isfinite(ys_grid[-1])),
        num_steps=torch.tensor(n_steps, dtype=torch.int32, device=device),
    )
    return (sol, dws) if return_increments else sol


@dataclasses.dataclass(frozen=True)
class AdaptiveEM:
    """Error-controlled Euler-Maruyama on a pinned Brownian grid (the
    LambaEM role, ``lambaem.jl:33-34``).

    The Brownian path is materialised once on a fine fixed grid; the
    controller chooses step sizes in units of grid cells using Lamba's
    drift-based error estimate ``E ≈ |f(t+dt, y_pred) − f(t, y)|·dt``,
    halving on rejection and growing on easy acceptance.  The accepted path
    does not depend on the step sequence.
    """

    grid_resolution: int = 1024
    abstol: float = 1e-3
    reltol: float = 1e-2
    max_steps: int = 4096

    def solve(self, problem: SDEProblem, *, generator=None, dws=None, saveat=None):
        """Solve on the grid's increments: exactly one of ``generator`` and
        ``dws``, the ``(grid_resolution, m)`` increments of the fine grid.
        Batch lanes with ``torch.func.vmap`` over ``dws``."""
        global host_reads
        y0_flat, unravel, f_flat, g_flat, m = _flat_problem(problem)
        dtype, device = y0_flat.dtype, y0_flat.device
        t0 = torch.as_tensor(problem.tspan[0], dtype=dtype, device=device)
        t1 = torch.as_tensor(problem.tspan[1], dtype=dtype, device=device)
        n_grid = self.grid_resolution
        h_min = (t1 - t0) / n_grid
        args, noise_dim = problem.args, problem.noise_dim

        def apply_g(t, yf, dw):
            gv = g_flat(t, yf, args)
            return gv * dw if noise_dim is None else gv @ dw

        incs = _brownian_increments(generator, dws, n_grid, m, h_min.abs(), dtype, device)
        W = torch.cat([torch.zeros((1, m), dtype=dtype, device=device), torch.cumsum(incs, 0)])
        slots = torch.arange(n_grid + 1, device=device)

        def at(x, i):
            # 1-element index: a 0-d one is read back to the host under vmap
            return torch.index_select(x, 0, i.reshape(1))[0]

        def attempt(i, y, cells, n, ys, vis):
            live = (i < n_grid) & (n < self.max_steps)  # the while_loop's cond
            cells = torch.minimum(cells, n_grid - i)
            t = t0 + i * h_min
            dt = cells * h_min
            dw = at(W, i + cells) - at(W, i)
            drift = f_flat(t, y, args)
            y_pred = y + dt * drift + apply_g(t, y, dw)
            # Lamba (2003) drift-difference error estimate
            drift2 = f_flat(t + dt, y_pred, args)
            err = 0.5 * dt * torch.max(torch.abs(drift2 - drift))
            tol = self.abstol + self.reltol * torch.max(torch.abs(y))
            accept = (err <= tol) | (cells == 1)
            grow = err <= 0.25 * tol
            cells_new = torch.where(accept, torch.where(grow, cells * 2, cells),
                                    torch.clamp(cells // 2, min=1))
            # explicit visited flags: inferring "visited" from ys != 0 would
            # treat an accepted exactly-zero state (absorbing point of
            # multiplicative noise in f32) as unvisited and forward-fill
            # stale values over it
            write = live & accept & (slots == i + cells)
            return (torch.where(live & accept, i + cells, i),
                    torch.where(live & accept, y_pred, y),
                    torch.where(live, cells_new, cells),
                    n + live.to(n.dtype),
                    torch.where(write[:, None], y_pred, ys),
                    vis | write)

        i32 = dict(dtype=torch.int32, device=device)
        ys0 = torch.zeros((n_grid + 1, y0_flat.shape[0]), dtype=dtype, device=device)
        state = (torch.zeros((), **i32), y0_flat, torch.full((), 4, **i32),
                 torch.zeros((), **i32), torch.where(slots[:, None] == 0, y0_flat, ys0),
                 slots == 0)
        lanes = None
        while True:
            for _ in range(_BLOCK):
                state = attempt(*state)
            i, y_final, _, n_used, ys_sparse, visited = state
            if lanes is None:
                lanes = _has_lanes(i, y_final)
            done = (i >= n_grid) | (n_used >= self.max_steps)
            host_reads += 1
            if bool(_AllDone.apply(done) if lanes else done):
                break

        # forward-fill unvisited grid slots so saveat snapping is piecewise
        # constant between accepted points
        if saveat is None:
            ts = torch.stack([t0, t1])
        else:
            ts = torch.as_tensor(saveat, dtype=dtype, device=device)
        idx = torch.clamp(torch.round((ts - t0) / h_min).to(torch.int64), 0, n_grid)
        # gather nearest visited accepted point at or before idx
        run_max = torch.cummax(torch.where(visited, slots, 0), 0).values
        ys = ys_sparse[run_max[idx]]
        return SDESolution(
            ts=ts,
            ys=unravel(ys),
            y_final=unravel(y_final),
            success=(i >= n_grid) & torch.all(torch.isfinite(y_final)),
            num_steps=n_used,
        )
