"""Sensitivity algorithms: differentiating through ``solve``.

Port of ``universal_differential_equations_tpu/adjoint/sensitivity.py``:

* ``NoAdjoint`` — forward-only solve (truth generation at tight tolerances).
* ``DiscreteAdjoint`` — autograd straight through the bounded stepping loop
  (the analogue of Tracker's ``diffeq_rd`` discrete adjoint, C10).
* ``ForwardSensitivity`` — the same loop for forward mode
  (``ForwardDiffSensitivity``, C7): use it under ``torch.func.jacfwd`` /
  ``torch.func.jvp``, as the LM trainer does.
* ``InterpolatingAdjoint`` — continuous adjoint: the forward pass is a
  forward-only solve that keeps its dense output; the backward pass
  integrates ``λ' = -(∂f/∂u)ᵀλ, μ' = -(∂f/∂p)ᵀλ`` between save points,
  reading ``u(t)`` from the interpolant (``seir_exposure.jl:71``, C8/C9).
* ``BacksolveAdjoint`` — re-integrates the state backwards alongside the
  adjoint, reset to the stored forward state at every save point.
* ``QuadratureAdjoint`` — λ-only backward solve, then Gauss–Legendre panels
  for ``μ = ∫ λᵀ ∂f/∂p dt`` (arXiv:2308.10644).

Where JAX has one ``jax.custom_vjp``, the port has one
``torch.autograd.Function`` whose inputs are the initial state and the leaves
of ``args``.  Its backward takes vector-Jacobian products of ``f`` with
``torch.autograd.grad`` under ``torch.enable_grad()`` (``torch.func.vjp``
under an outer ``torch.func.grad``/``vjp``, which both work through it).
The continuous adjoints have no forward-mode rule (nor does JAX's
``custom_vjp``): under ``torch.func.jacfwd`` they raise
``NotImplementedError`` naming ``ForwardSensitivity``.  Under
``torch.func.vmap`` the Function's generated rule runs its forward and
backward passes over the lanes; the backward pass reads nothing from the
device, so each lane's adjoint solves share one loop (``core/integrate.py``).

Constraint: under the continuous adjoints, ``args`` must be a pytree of
floating-point tensors (static configuration belongs in the RHS closure).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.controller import PIController
from ..core.integrate import IntegrateResult, integrate_scan, integrate_while
from ..core.solution import DenseInterpolation
from ..flatten_util import tree_flatten_with_path

__all__ = [
    "AbstractAdjoint",
    "NoAdjoint",
    "DiscreteAdjoint",
    "ForwardSensitivity",
    "InterpolatingAdjoint",
    "BacksolveAdjoint",
    "QuadratureAdjoint",
]


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
    stages.  Under a ``torch.func`` transform (``grad``, ``vjp``,
    ``jacrev``), which refuses ``torch.utils.checkpoint``'s saved-tensor
    hooks, the attempts run without recomputation: the same gradient, with
    all stages kept.

    Caveat (as in the JAX package): if a *rejected* attempt overflows to
    inf/NaN, the backward pass still differentiates that attempt, and the
    masked zero cotangent times a NaN partial is NaN.  The continuous
    adjoints read only the accepted trajectory and avoid it.
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


def _float_args(args, y0, adjoint_name):
    """``(leaves, build)`` of ``args`` for a continuous adjoint.

    The backward pass integrates the args' cotangents as part of the adjoint
    state, so every leaf must be floating point.  Python floats and numpy
    floats become tensors of the state's dtype and device (``jnp.asarray``
    takes them in JAX); ints, bools and non-floating tensors raise the JAX
    package's named error."""
    pairs, build = tree_flatten_with_path(args)
    leaves, bad = [], []
    for path, leaf in pairs:
        if isinstance(leaf, (float, np.floating)) or (
                isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating)):
            leaf = torch.as_tensor(leaf, dtype=y0.dtype, device=y0.device)
        elif isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                bad.append(f"{path} (dtype {leaf.dtype})")
        else:
            bad.append(f"{path} (Python {type(leaf).__name__})")
        leaves.append(leaf)
    if bad:
        raise TypeError(
            f"{adjoint_name} requires problem.args to be a pytree of "
            f"floating-point (inexact) tensors, but got: {', '.join(bad)}. Cast "
            f"the leaves to float, or move static integer configuration into "
            f"the RHS closure, or use DiscreteAdjoint (which differentiates "
            f"through the stepper and leaves non-inexact args alone).")
    return leaves, build


@dataclasses.dataclass(frozen=True)
class _ContinuousAdjoint(AbstractAdjoint):
    rtol: Optional[float] = None  # backward-pass tolerances; None = forward's
    atol: Optional[float] = None
    segment_max_steps: int = 1024
    default_max_steps: int = 4096
    # adjoint seminorm (arXiv:2009.09457): exclude the passively integrated
    # parameter-quadrature rows from the backward error test; λ (and the
    # backsolved state) stay controlled, μ rides along
    seminorm: bool = False
    # Hermite-window size for the backward pass's u(t) reads; None = the
    # solver's order-matched ``dense_nodes``
    interp_nodes: Optional[int] = None

    kind = "interp"

    def run(self, f, y0, t0, t1, args, ts_save, solver, controller, rtol, atol,
            dt0, max_steps, tstops=None):
        leaves, build = _float_args(args, y0, type(self).__name__)
        spec = _Spec(f, solver, controller, rtol, atol, dt0, max_steps, self, build)
        # the span ends as tensors (float64 holds a Python float exactly), so
        # vmap can batch them
        t0, t1 = (t if isinstance(t, torch.Tensor)
                  else torch.as_tensor(t, dtype=torch.float64, device=y0.device)
                  for t in (t0, t1))
        (ys, y_final, buf_t, buf_y, buf_f, num_points, direction, t_final,
         success, n_acc, n_rej, nfe) = _ContinuousSolve.apply(
            spec, t0, t1, ts_save, tstops, y0, *leaves)
        dense = DenseInterpolation(buf_t, buf_y, buf_f, num_points, direction,
                                   nodes=getattr(solver, "dense_nodes", 2))
        return ys, IntegrateResult(dense, t_final, y_final, success, n_acc, n_rej, nfe)


@dataclasses.dataclass(frozen=True)
class InterpolatingAdjoint(_ContinuousAdjoint):
    kind = "interp"


@dataclasses.dataclass(frozen=True)
class BacksolveAdjoint(_ContinuousAdjoint):
    kind = "backsolve"


@dataclasses.dataclass(frozen=True)
class QuadratureAdjoint(_ContinuousAdjoint):
    """Continuous adjoint with Gauss–Legendre parameter quadrature.

    The backward pass integrates only ``λ' = -(∂f/∂u)ᵀλ`` (state-sized),
    and ``μ = ∫ λᵀ ∂f/∂p dt`` is evaluated afterwards by ``quad_order``-point
    Gauss–Legendre panels per save segment, reading ``λ(t)`` from the
    backward solve's dense output and ``u(t)`` from the forward's.
    ``seminorm`` is moot here (no quadrature rows).

    The integrand is only piecewise smooth (knots at solver steps), so a
    segment spanning many steps loses accuracy with one panel:
    ``quad_subpanels`` splits every segment into that many equal panels.
    """

    kind = "quadrature"
    quad_order: int = 12
    quad_subpanels: int = 1


# ---------------------------------------------------------------------------
# autograd.Function core shared by the continuous adjoints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Spec:
    """The non-differentiable configuration of one continuous-adjoint solve."""

    f: Callable
    solver: Any
    controller: Optional[PIController]
    rtol: float
    atol: float
    dt0: Any
    max_steps: int
    cfg: _ContinuousAdjoint
    build: Callable  # leaves -> args pytree


class _ContinuousSolve(torch.autograd.Function):
    """Inputs ``(spec, t0, t1, ts_save, tstops, y0, *leaves)``; outputs
    ``(ys, y_final, buf_t, buf_y, buf_f, num_points, direction, t_final,
    success, n_acc, n_rej, nfe)``.  Only ``ys`` and ``y_final`` are
    differentiable, with respect to ``y0`` and the leaves of ``args``.

    Written in the ``setup_context`` style, so ``torch.func.grad``,
    ``torch.func.vjp`` and ``torch.func.vmap`` (a generated rule: forward and
    backward are vmap-safe) work through it.  Forward mode raises a named
    error, as JAX's ``custom_vjp`` has no JVP either.
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(spec, t0, t1, ts_save, tstops, y0, *leaves):
        res = integrate_while(
            spec.f, y0, t0, t1, spec.build(list(leaves)), spec.solver,
            spec.rtol, spec.atol, spec.dt0, spec.max_steps,
            PIController() if spec.controller is None else spec.controller,
            tstops,
        )
        d = res.dense
        ys = d.evaluate(ts_save)
        # a zero-length solve hands y0 back unchanged: return a copy, so no
        # output of this function is one of its inputs
        y_final = res.y_final.clone() if res.y_final is y0 else res.y_final
        return (ys, y_final, d.ts, d.ys, d.fs, d.num_points, d.direction,
                res.t_final, res.success, res.n_acc, res.n_rej, res.nfe)

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, t0, t1, ts_save, _, y0, *leaves = inputs
        ys, _, buf_t, buf_y, buf_f, num_points, direction, _, success = output[:9]
        ctx.mark_non_differentiable(*output[2:])
        ctx.set_materialize_grads(False)
        ctx.spec = spec
        ctx.save_for_backward(t0, t1, ts_save, y0, buf_t, buf_y, buf_f, num_points,
                              direction, ys, success, *leaves)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            f"{type(ctx.spec.cfg).__name__} has no forward-mode rule (nor has "
            f"JAX's custom_vjp): under torch.func.jacfwd or jvp name "
            f"ForwardSensitivity().")

    @staticmethod
    def backward(ctx, g_ys, g_yfin, *_):
        (t0, t1, ts_save, y0, buf_t, buf_y, buf_f, num_points, direction, ys_save,
         success, *leaves) = ctx.saved_tensors
        g_ys = torch.zeros_like(ys_save) if g_ys is None else g_ys
        g_yfin = torch.zeros_like(y0) if g_yfin is None else g_yfin
        y0_bar, leaf_bars = _backward(ctx.spec, t0, t1, ts_save, y0, leaves, buf_t,
                                      buf_y, buf_f, num_points, direction, ys_save,
                                      success, g_ys, g_yfin)
        return (None, None, None, None, None, y0_bar, *leaf_bars)


def _vjp(f, t, y, leaves, build, cot, wrt_y=True, wrt_args=True):
    """``(f(t, y, args), [cotᵀ∂f/∂y], [cotᵀ∂f/∂args raveled])`` by reverse AD.

    Under an outer ``torch.func`` transform, where ``requires_grad_`` is
    refused, by ``torch.func.vjp``; otherwise by ``torch.autograd.grad``,
    which costs the host about half as much per call.
    """
    leaves = list(leaves)
    with torch.enable_grad():
        if torch._C._functorch.peek_interpreter_stack() is None:
            y_v = y.detach().requires_grad_(wrt_y)
            leaves_v = [leaf.detach().requires_grad_(wrt_args) for leaf in leaves]
            out = f(t, y_v, build(leaves_v))
            wrt = ([y_v] if wrt_y else []) + (leaves_v if wrt_args else [])
            grads = torch.autograd.grad(out, wrt, cot, allow_unused=True,
                                        materialize_grads=True)
            y_bar = grads[0] if wrt_y else None
            l_bars = grads[int(wrt_y):] if wrt_args else None
            out = out.detach()
        elif wrt_y and wrt_args:
            out, pull = torch.func.vjp(lambda y_, l_: f(t, y_, build(l_)), y, leaves)
            y_bar, l_bars = pull(cot)
        elif wrt_y:
            out, pull = torch.func.vjp(lambda y_: f(t, y_, build(leaves)), y)
            (y_bar,), l_bars = pull(cot), None
        else:
            out, pull = torch.func.vjp(lambda l_: f(t, y, build(l_)), leaves)
            y_bar, (l_bars,) = None, pull(cot)
    a_bar = None
    if wrt_args:
        a_bar = (torch.cat([g.reshape(-1) for g in l_bars]) if l_bars
                 else out.new_zeros(0))
    return out, y_bar, a_bar


def _backward(spec, t0, t1, ts_save, y0, leaves, buf_t, buf_y, buf_f, num_points,
              direction, ys_save, success, g_ys, g_yfin):
    """The adjoint pass: ``(y0_bar, [leaf cotangents])``.

    It reads nothing from the device, so it runs unchanged under ``vmap``.
    """
    cfg, f, solver, build = spec.cfg, spec.f, spec.solver, spec.build
    sizes = [leaf.numel() for leaf in leaves]

    def unravel(flat):
        return [p.reshape(leaf.shape).to(leaf.dtype)
                for p, leaf in zip(torch.split(flat, sizes), leaves)]

    # A failed or NaN-poisoned forward gives a NaN gradient, as a failed
    # backward segment does.  No value is read back to decide: the backward
    # solves still run, on zero cotangents (a few growing steps each, where
    # the real ones could be stiff past a blow-up), and the result is poisoned
    ok = success & torch.isfinite(g_yfin).all() & torch.isfinite(g_ys).all()
    g_ys = torch.where(ok, g_ys, torch.zeros_like(g_ys))
    g_yfin = torch.where(ok, g_yfin, torch.zeros_like(g_yfin))

    nodes = cfg.interp_nodes
    if nodes is None:
        nodes = getattr(solver, "dense_nodes", 2)
    dense = DenseInterpolation(buf_t, buf_y, buf_f, num_points, direction, nodes=nodes)
    dim = y0.shape[0]
    n_p = sum(sizes)
    a_rtol = spec.rtol if cfg.rtol is None else cfg.rtol
    a_atol = spec.atol if cfg.atol is None else cfg.atol
    ctrl = PIController() if spec.controller is None else spec.controller
    # a zero-length segment (a save point on t0 or t1) is done at its start:
    # its solve returns its start unchanged
    n_seg = ts_save.shape[0]

    def solve_back(rhs, z, t_hi, t_lo, err_w=None):
        return integrate_while(rhs, z, t_hi, t_lo, None, solver, a_rtol, a_atol,
                               None, cfg.segment_max_steps, ctrl, err_weights=err_w)

    if cfg.kind == "quadrature":
        gl_x, gl_w = np.polynomial.legendre.leggauss(cfg.quad_order)
        gl_x = torch.as_tensor(gl_x, dtype=y0.dtype, device=y0.device)
        gl_w = torch.as_tensor(gl_w, dtype=y0.dtype, device=y0.device)
        n_sub = max(int(cfg.quad_subpanels), 1)
        frac = torch.arange(n_sub + 1, dtype=y0.dtype, device=y0.device) / n_sub

        def adj_rhs(t, lam, _):
            u = dense.evaluate(t)
            return -_vjp(f, t, u, leaves, build, lam, wrt_args=False)[1]

        def seg_mu(lam_dense, t_lo, t_hi):
            # ∫_{t_lo}^{t_hi} λᵀ ∂f/∂p dt in n_sub equal Gauss–Legendre panels
            edges = t_lo + (t_hi - t_lo) * frac
            total = None
            for lo, hi in zip(edges[:-1], edges[1:]):
                half = 0.5 * (hi - lo)
                tk = 0.5 * (hi + lo) + half * gl_x
                us, lams = dense.evaluate(tk), lam_dense.evaluate(tk)
                vals = torch.stack([
                    _vjp(f, tk[j], us[j], leaves, build, lams[j], wrt_y=False)[2]
                    for j in range(tk.shape[0])])
                panel = half * (gl_w @ vals)
                total = panel if total is None else total + panel
            return total

        z, mu = g_yfin, torch.zeros(n_p, dtype=y0.dtype, device=y0.device)
        t_hi = t1
        for i in range(n_seg - 1, -2, -1):
            t_lo = ts_save[i] if i >= 0 else t0
            res = solve_back(adj_rhs, z, t_hi, t_lo)
            if n_p:
                mu = mu + seg_mu(res.dense, t_lo, t_hi)
            z, ok = res.y_final, res.success & ok
            if i >= 0:
                z = z + g_ys[i]
            t_hi = t_lo
        y0_bar = z
    else:
        if cfg.kind == "interp":

            def adj_rhs(t, z, _):
                u = dense.evaluate(t)
                _, y_bar, a_bar = _vjp(f, t, u, leaves, build, z[:dim])
                return -torch.cat([y_bar, a_bar])

            z = torch.cat([g_yfin, g_yfin.new_zeros(n_p)])

            def at_boundary(z, i):
                return torch.cat([z[:dim] + g_ys[i], z[dim:]])

        else:  # backsolve: re-integrate the state backwards alongside the adjoint

            def adj_rhs(t, z, _):
                fval, y_bar, a_bar = _vjp(f, t, z[:dim], leaves, build,
                                          z[dim:2 * dim])
                return torch.cat([fval, -y_bar, -a_bar])

            y_final = buf_y[torch.clamp(num_points - 1, 0, buf_y.shape[0] - 1).reshape(1)][0]
            z = torch.cat([y_final, g_yfin, g_yfin.new_zeros(n_p)])

            def at_boundary(z, i):
                # reset the backsolved state to the stored forward value for
                # stability, and apply the loss jump to λ
                return torch.cat([ys_save[i], z[dim:2 * dim] + g_ys[i], z[2 * dim:]])

        err_w = None
        if cfg.seminorm:
            # controlled rows: λ (+ backsolved y); quadrature rows μ are free
            n_ctrl = dim if cfg.kind == "interp" else 2 * dim
            err_w = torch.cat([z.new_ones(n_ctrl), z.new_zeros(n_p)])

        t_hi = t1
        for i in range(n_seg - 1, -2, -1):
            t_lo = ts_save[i] if i >= 0 else t0
            res = solve_back(adj_rhs, z, t_hi, t_lo, err_w)
            z, ok = res.y_final, res.success & ok
            if i >= 0:
                z = at_boundary(z, i)
            t_hi = t_lo
        lam_at = slice(0, dim) if cfg.kind == "interp" else slice(dim, 2 * dim)
        y0_bar = z[lam_at]
        mu = z[lam_at.stop:]

    # A failed backward segment (segment_max_steps exhausted, dt underflow)
    # would return a silently wrong gradient: NaN-poison it instead.
    poison = lambda x: torch.where(ok, x, torch.full_like(x, float("nan")))  # noqa: E731
    return poison(y0_bar), unravel(poison(mu))
