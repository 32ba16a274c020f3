"""Variable-order BDF solver for implicit DAEs ``F(t, u, u') = 0``.

Port of ``universal_differential_equations_tpu/solvers/bdf.py``, the
counterpart of Sundials IDA in the reference (``FENEP.jl:35-39``):
variable-step, variable-order BDF (orders 1-5) with a modified-Newton
corrector whose iteration matrix ``∂F/∂u + (α₀/h)·∂F/∂u'`` comes from
``torch.func.jacrev`` (``jax.jacfwd`` in the JAX package; ``solvers/sdirk.py``
says why reverse mode) and factorizes as one dense LU per step attempt.

* The BDF-k derivative formula on the actual past times: its weights are the
  derivative of the Lagrange interpolant through ``{t_{n+1}, t_n, …,
  t_{n+1-k}}`` at ``t_{n+1}``.
* The local truncation error from Newton divided differences of the
  corrected solution against the history: ``LTE_q ≈ dd[t_{n+1},…,t_{n-q}]
  · ∏(t_{n+1}-t_j) / (q+1)``.
* DASSL-style order selection among k-1, k, k+1; the order is capped by
  the history available, so the startup ramps 1→5 one order per accepted
  step.
* Index-1 DAEs with a ``differential_vars`` mask, algebraic variables
  excluded from the error test (IDA's ``suppressalg``), consistent
  initialization (IDA ``calcIC``, :func:`initialize_dae`), ``max_order``.

Where the JAX package runs one ``lax.while_loop``, the port runs a host loop
of attempts.  Each attempt reads one flag from the device, ``done``, through
``core/integrate.py``'s ``_all_done`` (which reduces over lanes under
``torch.func.vmap``), and nothing else: the live order indexes the per-order
weights, predictors and error estimates by a device tensor, and
accept/reject, order and step selection and the underflow stop are tensor
ops.  The weights of every candidate order are computed at once, as masked
products over the node differences (``_bdf_rows``, ``_lagrange_rows``),
where the JAX package loops over orders.  The factorization is
``torch.linalg.lu_factor_ex``: a singular iteration matrix gives inf/NaN
Newton steps, which fail ``newton_ok`` and reject the attempt, as in JAX.
Accepted points and rejected attempts (time ``+inf``) are collected in
lists and compacted by one stable sort, as the ODE integration loops do.

The BDF derivative ``w0·u + Σ wⱼuⱼ`` cancels: at order 5 on the startup's
growing steps the weights reach 1e10 against a derivative of order 1, so a
one-ulp difference in a stored state grows about 3000-fold per step.  XLA
fuses ``w0·u + rest`` into one fused multiply-add; so does the port
(``torch.addcmul``), which keeps the two packages' accepted and rejected
counts equal where two roundings would part them.

``x64_host="auto"``: stiff-DAE Newton needs double precision (IDA is
double-only for the same reason).  A float32 problem is solved in float64
on the state's own device and the result cast back; the JAX package moves
that solve to the host CPU only because a TPU has no usable float64.  The
upcast is skipped when an input requires grad or is wrapped by a
``torch.func`` transform (JAX skips it for tracers).  ``"never"`` solves in
the problem's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch._C import _functorch

from ..core.integrate import _all_done, _has_lanes
from ..core.problem import DAEProblem
from ..core.solution import DenseInterpolation, Solution
from ..flatten_util import ravel_pytree, tree_flatten_with_path
from .sdirk import _factor

__all__ = ["daeint", "initialize_dae"]

_NEWTON_ITERS = 8
_NEWTON_TOL_FACTOR = 0.33
_MAX_ORDER = 5
_HIST = _MAX_ORDER + 1  # history slots: u_n … u_{n-5}


def _flat_mask(differential_vars, like):
    """The ``differential_vars`` tree as a flat bool vector on ``like``'s
    device (all True when it is None)."""
    if differential_vars is None:
        return torch.ones(like.shape, dtype=torch.bool, device=like.device)
    pairs, _ = tree_flatten_with_path(differential_vars)
    return torch.cat([torch.as_tensor(leaf, device=like.device).reshape(-1)
                      for _, leaf in pairs]).to(torch.bool)


def _value_and_jacobian(fn, x):
    """``(fn(x), ∂fn/∂x)`` with one evaluation of ``fn``."""
    jac, value = torch.func.jacrev(lambda z: (fn(z),) * 2, has_aux=True)(x)
    return value, jac


def initialize_dae(problem: DAEProblem, newton_iters: int = 20):
    """Consistent initialization (IDA ``calcIC``).

    Holds the differential components of ``u0`` fixed and solves
    ``F(t0, u0, du0) = 0`` for the algebraic components of ``u0`` plus the
    differential components of ``du0`` (algebraic ``du0`` components are
    irrelevant for index-1 systems and left untouched).  Returns
    ``(u0, du0, max|F|)``.  A singular Newton matrix gives inf/NaN (as
    ``jnp.linalg.solve`` does) rather than an exception.
    """
    u0, unravel_u = ravel_pytree(problem.u0)
    du0, _ = ravel_pytree(problem.du0)
    diff_mask = _flat_mask(problem.differential_vars, u0)
    F = problem.f
    t0 = torch.as_tensor(problem.tspan[0], dtype=u0.dtype, device=u0.device)

    def residual(z):
        u = torch.where(diff_mask, u0, z)  # algebraic u from z
        du = torch.where(diff_mask, z, du0)  # differential du from z
        return ravel_pytree(F(t0, unravel_u(u), unravel_u(du), problem.args))[0]

    z = torch.where(diff_mask, du0, u0)
    for _ in range(newton_iters):
        r, J = _value_and_jacobian(residual, z)
        z = z - torch.linalg.solve_ex(J, r)[0]
    u0_new = torch.where(diff_mask, u0, z)
    du0_new = torch.where(diff_mask, z, du0)
    res_norm = residual(z).abs().max()
    return unravel_u(u0_new), unravel_u(du0_new), res_norm


def _node_masks(keep):
    """For a (Q, n) prefix mask ``keep``: the (Q, n, n) mask of the factors
    ``m ≠ j`` with ``m`` in row ``q``'s node set."""
    n = keep.shape[1]
    off = ~torch.eye(n, dtype=torch.bool, device=keep.device)
    return keep[:, None, :] & off


def _bdf_rows(nodes, keep):
    """First-derivative Lagrange weights at ``nodes[0]``, one row per node
    set ``nodes[keep[q]]`` (each a prefix holding ``nodes[0]``), zero outside
    the set: ``w[0] = Σ_{m≠0} 1/(x0-x_m)``;
    ``w[j≠0] = ∏_{m≠j,0}(x0-x_m) / ∏_{m≠j}(x_j-x_m)``."""
    x0 = nodes[0]
    d0 = x0 - nodes  # x0 - x_m
    not0 = torch.arange(nodes.shape[0], device=nodes.device) != 0
    pair = _node_masks(keep)
    w0 = torch.where(keep & not0, 1.0 / torch.where(not0, d0, 1.0), 0.0).sum(-1)
    num = torch.where(pair & not0, d0, 1.0).prod(-1)
    diff = nodes[:, None] - nodes[None, :]  # x_j - x_m
    den = torch.where(pair, diff, 1.0).prod(-1)
    w = torch.where(keep & not0, num / torch.where(not0, den, 1.0), 0.0)
    return torch.where(not0, w, w0[:, None])


def _lagrange_rows(xs, x, keep):
    """Lagrange basis values at ``x``, one row per node set ``xs[keep[q]]``,
    zero outside the set (extrapolation)."""
    pair = _node_masks(keep)
    num = torch.where(pair, x - xs, 1.0).prod(-1)
    den = torch.where(pair, xs[:, None] - xs[None, :], 1.0).prod(-1)
    return torch.where(keep, num / den, 0.0)


def _bdf_weights(nodes):
    """First-derivative Lagrange weights at ``nodes[0]`` for all ``nodes``:
    ``u'(nodes[0]) ≈ Σ w[j]·u(nodes[j])``."""
    keep = torch.ones((1, nodes.shape[0]), dtype=torch.bool, device=nodes.device)
    return _bdf_rows(nodes, keep)[0]


def _lagrange_eval_weights(xs, x):
    """Lagrange basis values at ``x`` for nodes ``xs`` (extrapolation)."""
    keep = torch.ones((1, xs.shape[0]), dtype=torch.bool, device=xs.device)
    return _lagrange_rows(xs, x, keep)[0]


class _DAEState(NamedTuple):
    t_hist: torch.Tensor  # (HIST,) accepted times, slot 0 newest
    u_hist: torch.Tensor  # (HIST, dim)
    du: torch.Tensor  # derivative at the newest point (dense output, k=1 pred)
    k: torch.Tensor  # current BDF order (int64, 1..max_order)
    n_pts: torch.Tensor  # valid history points (int64, ≥1)
    dt: torch.Tensor
    n_acc: torch.Tensor
    n_rej: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor


def _is_transformed(tree) -> bool:
    """Whether a tensor leaf of ``tree`` requires grad or is wrapped by a
    ``torch.func`` transform (the counterpart of a JAX tracer)."""
    for _, leaf in tree_flatten_with_path(tree)[0]:
        if torch.is_tensor(leaf) and (
                leaf.requires_grad or _functorch.is_functorch_wrapped_tensor(leaf)):
            return True
    return False


def _cast_floats(tree, dtype):
    """``tree`` with its floating tensor leaves cast to ``dtype``."""
    pairs, build = tree_flatten_with_path(tree)
    return build([leaf.to(dtype) if torch.is_tensor(leaf) and leaf.is_floating_point()
                  else leaf for _, leaf in pairs])


def _daeint_float64(problem, saveat, dtype, **kw):
    """``daeint`` of ``problem`` in float64 on its own device, cast back to
    ``dtype``."""
    to64 = lambda tree: _cast_floats(tree, torch.float64)  # noqa: E731
    prob64 = dataclasses.replace(problem, u0=to64(problem.u0), du0=to64(problem.du0),
                                 args=to64(problem.args))
    sol = daeint(prob64, saveat=saveat, x64_host="never", **kw)
    back = lambda tree: _cast_floats(tree, dtype)  # noqa: E731
    interp = sol.dense
    if interp is not None:
        interp = dataclasses.replace(interp, ts=back(interp.ts), ys=back(interp.ys),
                                     fs=back(interp.fs), direction=back(interp.direction))
    return dataclasses.replace(
        sol, ts=back(sol.ts), ys=back(sol.ys), t_final=back(sol.t_final),
        y_final=back(sol.y_final), dense=interp, _unravel=ravel_pytree(problem.u0)[1])


def daeint(
    problem: DAEProblem,
    *,
    saveat=None,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    dt0: Optional[float] = None,
    max_steps: int = 4096,
    max_order: int = _MAX_ORDER,
    initialize: bool = True,
    dense: bool = False,
    x64_host: str = "auto",
) -> Solution:
    """Solve an index-1 DAE on the state's device; returns a ``Solution`` on
    the ``saveat`` grid (the two ends of ``tspan`` when it is None).

    ``x64_host="auto"`` solves a float32 (or narrower) problem in float64 on
    its own device and returns the caller's dtype, unless an input requires
    grad or is wrapped by a ``torch.func`` transform; ``"never"`` keeps the
    problem's dtype.  ``num_rhs_evals`` counts 8 residual evaluations per
    attempt, as the JAX package does.
    """
    max_order = int(max_order)
    if not 1 <= max_order <= _MAX_ORDER:
        raise ValueError(f"max_order must be 1..{_MAX_ORDER}, got {max_order}")
    dtype0 = ravel_pytree(problem.u0)[0].dtype
    if (x64_host == "auto" and dtype0.is_floating_point and dtype0 != torch.float64
            and not _is_transformed((problem.u0, problem.du0, problem.args,
                                     problem.tspan, saveat))):
        return _daeint_float64(problem, saveat, dtype0, rtol=rtol, atol=atol, dt0=dt0,
                               max_steps=max_steps, max_order=max_order,
                               initialize=initialize, dense=dense)
    u0_tree, du0_tree = problem.u0, problem.du0
    if initialize:
        u0_tree, du0_tree, _ = initialize_dae(problem)
    u0, unravel = ravel_pytree(u0_tree)
    du0, _ = ravel_pytree(du0_tree)
    dtype, device = u0.dtype, u0.device
    dim = u0.shape[0]
    t0, t1 = (torch.as_tensor(t, dtype=dtype, device=device) for t in problem.tspan)
    diff_mask = _flat_mask(problem.differential_vars, u0)
    err_mask = diff_mask.to(dtype)  # suppressalg: exclude algebraic vars
    F = problem.f
    args = problem.args

    def res_flat(t, u, du):
        return ravel_pytree(F(t, unravel(u), unravel(du), args))[0]

    if dt0 is None:
        scale0 = atol + rtol * u0.abs()
        d1 = torch.sqrt(torch.mean((du0 / scale0) ** 2))
        dt_init = torch.minimum(torch.clamp(0.01 / torch.clamp(d1, min=1e-8), min=1e-8),
                                (t1 - t0) * 0.1)
    else:
        dt_init = torch.as_tensor(dt0, dtype=dtype, device=device)

    inf = torch.full((), float("inf"), dtype=dtype, device=device)
    # Unused history slots get distinct fake times (never selected, but they
    # flow through all per-order weight computations — keep them NaN-free).
    t_hist0 = t0 - dt_init * torch.arange(_HIST, dtype=dtype, device=device)
    u_hist0 = u0.unsqueeze(0).repeat(_HIST, 1)

    # Row q-1 of the per-order tables is order q: BDF-q weights over
    # {t_new, t_hist[:q]} and the predictor over t_hist[:q+1], q+1 nodes each.
    Q = max_order
    qs = torch.arange(1, Q + 1, device=device)
    qs_f = qs.to(dtype)
    keep = torch.arange(Q + 1, device=device)[None, :] <= qs[:, None]  # (Q, Q+1)
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny

    def attempt(s):
        dt = torch.minimum(s.dt, t1 - s.t_hist[0])
        clamped = s.dt >= (t1 - s.t_hist[0])
        t_new = torch.where(clamped, t1, s.t_hist[0] + dt)
        nodes = torch.cat([t_new[None], s.t_hist])  # (HIST+1,)

        # BDF-q derivative weights and predictors for every candidate order;
        # the live order selects its row by a device index.
        W = _bdf_rows(nodes[:Q + 1], keep)  # (Q, Q+1)
        rests = W[:, 1:] @ s.u_hist[:Q]
        preds = _lagrange_rows(s.t_hist[:Q + 1], t_new, keep) @ s.u_hist[:Q + 1]
        row = (s.k - 1).reshape(1)
        w0 = W[row, 0][0]
        rest = rests[row][0]
        u_pred = preds[row][0]
        # order 1: Hermite predictor using the known derivative
        u_pred = torch.where(s.k == 1, torch.addcmul(s.u_hist[0], dt, s.du), u_pred)

        def G(v):
            return res_flat(t_new, v, torch.addcmul(rest, w0, v))

        g, J = _value_and_jacobian(G, u_pred)
        solve = _factor(J)
        scale = atol + rtol * s.u_hist[0].abs()

        v, dvs = u_pred, []
        for i in range(_NEWTON_ITERS):
            if i:
                g = G(v)
            dvs.append(solve(g))
            v = v - dvs[-1]
        u_new = v
        # every iteration's scaled step norm at once: all finite, the last
        # below the tolerance factor
        step_norms = torch.sqrt(torch.mean((torch.stack(dvs) / scale) ** 2, dim=-1))
        newton_ok = torch.isfinite(step_norms).all() & (step_norms[-1] < _NEWTON_TOL_FACTOR)

        # Divided differences over {t_new, history}: dd[L] is the L-th order
        # divided difference over nodes[0..L].
        d = torch.cat([u_new[None], s.u_hist])  # (HIST+1, dim)
        dd = []
        for L in range(1, Q + 2):
            d = (d[:-1] - d[1:]) / (nodes[: _HIST + 1 - L] - nodes[L:])[:, None]
            dd.append(d[0])

        # LTE estimate at order q: dd_{q+1} · ∏_{j=0}^{q}(t_new - t_hist[j])
        # / (q+1); valid when q+1 history points exist.
        prods = torch.cumprod(t_new - s.t_hist[:Q + 1], 0)[1:]  # (Q,)
        est = torch.stack(dd[1:]) * prods[:, None] / (qs_f + 1.0)[:, None]
        errs_all = torch.sqrt(torch.mean((est * err_mask / scale) ** 2, dim=-1))
        errs_all = torch.where(torch.isfinite(errs_all), errs_all, 1e10)
        # first step: no second history point — Hermite-predictor difference
        est0 = 0.5 * (u_new - u_pred) * err_mask
        err_first = torch.sqrt(torch.mean((est0 / scale) ** 2))
        err_first = torch.where(torch.isfinite(err_first), err_first, 1e10)
        first = s.n_pts == 1
        err_k = torch.where(first, err_first, errs_all[row][0])
        err_k = torch.where(newton_ok, err_k, 1e10)
        accept = err_k <= 1.0

        # ---- order & step selection (DASSL-style): candidate orders
        # {k-1, k, k+1} → step factors; the largest permissible step wins.
        facs = 0.9 * torch.clamp(errs_all, min=1e-10) ** (-1.0 / (qs_f + 1.0))
        n_pts_new = torch.clamp(s.n_pts + accept.to(s.n_pts.dtype), max=_HIST)
        # validity: order q's divided-difference error estimate reads q+1
        # real history points (so the startup ramps one order per accepted
        # step), and only neighbours of the current order are eligible.
        valid = (qs <= s.n_pts - 1) & ((qs - s.k).abs() <= 1)
        facs = torch.where(valid, facs, -inf)
        k_best = torch.argmax(facs) + 1
        fac_best = torch.clamp(facs[(k_best - 1).reshape(1)][0], 0.2, 2.5)
        fac_first = torch.clamp(0.9 * torch.clamp(err_first, min=1e-10) ** (-0.5), 0.2, 2.5)
        k_next = torch.where(first, torch.ones_like(s.k), k_best)
        fac = torch.where(first, fac_first, fac_best)
        # rejection: shrink on the current order, drop an order if it helps
        err_down = errs_all[torch.clamp(s.k - 2, min=0).reshape(1)][0]
        drop = (~first) & (s.k > 1) & (err_down < err_k)
        k_rej = torch.where(drop, s.k - 1, s.k)
        fac_rej = torch.clamp(
            0.9 * torch.clamp(err_k, min=1e-10) ** (-1.0 / (s.k.to(dtype) + 1.0)), 0.1, 0.9)
        k_new = torch.where(accept, k_next, k_rej)
        dt_next = dt * torch.where(accept, fac, fac_rej)
        dt_next = torch.where(clamped & accept, torch.maximum(dt_next, s.dt), dt_next)

        du_new = torch.addcmul(rest, w0, u_new)
        du_new = torch.where(first, (u_new - s.u_hist[0]) / dt, du_new)

        underflow = (dt_next < 16.0 * eps * torch.maximum(s.t_hist[0].abs(), t1.abs())) & ~(
            accept & clamped)
        t_hist_acc = torch.cat([t_new[None], s.t_hist[:-1]])
        u_hist_acc = torch.cat([u_new[None], s.u_hist[:-1]])
        new = _DAEState(
            t_hist=torch.where(accept, t_hist_acc, s.t_hist),
            u_hist=torch.where(accept, u_hist_acc, s.u_hist),
            du=torch.where(accept, du_new, s.du),
            k=k_new,
            n_pts=torch.where(accept, n_pts_new, s.n_pts),
            dt=torch.clamp(dt_next, min=tiny),
            n_acc=s.n_acc + accept.to(torch.int32),
            n_rej=s.n_rej + (~accept).to(torch.int32),
            done=s.done | (accept & clamped) | underflow,
            failed=s.failed | underflow,
        )
        return new, accept, t_new, u_new, du_new

    i32 = dict(dtype=torch.int32, device=device)
    s = _DAEState(
        t_hist=t_hist0, u_hist=u_hist0, du=du0,
        k=torch.ones((), dtype=torch.int64, device=device),
        n_pts=torch.ones((), dtype=torch.int64, device=device),
        dt=dt_init,
        n_acc=torch.zeros((), **i32), n_rej=torch.zeros((), **i32),
        done=t1 <= t0, failed=torch.zeros((), dtype=torch.bool, device=device),
    )
    # under torch.func.vmap a finished lane passes through the remaining
    # attempts, as under jax.vmap of the JAX while_loop
    lanes = _has_lanes(s.t_hist, s.u_hist, s.du, s.dt, s.done)
    out_t, out_y, out_f = [], [], []
    for _ in range(max_steps):
        if _all_done(s.done, lanes):
            break
        new, accept, t_new, u_new, du_new = attempt(s)
        if lanes:
            new = _DAEState(*(torch.where(s.done, old, upd) for old, upd in zip(s, new)))
            accept = accept & ~s.done
        s = new
        out_t.append(torch.where(accept, t_new, inf))
        out_y.append(u_new)
        out_f.append(du_new)
    if not out_t:  # zero-length span: one idle slot
        out_t.append(inf)
        out_y.append(u0)
        out_f.append(du0)
    failed = s.failed | ~s.done

    # Accepted times are increasing and rejected slots hold +inf, so a
    # stable argsort compacts the accepted points behind the initial one.
    buf_t = torch.cat([t0.reshape(1), torch.stack(out_t)])
    order = torch.argsort(buf_t, stable=True)
    # nodes=3: quintic Hermite windows over (t, u, u') — u' is the consistent
    # DAE derivative the Newton solve produces for every component, so the
    # window is a true Hermite interpolant; O(h^6) covers BDF's max order 5.
    interp = DenseInterpolation(
        ts=buf_t[order],
        ys=torch.cat([u0[None], torch.stack(out_y)])[order],
        fs=torch.cat([du0[None], torch.stack(out_f)])[order],
        num_points=s.n_acc + 1,
        direction=torch.ones((), dtype=dtype, device=device), nodes=3,
    )
    if saveat is None:
        ts = torch.stack([t0, t1])
    else:
        ts = torch.as_tensor(saveat, dtype=dtype, device=device)
    return Solution(
        ts=ts,
        ys=unravel(interp.evaluate(ts)),
        t_final=s.t_hist[0],
        y_final=unravel(s.u_hist[0]),
        success=~failed,
        num_accepted=s.n_acc,
        num_rejected=s.n_rej,
        num_rhs_evals=(s.n_acc + s.n_rej) * _NEWTON_ITERS,
        dense=interp if dense else None,
        _unravel=unravel,
    )
