"""Adaptive integration drivers: the stepping loops.

Port of ``universal_differential_equations_tpu/core/integrate.py``.  Both
drivers share one attempt-step core (solver-agnostic):

* ``integrate_while`` — forward-only stepping (``NoAdjoint``).
* ``integrate_scan`` — the bounded, differentiable loop behind
  ``DiscreteAdjoint`` and ``ForwardSensitivity``.  It also accumulates the
  differentiable ``err_sum``; ``checkpoint=True`` recomputes each attempt in
  the backward pass instead of storing its stages (outside ``torch.func``
  transforms, which refuse the checkpoint's saved-tensor hooks).
* ``integrate_fixed`` — equal steps with no controller, for one state or a
  leading lane dimension of independent states.  It does not cap steps at a
  stabilized solver's ``dt_stab`` (the adaptive drivers do), as in JAX.

The JAX drivers are one device program each (a ``while_loop`` or a
``max_steps``-long ``scan`` whose body passes the state through once ``done``
is set).  Here the loop runs eagerly on the host and stops at the first
attempt that starts with ``done`` set.  That check reads one flag from the
device per attempt; the loop is bound by the host launching a few hundred
small kernels per attempt, so the device has drained its queue by then and
the read costs about one kernel's latency.  Stopping early gives the same
result as running all ``max_steps`` attempts: after ``done`` the JAX scan
only appends ``+inf`` time slots, which sort past ``num_points`` and are
never read by the dense output.

Under ``torch.func.vmap`` the lanes share the loop: the check reduces
``done`` over every lane (``_AllDone``, whose ``vmap`` rule returns one
unbatched flag), and a lane that has finished passes through the remaining
attempts unchanged — its counters, dense-output slots (``+inf``) and error
sum are those of its solo solve, as in ``jax.vmap`` of the JAX drivers.
Where the loop's state carries no lane dimension (outside ``vmap``, or
under ``jacfwd``, whose ``vmap`` batches only tangents) no lane is ever
idle: the masking is skipped and the check is a plain read.

Step control reads detached primal values only (the counterpart of JAX's
``stop_gradient``), so ``torch.func.jacfwd`` and ``torch.func.jvp`` can carry
the loop: every Python branch is on a tensor that no transform has wrapped.
Step buffers are built out of place (lists, then ``torch.stack``), as JAX
builds them.

Everything integrates in *internal time* ``τ = direction · t``; rejected
attempts record ``+inf`` as their time, so one stable sort compacts the
accepted steps into the front of the dense-output buffer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch._C import _functorch
from torch.utils.checkpoint import checkpoint as _checkpoint

from .controller import PIController, hairer_norm, initial_step_size
from .solution import DenseInterpolation

__all__ = ["integrate_while", "integrate_scan", "integrate_fixed", "IntegrateResult"]


class _State(NamedTuple):
    t: torch.Tensor  # internal time τ
    y: torch.Tensor
    f: torch.Tensor  # RHS at (t, y), internal time
    dt: torch.Tensor  # proposed next step (positive, internal)
    err_prev: torch.Tensor
    n_acc: torch.Tensor
    n_rej: torch.Tensor
    nfe: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor


class IntegrateResult(NamedTuple):
    dense: DenseInterpolation
    t_final: torch.Tensor  # user time
    y_final: torch.Tensor
    success: torch.Tensor
    n_acc: torch.Tensor
    n_rej: torch.Tensor
    nfe: torch.Tensor
    # Σ over step attempts of the tolerance-normalized local error norm,
    # kept differentiable (arXiv:2105.03918); None on the while-loop path.
    err_sum: torch.Tensor = None


class _AllDone(torch.autograd.Function):
    """``done.all()``; under ``torch.func.vmap`` the reduction runs over every
    lane and the flag comes back unbatched, so the host can read it."""

    @staticmethod
    def forward(done):
        return done.all()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, done):
        return done.all(), None


def _has_lanes(*tensors) -> bool:
    """Whether any of ``tensors`` is batched by a ``vmap`` level (looking
    through the wrappers of the ``grad``/``jvp`` levels above it)."""
    for x in tensors:
        while x is not None:
            if _functorch.is_batchedtensor(x):
                return True
            x = _functorch.get_unwrapped(x) if _functorch.is_functorch_wrapped_tensor(x) else None
    return False


def _all_done(done, lanes: bool) -> bool:
    """Whether every lane of ``done`` is set: one read from the device."""
    return bool(_AllDone.apply(done) if lanes else done)


def _setup(f, y0, t0, t1, args, solver, rtol, atol, dt0):
    y0 = torch.as_tensor(y0)
    device = y0.device
    # Probe the RHS dtype: mixed-precision problems integrate in the
    # promoted dtype so the loop state keeps one dtype.
    f_probe = f(torch.as_tensor(t0, dtype=y0.dtype, device=device), y0, args)
    dtype = torch.promote_types(y0.dtype, f_probe.dtype)
    same_dtype = dtype == y0.dtype
    y0 = y0.to(dtype)
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    t1 = torch.as_tensor(t1, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    direction = torch.where(t1 >= t0, one, -one)

    def f_int(tau, y, a):
        return (direction * f(direction * tau, y, a)).to(dtype)

    tau0 = direction * t0
    tau1 = direction * t1
    # direction·τ0 is t0 exactly, so the probe already is f at the start
    f0 = (direction * f_probe).to(dtype) if same_dtype else f_int(tau0, y0, args)
    if dt0 is None:
        # on detached states: the result is detached anyway, and under
        # torch.func a 0-d float32 value combined with a Python scalar gets a
        # float64 tangent, which would otherwise reach the RHS through y0 + h0·f0
        dt_init = initial_step_size(
            f_int, tau0, y0.detach(), f0.detach(), solver.error_order, rtol, atol, args
        )
        nfe0 = 3
    else:
        dt_init = torch.as_tensor(dt0, dtype=dtype, device=device).abs()
        nfe0 = 1
    # Step-size control is non-differentiable by design (see the JAX
    # driver's note): gradients through dt choices are sub-tolerance
    # artifacts.
    dt_init = dt_init.detach()
    dt_init = torch.minimum(
        dt_init, torch.clamp(tau1 - tau0, min=torch.finfo(dtype).tiny))
    i32 = dict(dtype=torch.int32, device=device)
    state = _State(
        t=tau0,
        y=y0,
        f=f0,
        dt=dt_init,
        err_prev=torch.full((), 1e-4, dtype=dtype, device=device),
        n_acc=torch.zeros((), **i32),
        n_rej=torch.zeros((), **i32),
        nfe=torch.full((), nfe0, **i32),
        done=tau1 <= tau0,
        failed=torch.zeros((), dtype=torch.bool, device=device),
    )
    return f_int, state, tau0, tau1, direction, dtype


def _attempt(f_int, solver, controller, rtol, atol, tau1, state, args, dtype,
             tstops=None, track_err=False, err_weights=None, passthrough=False):
    """One controller-supervised step attempt.

    Returns ``(state', accept, t_new, y1, f1, err_diff)``; ``err_diff`` is
    None unless ``track_err``.  ``tstops`` (internal time, ascending) forces
    accepted steps to land exactly on those points.  ``err_weights`` makes
    the controller's error norm a seminorm (``hairer_norm``).  With
    ``passthrough`` a state that is already ``done`` comes back unchanged,
    with ``accept`` false, ``y1``/``f1`` its own and ``err_diff`` 0 (the JAX
    scan's ``lax.cond(state.done, passthrough, stepped)``).

    A stabilized explicit solver (the RKC/ROCK families) has a ``dt_stab``:
    the attempt's proposal is capped there first.
    """
    dt_prop = state.dt
    dt_stab = getattr(solver, "dt_stab", None)
    if dt_stab is not None:
        dt_prop = dt_prop.clamp(max=dt_stab)
    if tstops is None:
        next_stop = tau1
    else:
        n_stop = tstops.shape[0]
        # 1-element indices (a 0-d one is read back to the host under vmap of grad)
        idx = torch.searchsorted(tstops, state.t.reshape(1), right=True)
        next_ts = tstops[torch.clamp(idx, 0, n_stop - 1)][0]
        idx = idx[0]
        next_stop = torch.where(idx >= n_stop, tau1, torch.minimum(next_ts, tau1))
    dt_cap = next_stop - state.t
    clamped = dt_prop >= dt_cap
    dt = torch.where(clamped, dt_cap, dt_prop)
    y1, y_err, f1, nfe = solver.step(f_int, state.t, state.y, state.f, dt, args)
    # controller scalars are non-differentiable: computed from detached values
    y_det = state.y.detach()
    y1_det = y1.detach()
    err = hairer_norm(y_err.detach(), y_det, y1_det, rtol, atol, err_weights)
    err_diff = None
    if track_err:
        # differentiable error accumulator (arXiv:2105.03918), ε-smoothed, with
        # non-finite ratios zeroed so rejected blow-ups contribute nothing
        scale = atol + rtol * torch.maximum(y_det.abs(), y1_det.abs())
        ratio = y_err / scale
        ratio = torch.where(torch.isfinite(ratio), ratio, torch.zeros_like(ratio))
        err_diff = torch.sqrt(torch.mean(ratio * ratio) + 1e-12)
    accept = err <= 1.0
    dt_next, err_prev = controller.next_dt(
        dt, err, state.err_prev, accept, solver.error_order
    )
    # A step artificially shortened to hit a stop must not shrink the
    # controller's running proposal.
    dt_next = torch.where(clamped & accept, torch.maximum(dt_next, dt_prop), dt_next)
    t_new = torch.where(clamped, next_stop, state.t + dt)
    reached = accept & (t_new >= tau1)
    eps = torch.finfo(dtype).eps
    dt_min = 16.0 * eps * torch.maximum(state.t.abs(), tau1.abs())
    underflow = (dt_next < dt_min) & ~reached
    new = _State(
        t=torch.where(accept, t_new, state.t),
        y=torch.where(accept, y1, state.y),
        f=torch.where(accept, f1, state.f),
        dt=torch.clamp(dt_next, min=torch.finfo(dtype).tiny),
        err_prev=err_prev,
        n_acc=state.n_acc + accept.to(torch.int32),
        n_rej=state.n_rej + (~accept).to(torch.int32),
        nfe=state.nfe + nfe,
        done=state.done | reached | underflow,
        failed=state.failed | underflow,
    )
    if passthrough:
        idle = state.done
        new = _State(*(torch.where(idle, old, upd) for old, upd in zip(state, new)))
        accept = accept & ~idle
        y1 = torch.where(idle, state.y, y1)
        f1 = torch.where(idle, state.f, f1)
        if track_err:
            err_diff = torch.where(idle, torch.zeros_like(err_diff), err_diff)
    return new, accept, t_new, y1, f1, err_diff


def _loop(f, y0, t0, t1, args, solver, rtol, atol, dt0, max_steps, controller,
          tstops, track_err, checkpoint, err_weights=None):
    f_int, state, tau0, tau1, direction, dtype = _setup(
        f, y0, t0, t1, args, solver, rtol, atol, dt0
    )
    if tstops is not None:
        tstops = torch.sort(
            direction * torch.as_tensor(tstops, dtype=dtype, device=tau0.device).detach()
        ).values
    inf = torch.full((), float("inf"), dtype=dtype, device=tau0.device)
    # with lanes (the initial step and RHS see every batched input) a lane
    # may finish before the others: it then passes through
    passthrough = _has_lanes(state.f, state.dt, state.done, tstops)

    def attempt(*fields):
        new, accept, t_new, y1, f1, err_diff = _attempt(
            f_int, solver, controller, rtol, atol, tau1, _State(*fields), args,
            dtype, tstops, track_err=track_err, err_weights=err_weights,
            passthrough=passthrough,
        )
        return (*new, torch.where(accept, t_new, inf), y1, f1, err_diff)

    y0_arr, f0 = state.y, state.f
    out_t, out_y, out_f, out_err = [], [], [], []
    # torch.func.{grad, vjp, jacrev} refuse the saved-tensor hooks that
    # torch.utils.checkpoint installs, so under a torch.func transform the
    # attempts run uncheckpointed: the same numbers, with every attempt's
    # stages kept for the backward pass
    checkpoint = checkpoint and torch._C._functorch.peek_interpreter_stack() is None
    for _ in range(max_steps):
        if _all_done(state.done, passthrough):
            break
        if checkpoint and torch.is_grad_enabled():
            outs = _checkpoint(attempt, *state, use_reentrant=False)
        else:
            outs = attempt(*state)
        state = _State(*outs[:len(_State._fields)])
        t_rec, y1, f1, err_diff = outs[len(_State._fields):]
        out_t.append(t_rec)
        out_y.append(y1)
        out_f.append(f1)
        if track_err:
            out_err.append(err_diff)
    if not out_t:  # zero-length span: one idle slot, as the scan's passthrough
        out_t.append(inf)
        out_y.append(state.y)
        out_f.append(state.f)
        out_err.append(torch.zeros_like(inf))
    state = state._replace(failed=state.failed | ~state.done)
    err_sum = torch.stack(out_err).sum() if track_err else None

    # Prepend the initial point, then sort: accepted times are increasing and
    # rejected slots hold +inf, so a stable argsort compacts the valid prefix.
    buf_t = torch.cat([tau0.reshape(1), torch.stack(out_t)])
    buf_y = torch.cat([y0_arr[None], torch.stack(out_y)])
    buf_f = torch.cat([f0[None], torch.stack(out_f)])
    order = torch.argsort(buf_t, stable=True)
    dense = DenseInterpolation(
        ts=buf_t[order], ys=buf_y[order], fs=buf_f[order],
        num_points=state.n_acc + 1, direction=direction,
        nodes=getattr(solver, "dense_nodes", 2),
    )
    return IntegrateResult(
        dense=dense,
        t_final=direction * state.t,
        y_final=state.y,
        success=~state.failed & state.done,
        n_acc=state.n_acc,
        n_rej=state.n_rej,
        nfe=state.nfe,
        err_sum=err_sum,
    )


def integrate_while(
    f, y0, t0, t1, args, solver, rtol, atol, dt0=None, max_steps=4096,
    controller=PIController(), tstops=None, err_weights=None,
):
    """Forward-only adaptive solve: at most ``max_steps`` attempts.

    ``err_weights`` (same shape as the state) excludes its zero-weight
    components from step control (the adjoint seminorm).
    """
    return _loop(f, y0, t0, t1, args, solver, rtol, atol, dt0, max_steps,
                 controller, tstops, track_err=False, checkpoint=False,
                 err_weights=err_weights)


def integrate_scan(
    f, y0, t0, t1, args, solver, rtol, atol, dt0=None, max_steps=1024,
    controller=PIController(), checkpoint=True, tstops=None,
):
    """Bounded differentiable adaptive solve (reverse and forward mode)."""
    return _loop(f, y0, t0, t1, args, solver, rtol, atol, dt0, max_steps,
                 controller, tstops, track_err=True, checkpoint=checkpoint)


def integrate_fixed(f, y0, t0, t1, args, solver, n_steps):
    """Fixed-step integration over ``n_steps`` equal steps (no controller).

    Differentiable in both modes.  ``y0`` is one state ``(d,)`` or a lane
    batch ``(L, d)`` of independent states sharing the time grid; for lanes,
    ``f(t, y, args)`` receives the ``(L, d)`` batch with ``args`` batched
    along ``L`` as the caller built them, and must act on each lane alone —
    the counterpart of ``jax.vmap(integrate_fixed)``.  Returns ``(ts, ys)``
    including the initial point: ``ts`` is ``(n_steps+1,)``; ``ys`` is
    ``(n_steps+1, d)`` for one state and ``(L, n_steps+1, d)`` for lanes.
    """
    y0 = torch.as_tensor(y0)
    dtype, device = y0.dtype, y0.device
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    t1 = torch.as_tensor(t1, dtype=dtype, device=device)
    dt = (t1 - t0) / n_steps
    t, y = t0, y0
    fval = f(t0, y0, args)
    ts, ys = [t0], [y0]
    for i in range(n_steps):
        y, _, fval, _ = solver.step(f, t, y, fval, dt, args)
        t = t0 + (i + 1) * dt
        ts.append(t)
        ys.append(y)
    ys = torch.stack(ys)
    return torch.stack(ts), (ys.movedim(0, 1) if y0.ndim == 2 else ys)
