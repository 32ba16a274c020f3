"""BFGS with a strong-Wolfe line search, for one parameter set or a batch of lanes.

Port of ``universal_differential_equations_tpu/train/bfgs.py``: dense inverse
Hessian (the models here are tiny), curvature-guarded update with a reset on
ascent directions, Nocedal & Wright Alg. 3.5/3.6 bracketing + zoom, Optim.jl's
``initial_stepnorm`` (``scenario_1.jl:117``) and ``allow_f_increases``
(``hudson_bay.jl:147``), and one reset-Hessian retry after a failed line
search.

The loop is written once, over a leading lane dimension: every carry has one
entry per lane, and a lane's entries stop changing once it is done — the
semantics of ``jax.vmap(bfgs_minimize)``, whose batched ``while_loop`` runs
the body for every lane and keeps finished lanes fixed.  ``bfgs_minimize``
runs one lane over a pytree of parameters; ``bfgs_minimize_lanes`` runs
``L`` independent problems whose loss returns an ``(L,)`` vector (lanes are
independent, so the gradient of its sum is each lane's gradient).  Each
evaluation serves every lane at its own point, and the host reads one flag
per evaluation to decide whether to go on.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..flatten_util import ravel_pytree
from ..utils.profiling import count, span

__all__ = ["bfgs_minimize", "bfgs_minimize_lanes", "BFGSResult"]


class BFGSResult(NamedTuple):
    params: object
    value: torch.Tensor
    grad_norm: torch.Tensor
    iterations: torch.Tensor
    num_evals: torch.Tensor
    converged: torch.Tensor
    loss_history: torch.Tensor  # (maxiters,), +inf past convergence


_C1, _C2, _LS_MAXITER = 1e-4, 0.9, 25  # strong-Wolfe constants and trial budget


class _Search:
    """Per-lane strong-Wolfe line-search state (Nocedal & Wright Alg. 3.5/3.6):
    ``stage`` 0 brackets, 1 zooms, 2 is done; ``i`` counts trials."""

    def __init__(self, f0, g0, p, alpha0):
        zeros = torch.zeros_like(f0)
        self.p, self.f0, self.g0 = p, f0, g0
        self.dg0 = (g0 * p).sum(-1)
        self.i = torch.zeros(f0.shape, dtype=torch.int32, device=f0.device)
        self.stage = torch.zeros_like(self.i)
        self.a_prev, self.f_prev, self.dg_prev = zeros, f0, self.dg0
        self.a_cur = torch.full_like(f0, alpha0)
        self.a_lo, self.f_lo, self.dg_lo, self.a_hi = zeros, f0, self.dg0, zeros
        self.star_a, self.star_f, self.star_g = zeros, f0, g0

    def restart(self, new, other):
        """Lanes where ``new`` holds take ``other``'s state (a fresh search)."""
        for name, val in list(vars(self).items()):
            nv = getattr(other, name)
            m = new.reshape(new.shape + (1,) * (val.ndim - 1))
            setattr(self, name, torch.where(m, nv, val))

    def trial(self):
        return torch.where(self.stage == 0, self.a_cur, 0.5 * (self.a_lo + self.a_hi))

    def update(self, run, a, f, g):
        """Advance the lanes in ``run`` by their evaluation ``(f, g)`` at ``a``."""
        p, f0, dg0 = self.p, self.f0, self.dg0
        dg = (g * p).sum(-1)
        armijo_fail = f > f0 + _C1 * a * dg0
        curv_ok = dg.abs() <= -_C2 * dg0
        i = self.i

        # bracket stage
        hi_found = armijo_fail | ((f >= self.f_prev) & (i > 0))
        to_done = ~hi_found & curv_ok
        to_rev = ~hi_found & ~curv_ok & (dg >= 0)
        b_stage = torch.where(to_done, 2, torch.where(hi_found | to_rev, 1, 0))
        b_a_lo = torch.where(hi_found, self.a_prev, torch.where(to_rev, a, self.a_lo))
        b_f_lo = torch.where(hi_found, self.f_prev, torch.where(to_rev, f, self.f_lo))
        b_dg_lo = torch.where(hi_found, self.dg_prev, torch.where(to_rev, dg, self.dg_lo))
        b_a_hi = torch.where(hi_found, a, torch.where(to_rev, self.a_prev, self.a_hi))

        # zoom stage
        shrink_hi = armijo_fail | (f >= self.f_lo)
        z_done = ~shrink_hi & curv_ok
        flip = ~shrink_hi & ~curv_ok & (dg * (self.a_hi - self.a_lo) >= 0)
        new_lo = ~shrink_hi & ~z_done
        z_stage = torch.where(z_done, 2, 1)
        z_a_hi = torch.where(shrink_hi, a, torch.where(flip, self.a_lo, self.a_hi))
        z_a_lo = torch.where(new_lo, a, self.a_lo)
        z_f_lo = torch.where(new_lo, f, self.f_lo)
        z_dg_lo = torch.where(new_lo, dg, self.dg_lo)
        # keep the best Armijo point in case zoom exhausts its budget
        z_star = z_done | (~z_done & (f < self.star_f) & ~armijo_fail)

        br = self.stage == 0
        upd = lambda b, z, old: torch.where(run, torch.where(br, b, z), old)  # noqa: E731
        take = run & torch.where(br, to_done, z_star)
        self.stage = upd(b_stage, z_stage, self.stage).to(torch.int32)
        self.a_lo, self.f_lo = upd(b_a_lo, z_a_lo, self.a_lo), upd(b_f_lo, z_f_lo, self.f_lo)
        self.dg_lo, self.a_hi = upd(b_dg_lo, z_dg_lo, self.dg_lo), upd(b_a_hi, z_a_hi, self.a_hi)
        # only the bracket stage moves the previous point and the next trial
        self.a_prev = upd(a, self.a_prev, self.a_prev)
        self.f_prev = upd(f, self.f_prev, self.f_prev)
        self.dg_prev = upd(dg, self.dg_prev, self.dg_prev)
        self.a_cur = upd(2.0 * a, self.a_cur, self.a_cur)
        self.star_a = torch.where(take, a, self.star_a)
        self.star_f = torch.where(take, f, self.star_f)
        self.star_g = torch.where(take[:, None], g, self.star_g)
        self.i = i + run.to(torch.int32)

    def ended(self):
        return (self.stage == 2) | (self.i >= _LS_MAXITER)

    def result(self):
        """``(alpha, f, g, ok)``: the Wolfe point; when the budget ran out
        without one, the best Armijo point found, or ``a_lo``."""
        found = (self.stage == 2) | (self.star_a > 0)
        return torch.where(found, self.star_a, self.a_lo), self.star_f, self.star_g, found


def _bfgs_lanes(fun, x0, maxiters, gtol, ftol, initial_stepnorm, allow_f_increases,
                value_and_grad=False):
    """The BFGS loop over ``x0`` of shape ``(L, n)``; ``fun`` maps (L, n) → (L,)
    (or to ``(values, gradients)`` with ``value_and_grad``).

    Each lane runs its own iterations and line searches, and each evaluation
    of ``fun`` serves every lane at its own trial point: a lane whose line
    search ends starts its next iteration on the next evaluation instead of
    waiting for the other lanes' searches.  A lane's arithmetic is what
    ``jax.vmap(bfgs_minimize)`` does for it; the evaluations of the batch
    are the most any lane needs in all, not the sum over iterations of the
    most any lane needs in that iteration.

    While a profiler records, the loop marks its host work (``bfgs.read``,
    the flag read that waits for the device, then ``bfgs.evaluate``,
    ``bfgs.search`` and ``bfgs.update``) and counts ``bfgs.lanes`` (L, once),
    ``bfgs.evaluations`` (one per pass; the first evaluation, before the
    loop, is not one) and, at the end, ``bfgs.lane_trials``: the passes
    summed over the lanes that were searching in each, a device tensor read
    only with the record.
    """
    dtype, device = x0.dtype, x0.device
    L, n = x0.shape
    count("bfgs.lanes", L)

    def fg(x):
        if value_and_grad:
            f, g = fun(x.detach())
        else:
            with torch.enable_grad():
                x = x.detach().requires_grad_(True)
                f = fun(x)
                (g,) = torch.autograd.grad(f.sum(), x)
        # pin the loss to the parameter dtype (an f32 model's loss can promote
        # to f64 through Python time scalars)
        return f.detach().to(dtype), g.detach().to(dtype)

    x = x0.detach()
    f, g = fg(x)
    eye = torch.eye(n, dtype=dtype, device=device)
    hinv = eye.expand(L, n, n).clone()
    k = torch.zeros(L, dtype=torch.int32, device=device)
    nfev = torch.ones_like(k)
    nfev_ls = torch.zeros_like(k)
    done = torch.zeros(L, dtype=torch.bool, device=device)
    converged = torch.zeros_like(done)
    fails = torch.zeros_like(k)
    history = torch.full((L, maxiters), float("inf"), dtype=dtype, device=device)
    slots = torch.arange(maxiters, device=device)

    def direction():
        p = -(hinv @ g[:, :, None])[:, :, 0]
        # reset to steepest descent on an ascent/indefinite direction
        p = torch.where(((p * g).sum(-1) >= 0)[:, None], -g, p)
        if initial_stepnorm is not None:
            pnorm = torch.linalg.vector_norm(p, dim=-1)
            scale = torch.where(k == 0, initial_stepnorm / torch.clamp(pnorm, min=1e-30),
                                torch.ones_like(pnorm))
            p = p * scale[:, None]
        return _Search(f, g, p, 1.0)

    searching = k < maxiters
    ls = direction()
    while True:
        with span("bfgs.read", waits=True):
            if not bool(searching.any()):  # the one device-to-host read per evaluation
                break
        count("bfgs.evaluations")
        with span("bfgs.evaluate"):
            a = torch.where(searching, ls.trial(), torch.zeros_like(f))
            f_t, g_t = fg(x + a[:, None] * ls.p)
        with span("bfgs.search"):
            ls.update(searching, a, f_t, g_t)
            nfev_ls = nfev_ls + searching.to(torch.int32)
            fin = searching & ls.ended()
            # the BFGS update of the lanes whose line search ended
            alpha, f_new, g_new, ls_ok = ls.result()
        with span("bfgs.update"):
            p = ls.p
            x_new = x + alpha[:, None] * p
            sk = x_new - x
            yk = g_new - g
            sy = (sk * yk).sum(-1)
            # first-step inverse-Hessian scaling (Nocedal 6.20)
            first = ((k == 0) & (sy > 0))[:, None, None]
            h_scale = (sy / torch.clamp((yk * yk).sum(-1), min=1e-30))[:, None, None]
            hinv_s = torch.where(first, h_scale * eye, hinv)
            curv = sy > 1e-12
            rho = (1.0 / torch.where(curv, sy, torch.ones_like(sy)))[:, None, None]
            v = eye - rho * (sk[:, :, None] * yk[:, None, :])
            hinv_upd = v @ hinv_s @ v.transpose(-1, -2) + rho * (sk[:, :, None] * sk[:, None, :])
            hinv_new = torch.where(curv[:, None, None], hinv_upd, hinv_s)

            progressed = ls_ok & (f_new <= f) if not allow_f_increases else ls_ok
            x_keep = torch.where(progressed[:, None], x_new, x)
            f_keep = torch.where(progressed, f_new, f)
            g_keep = torch.where(progressed[:, None], g_new, g)
            gnorm = g_keep.abs().amax(-1)
            conv = gnorm < gtol
            if ftol > 0:
                # only a *successful* step counts: a failed line search leaves
                # f_new == f and would report a stalled run as converged
                conv = conv | (progressed & ((f_new - f).abs() <= ftol * f.abs()))
            # a failed line search gets one retry from a reset inverse Hessian
            fails_new = torch.where(progressed, 0, fails + 1).to(torch.int32)

            f1, f2 = fin[:, None], fin[:, None, None]
            x = torch.where(f1, x_keep, x)
            f = torch.where(fin, f_keep, f)
            g = torch.where(f1, g_keep, g)
            hinv = torch.where(f2, torch.where(progressed[:, None, None], hinv_new, eye), hinv)
            history = torch.where(f1 & (slots[None, :] == k[:, None]), f_keep[:, None], history)
            nfev = torch.where(fin, nfev + nfev_ls, nfev)
            nfev_ls = torch.where(fin, torch.zeros_like(nfev_ls), nfev_ls)
            k = torch.where(fin, k + 1, k)
            done = torch.where(fin, conv | (fails_new >= 2), done)
            converged = torch.where(fin, conv, converged)
            fails = torch.where(fin, fails_new, fails)
            # those lanes start their next iteration's line search
            nxt = fin & ~done & (k < maxiters)
            ls.restart(nxt, direction())
            searching = (searching & ~fin) | nxt

    # every lane has left its search, so nfev_ls is nought
    count("bfgs.lane_trials", lambda: (nfev - 1).sum())
    return x, f, g, k, nfev, converged, history


def bfgs_minimize(
    fun: Callable,
    params0,
    *,
    maxiters: int = 1000,
    gtol: float = 1e-8,
    ftol: float = 0.0,
    initial_stepnorm: float = None,
    allow_f_increases: bool = True,
) -> BFGSResult:
    """Minimize ``fun(params)`` (scalar) over a pytree of parameters.

    ``initial_stepnorm`` rescales the very first search direction to that
    norm, like Optim.jl's ``BFGS(initial_stepnorm=0.01)``.  With
    ``allow_f_increases=False`` a step that raises the loss counts as a
    failed line search.
    """
    x0, unravel = ravel_pytree(params0)
    x, f, g, k, nfev, conv, hist = _bfgs_lanes(
        lambda X: fun(unravel(X[0])).reshape(1), x0.detach()[None],
        maxiters, gtol, ftol, initial_stepnorm, allow_f_increases)
    return BFGSResult(
        params=unravel(x[0]), value=f[0], grad_norm=g[0].abs().max(),
        iterations=k[0], num_evals=nfev[0], converged=conv[0], loss_history=hist[0],
    )


def bfgs_minimize_lanes(
    fun: Callable,
    x0: torch.Tensor,
    *,
    maxiters: int = 1000,
    gtol: float = 1e-8,
    ftol: float = 0.0,
    initial_stepnorm: float = None,
    allow_f_increases: bool = True,
    value_and_grad: bool = False,
) -> BFGSResult:
    """``L`` independent minimizations at once: the counterpart of
    ``jax.vmap(bfgs_minimize)``.

    ``x0`` has shape ``(L, ...)``; ``fun`` maps a tensor of that shape to the
    ``(L,)`` vector of per-lane losses, and lane ``l``'s loss may depend only
    on lane ``l`` of its input.  With ``value_and_grad``, ``fun`` returns
    ``(losses, gradients)`` itself, the gradients shaped like its input.
    Every field of the result has a leading lane dimension.
    """
    shape = x0.shape
    if value_and_grad:
        def flat_fun(X):
            f, g = fun(X.reshape(shape))
            return f, g.reshape(shape[0], -1)
    else:
        def flat_fun(X):
            return fun(X.reshape(shape))
    x, f, g, k, nfev, conv, hist = _bfgs_lanes(
        flat_fun, x0.detach().reshape(shape[0], -1),
        maxiters, gtol, ftol, initial_stepnorm, allow_f_increases, value_and_grad)
    return BFGSResult(
        params=x.reshape(shape), value=f, grad_norm=g.abs().amax(-1),
        iterations=k, num_evals=nfev, converged=conv, loss_history=hist,
    )
