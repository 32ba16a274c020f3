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
independent, so the gradient of its sum is each lane's gradient).  The host
reads one flag per line-search evaluation to decide whether to go on.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..flatten_util import ravel_pytree

__all__ = ["bfgs_minimize", "bfgs_minimize_lanes", "BFGSResult"]


class BFGSResult(NamedTuple):
    params: object
    value: torch.Tensor
    grad_norm: torch.Tensor
    iterations: torch.Tensor
    num_evals: torch.Tensor
    converged: torch.Tensor
    loss_history: torch.Tensor  # (maxiters,), +inf past convergence


def _wolfe_line_search(fg, x, p, f0, g0, alpha0, active, c1=1e-4, c2=0.9, maxiter=25):
    """Strong-Wolfe line search per lane.  Returns (alpha, f, g, nfev, ok).

    ``active`` lanes search; the others start finished.
    """
    dg0 = (g0 * p).sum(-1)
    zeros = torch.zeros_like(f0)
    i = torch.zeros(f0.shape, dtype=torch.int32, device=f0.device)
    stage = torch.where(active, 0, 2).to(torch.int32)  # 0 bracket, 1 zoom, 2 done
    a_prev, f_prev, dg_prev = zeros, f0, dg0
    a_cur = torch.full_like(f0, alpha0)
    a_lo, f_lo, dg_lo, a_hi = zeros, f0, dg0, zeros
    star_a, star_f, star_g = zeros, f0, g0
    nfev = torch.zeros_like(i)

    while True:
        run = (stage < 2) & (i < maxiter)
        if not bool(run.any()):
            break
        a = torch.where(stage == 0, a_cur, 0.5 * (a_lo + a_hi))
        f, g = fg(x + a[:, None] * p)
        dg = (g * p).sum(-1)
        armijo_fail = f > f0 + c1 * a * dg0
        curv_ok = dg.abs() <= -c2 * dg0

        # bracket stage
        hi_found = armijo_fail | ((f >= f_prev) & (i > 0))
        to_done = ~hi_found & curv_ok
        to_rev = ~hi_found & ~curv_ok & (dg >= 0)
        b_stage = torch.where(to_done, 2, torch.where(hi_found | to_rev, 1, 0))
        b_a_lo = torch.where(hi_found, a_prev, torch.where(to_rev, a, a_lo))
        b_f_lo = torch.where(hi_found, f_prev, torch.where(to_rev, f, f_lo))
        b_dg_lo = torch.where(hi_found, dg_prev, torch.where(to_rev, dg, dg_lo))
        b_a_hi = torch.where(hi_found, a, torch.where(to_rev, a_prev, a_hi))
        b_star = to_done

        # zoom stage
        shrink_hi = armijo_fail | (f >= f_lo)
        z_done = ~shrink_hi & curv_ok
        flip = ~shrink_hi & ~curv_ok & (dg * (a_hi - a_lo) >= 0)
        new_lo = ~shrink_hi & ~z_done
        z_stage = torch.where(z_done, 2, 1)
        z_a_hi = torch.where(shrink_hi, a, torch.where(flip, a_lo, a_hi))
        z_a_lo = torch.where(new_lo, a, a_lo)
        z_f_lo = torch.where(new_lo, f, f_lo)
        z_dg_lo = torch.where(new_lo, dg, dg_lo)
        # keep the best Armijo point in case zoom exhausts its budget
        z_star = z_done | (~z_done & (f < star_f) & ~armijo_fail)

        br = stage == 0
        upd = lambda b, z, old: torch.where(run, torch.where(br, b, z), old)  # noqa: E731
        take = run & torch.where(br, b_star, z_star)
        stage = upd(b_stage, z_stage, stage).to(torch.int32)
        a_lo, f_lo, dg_lo, a_hi = (upd(b_a_lo, z_a_lo, a_lo), upd(b_f_lo, z_f_lo, f_lo),
                                   upd(b_dg_lo, z_dg_lo, dg_lo), upd(b_a_hi, z_a_hi, a_hi))
        # only the bracket stage moves the previous point and the next trial
        a_prev, f_prev, dg_prev, a_cur = (upd(a, a_prev, a_prev), upd(f, f_prev, f_prev),
                                          upd(dg, dg_prev, dg_prev), upd(2.0 * a, a_cur, a_cur))
        star_a = torch.where(take, a, star_a)
        star_f = torch.where(take, f, star_f)
        star_g = torch.where(take[:, None], g, star_g)
        i = i + run.to(torch.int32)
        nfev = nfev + run.to(torch.int32)

    ok = stage == 2
    found = ok | (star_a > 0)
    # when the search exhausted its budget without satisfying Wolfe: the best
    # Armijo point found, or a_lo
    alpha = torch.where(found, star_a, a_lo)
    return alpha, star_f, star_g, nfev, found


def _bfgs_lanes(fun, x0, maxiters, gtol, ftol, initial_stepnorm, allow_f_increases):
    """The BFGS loop over ``x0`` of shape ``(L, n)``; ``fun`` maps (L, n) → (L,)."""
    dtype, device = x0.dtype, x0.device
    L, n = x0.shape

    def fg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            f = fun(x)
            (g,) = torch.autograd.grad(f.sum(), x)
        # pin the loss to the parameter dtype (an f32 model's loss can promote
        # to f64 through Python time scalars)
        return f.detach().to(dtype), g.to(dtype)

    x = x0.detach()
    f, g = fg(x)
    eye = torch.eye(n, dtype=dtype, device=device)
    hinv = eye.expand(L, n, n).clone()
    k = torch.zeros(L, dtype=torch.int32, device=device)
    nfev = torch.ones_like(k)
    done = torch.zeros(L, dtype=torch.bool, device=device)
    converged = torch.zeros_like(done)
    fails = torch.zeros_like(k)
    history = torch.full((L, maxiters), float("inf"), dtype=dtype, device=device)
    slots = torch.arange(maxiters, device=device)

    while True:
        active = ~done & (k < maxiters)
        if not bool(active.any()):
            break
        p = -(hinv @ g[:, :, None])[:, :, 0]
        # reset to steepest descent on an ascent/indefinite direction
        p = torch.where(((p * g).sum(-1) >= 0)[:, None], -g, p)
        if initial_stepnorm is not None:
            pnorm = torch.linalg.vector_norm(p, dim=-1)
            scale = torch.where(k == 0, initial_stepnorm / torch.clamp(pnorm, min=1e-30),
                                torch.ones_like(pnorm))
            p = p * scale[:, None]
        alpha, f_new, g_new, nfev_ls, ls_ok = _wolfe_line_search(
            fg, x, p, f, g, 1.0, active)
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

        act, act2 = active[:, None], active[:, None, None]
        x = torch.where(act, x_keep, x)
        f = torch.where(active, f_keep, f)
        g = torch.where(act, g_keep, g)
        hinv = torch.where(act2, torch.where(progressed[:, None, None], hinv_new, eye), hinv)
        history = torch.where(act & (slots[None, :] == k[:, None]), f_keep[:, None], history)
        nfev = torch.where(active, nfev + nfev_ls, nfev)
        k = torch.where(active, k + 1, k)
        done = torch.where(active, conv | (fails_new >= 2), done)
        converged = torch.where(active, conv, converged)
        fails = torch.where(active, fails_new, fails)

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
) -> BFGSResult:
    """``L`` independent minimizations at once: the counterpart of
    ``jax.vmap(bfgs_minimize)``.

    ``x0`` has shape ``(L, ...)``; ``fun`` maps a tensor of that shape to the
    ``(L,)`` vector of per-lane losses, and lane ``l``'s loss may depend only
    on lane ``l`` of its input.  Every field of the result has a leading
    lane dimension.
    """
    shape = x0.shape
    x, f, g, k, nfev, conv, hist = _bfgs_lanes(
        lambda X: fun(X.reshape(shape)), x0.detach().reshape(shape[0], -1),
        maxiters, gtol, ftol, initial_stepnorm, allow_f_increases)
    return BFGSResult(
        params=x.reshape(shape), value=f, grad_norm=g.abs().amax(-1),
        iterations=k, num_evals=nfev, converged=conv, loss_history=hist,
    )
