"""Plain BFGS with a strong-Wolfe line search, one problem per lane.

Nocedal & Wright, Numerical Optimization (2nd ed.): the inverse-Hessian
update (6.17) with the first-step scaling (6.20), the line search of
Algorithm 3.5 (bracketing, the trial doubled) and 3.6 (zoom, by bisection),
with Optim.jl's ``initial_stepnorm`` (the first direction scaled to that
norm), a curvature guard (no update unless ``sᵀy > 1e-12``), steepest
descent where the direction does not descend, and a failed line search
answered by one retry from the identity (a second failure in a row stops
the lane).  A lane whose search runs out of trials takes the best point that
met the sufficient-decrease condition, if any.

Each lane runs its own iterations as a generator that yields trial points
and receives their loss and gradient; :func:`minimize_lanes` serves every
waiting lane with one batched evaluation.  Plain PyTorch on the host's CPU
in float32 for the lane arithmetic; imports nothing of the program.
"""
from __future__ import annotations

import torch

C1, C2, TRIALS = 1e-4, 0.9, 25


def _line_search(x, f0, g0, p):
    """Strong-Wolfe search along ``p``; yields trial points, returns
    ``(ok, alpha, f, g)``."""
    dg0 = float(g0 @ p)
    a_prev, f_prev, dg_prev = 0.0, f0, dg0
    a = 1.0
    best = None  # the best trial that met sufficient decrease, while zooming
    lo = hi = None
    for i in range(TRIALS):
        trial = a if lo is None else 0.5 * (lo[0] + hi)
        f, g = yield x + trial * p
        dg = float(g @ p)
        armijo_fail = f > f0 + C1 * trial * dg0
        curv_ok = abs(dg) <= -C2 * dg0
        if lo is None:  # bracketing
            if armijo_fail or (i > 0 and f >= f_prev):
                lo, hi = (a_prev, f_prev, dg_prev), trial
            elif curv_ok:
                return True, trial, f, g
            elif dg >= 0:
                lo, hi = (trial, f, dg), a_prev
            a_prev, f_prev, dg_prev = trial, f, dg
            a = 2.0 * trial
        else:  # zoom
            if armijo_fail or f >= lo[1]:
                hi = trial
            elif curv_ok:
                return True, trial, f, g
            else:
                if dg * (hi - lo[0]) >= 0:
                    hi = lo[0]
                lo = (trial, f, dg)
            if not armijo_fail and f < (f0 if best is None else best[1]):
                best = (trial, f, g)
    if best is not None:
        return True, best[0], best[1], best[2]
    return False, 0.0, f0, g0


def _lane(x, maxiters, stepnorm, gtol, record):
    """One lane's BFGS; ``record`` collects each iteration's loss."""
    f, g = yield x
    n = x.numel()
    eye = torch.eye(n, dtype=x.dtype)
    H = eye.clone()
    fails = 0
    for k in range(maxiters):
        p = -(H @ g)
        if float(p @ g) >= 0:
            p = -g
        if k == 0 and stepnorm is not None:
            p = p * (stepnorm / max(float(torch.linalg.vector_norm(p)), 1e-30))
        ok, alpha, f_new, g_new = yield from _line_search(x, f, g, p)
        s = alpha * p
        y = g_new - g
        sy = float(s @ y)
        Hs = (sy / max(float(y @ y), 1e-30)) * eye if (k == 0 and sy > 0) else H
        if sy > 1e-12:
            rho = 1.0 / sy
            V = eye - rho * torch.outer(s, y)
            H_new = V @ Hs @ V.T + rho * torch.outer(s, s)
        else:
            H_new = Hs
        if ok:
            x, f, g, H, fails = x + s, f_new, g_new, H_new, 0
        else:
            H, fails = eye.clone(), fails + 1
        record.append(f)
        if float(g.abs().max()) < gtol or fails >= 2:
            break
    return x


def minimize_lanes(fg, x0, maxiters, stepnorm=0.01, gtol=1e-12):
    """BFGS on every lane of ``x0`` (L, n); ``fg(X) -> (f (L,), g (L, n))``
    is evaluated on the lanes that wait for a point (the others hold their
    last point).  Returns the final points (L, n) and each lane's losses per
    iteration."""
    L = x0.shape[0]
    host = x0.detach().to("cpu", torch.float32)
    records = [[] for _ in range(L)]
    lanes = [_lane(host[i].clone(), maxiters, stepnorm, gtol, records[i]) for i in range(L)]
    points = [lane.send(None) for lane in lanes]
    final = [None] * L
    waiting = list(range(L))
    while waiting:
        X = torch.stack([points[i] if final[i] is None else final[i] for i in range(L)])
        f, g = fg(X.to(x0.device))
        f, g = f.detach().to("cpu", torch.float32), g.detach().to("cpu", torch.float32)
        for i in waiting:
            try:
                points[i] = lanes[i].send((float(f[i]), g[i]))
            except StopIteration as stop:
                final[i] = stop.value
        waiting = [i for i in waiting if final[i] is None]
    return torch.stack(final).to(x0.device), records
