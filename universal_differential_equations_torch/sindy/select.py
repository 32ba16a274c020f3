"""Simulation-validated sparse model selection.

Port of ``universal_differential_equations_tpu/sindy/select.py``.  The
reference selects SINDy models by statistical parsimony and then checks the winner by re-simulating it
against the data (``scenario_1.jl:193-207``).  When the regression targets
are a trained net's outputs, their error is structured and fit consistently
across CV folds, so statistics alone over-select; re-simulation through the
ODE separates the candidates.

* :func:`best_per_support` compresses a candidate grid to the best-scoring
  candidate at each support size — a parsimony ladder.
* :func:`cv_ladder` builds such a ladder from a feature matrix and one
  target, scoring the optimizer's λ grid by K-fold cross-validation.
* :func:`select_by_simulation` integrates every cross-target combination of
  ladder rungs with a fixed-step solver and picks the sparsest one that
  reproduces the data; with ``refit_iters > 0`` each finalist's
  coefficients are first refit to the trajectory (BFGS or LM).
* :func:`two_stage_recovery` is the reference's SR3 → STRRidge protocol
  (``loop_recoveries.jl:100-125``); it runs under ``torch.func.vmap``.
* :func:`stability_selection` reports per-term selection frequencies over
  random row subsamples (Meinshausen & Bühlmann).

Where JAX ``vmap``s over candidates, the port gives them a leading lane
dimension: the combinations integrate as lanes of ``integrate_fixed``, so
``dense_rhs`` takes a batch of lanes (unlike the JAX package's, which takes
one), and the BFGS refits run as lanes of ``bfgs_minimize_lanes``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..core.integrate import integrate_fixed
from .optimizers import SR3, masked_lstsq
from .solve import DataSampler, _svht_denoise

__all__ = ["best_per_support", "cv_ladder", "select_by_simulation",
           "stability_selection", "two_stage_recovery"]


def two_stage_recovery(theta, Y, lams, *, nu: float = 0.1, sr3_maxiter: int = 500,
                       refit_threshold: float = 0.01, refit_ridge: float = 0.01,
                       refit_maxiter: int = 10, normalize: bool = True,
                       denoise: bool = True, g=None):
    """The reference's SR3 → STRRidge two-stage recovery
    (``loop_recoveries.jl:100-125``).

    Stage 1, structure search: SR3(ν=``nu``) over the threshold grid ``lams``
    on the normalized (and optionally SVHT-denoised) normal equations; per
    target, candidates are scored by ``g(l0, l2) = inf if l0 < 1 else
    ‖(l0, l2)‖`` with ``l0`` the support size and ``l2`` the residual norm —
    empty models are rejected, otherwise sparsity dominates.

    Stage 2, parameter refit: the winning support is frozen and the
    coefficients are re-estimated by STRRidge(``refit_threshold``)
    restricted to it (re-thresholding may only drop frozen terms), then a
    final least-squares fit on the surviving support.

    Args:
      theta: (N, m) feature matrix Θ(X).
      Y: (N,) or (N, T) regression target(s).
      lams: SR3 threshold grid (keep ``sr3_maxiter`` high: an under-converged
        SR3 alternation skips support sizes along the λ path).
      g: optional replacement objective ``g(l0, l2) -> score`` (lower is
        better, ``inf`` = rejected).

    Returns ``C``: (m, T) coefficients in raw feature scale ((m,) if ``Y`` was
    1-D).  Reads nothing on the host, so it runs under ``torch.func.vmap``.
    """
    theta = torch.as_tensor(theta)
    Y2 = torch.as_tensor(Y, dtype=theta.dtype, device=theta.device)
    squeeze = Y2.ndim == 1
    if squeeze:
        Y2 = Y2[:, None]
    n_rows, m = theta.shape
    if denoise:
        theta = _svht_denoise(theta)
    if normalize:
        fsc = torch.linalg.vector_norm(theta, dim=0) / (1.0 * n_rows) ** 0.5
        fsc = torch.where(fsc > 0, fsc, torch.ones_like(fsc))
    else:
        fsc = torch.ones((m,), dtype=theta.dtype, device=theta.device)
    th_n = theta / fsc
    gram = th_n.T @ th_n
    opt = SR3(thresholds=tuple(float(x) for x in lams), nu=nu, maxiter=sr3_maxiter)
    if g is None:
        g = lambda l0, l2: torch.where(l0 < 1.0, torch.full_like(l0, float("inf")),
                                       torch.sqrt(l0**2 + l2**2))
    eps_ridge = 10.0 * torch.finfo(gram.dtype).eps * torch.diagonal(gram).mean()

    def per_target(y):
        ysc = torch.sqrt(torch.mean(y**2)) + 1e-30
        yn = y / ysc if normalize else y
        corr = th_n.T @ yn
        xi, active = opt.fit_grid(gram, corr)  # (L, m)
        rss = (torch.einsum("li,ij,lj->l", xi, gram, xi) - 2.0 * (xi @ corr)
               + torch.sum(yn**2))
        l2err = torch.sqrt(torch.clamp(rss, min=0.0))
        score = g(active.sum(dim=1).to(xi.dtype), l2err)
        # a 1-element index: under vmap a 0-d one is read back on the host
        frozen = active[torch.argmin(score).reshape(1)][0]
        act = frozen
        for _ in range(refit_maxiter):
            xi_r = masked_lstsq(gram, corr, act, refit_ridge)
            act = (xi_r.abs() >= refit_threshold) & frozen
        xi_f = masked_lstsq(gram, corr, act, eps_ridge)
        xi_f = torch.where(act, xi_f, torch.zeros_like(xi_f))
        return xi_f * (ysc if normalize else 1.0) / fsc

    C = torch.stack([per_target(Y2[:, j]) for j in range(Y2.shape[1])], dim=1)
    return C[:, 0] if squeeze else C


def cv_ladder(theta, y, optimizer, max_support, *, per_size: int = 1,
              fold_masks=None, n_folds: int = 4, exclude=(),
              extra_supports=None, ridge: float = 1e-7):
    """CV-scored parsimony ladder from a feature matrix and one target.

    Normalize features by column RMS and the target by its RMS, fit the
    optimizer's full candidate grid on the normal equations (plus an
    optional exhaustive set of fixed supports), score every candidate by
    K-fold cross-validation (candidates refit on each fold's kept rows,
    residuals on the held-out rows), and compress with
    :func:`best_per_support` — coefficients in RAW feature scale, ready for
    :func:`select_by_simulation`.

    Args:
      theta: (N, m) feature matrix Θ(X).
      y: (N,) regression target.
      optimizer: ``fit_grid(gram, corr) -> (xi, active)`` (``STLSQ`` etc.).
      max_support: ladder height — support sizes 1..max_support.
      per_size: distinct-support candidates kept per size.
      fold_masks: (K, N), 1 = held-out rows of fold k; defaults to
        ``DataSampler(n_folds)``'s folds.
      exclude: feature columns zeroed before fitting (terms the model
        already carries).
      extra_supports: optional (L, m) bool masks fit exhaustively by masked
        least squares and appended to the candidate grid.
      ridge: ridge of the ``extra_supports`` fits.
    """
    theta = torch.as_tensor(theta)
    y = torch.as_tensor(y, dtype=theta.dtype, device=theta.device)
    n_rows = theta.shape[0]
    if exclude:
        theta = theta.clone()
        theta[:, list(exclude)] = 0.0
    fsc = torch.linalg.vector_norm(theta, dim=0) / (1.0 * n_rows) ** 0.5
    fsc = torch.where(fsc > 0, fsc, torch.ones_like(fsc))
    th_n = theta / fsc
    if fold_masks is None:
        fold_masks = DataSampler(n_folds).masks(n_rows)
    folds = torch.as_tensor(fold_masks, dtype=th_n.dtype, device=th_n.device)
    ysc = torch.sqrt(torch.mean(y**2)) + 1e-30
    yn = y / ysc
    if extra_supports is not None:
        extra_supports = torch.as_tensor(extra_supports, dtype=torch.bool,
                                         device=th_n.device)

    def candidates(gram, corr):
        xi, active = optimizer.fit_grid(gram, corr)
        if extra_supports is not None:
            xe = masked_lstsq(gram, corr, extra_supports, ridge)
            xi = torch.cat([xi, torch.where(extra_supports, xe, torch.zeros_like(xe))])
            active = torch.cat([active, extra_supports])
        return xi, active

    xi, active = candidates(th_n.T @ th_n, th_n.T @ yn)
    cv = []
    for wb in folds:
        keep = 1.0 - wb
        xib, _ = candidates(th_n.T @ (th_n * keep[:, None]), th_n.T @ (yn * keep))
        rb = (th_n @ xib.T - yn[:, None]) * wb[:, None]
        cv.append(torch.sum(rb**2, dim=0) / torch.clamp(wb.sum(), min=1.0))
    cv = torch.stack(cv).mean(dim=0)
    return best_per_support(xi * ysc / fsc, active, cv, max_support, per_size=per_size)


def stability_selection(theta, y, optimizer, generator, *, n_subsets: int = 64,
                        frac: float = 0.7, max_support: int = 0, normalize: bool = True):
    """Per-term selection frequencies over random row subsamples (stability
    selection, Meinshausen & Bühlmann 2010, arXiv:0809.2932): how often each
    library term survives sparse regression when the data are repeatedly
    subsampled.  Terms near 1 are stably identified; terms that flicker are
    noise artifacts.

    Args:
      theta: (N, m) feature matrix (pointwise Θ(X) or a weak pair's G).
      y: (N,) regression target.
      optimizer: ``fit_grid(gram, corr) -> (xi, active)`` (STLSQ, SR3, …);
        its λ grid is the path the frequencies maximize over.
      generator: ``torch.Generator`` (CPU) for the Bernoulli row draws; the
        JAX package's ``key`` draws other rows.
      n_subsets / frac: number of subsamples and kept-row probability.
      max_support: only path candidates with support size in
        [1, max_support] count (0 = any nonempty candidate).
      normalize: column-RMS feature and RMS target scaling.

    Returns ``freq``: (m,), the fraction of subsamples in which term i is
    active in some counted path candidate (a stable support is e.g.
    ``freq >= 0.6``).
    """
    theta = torch.as_tensor(theta)
    keep = torch.bernoulli(torch.full((n_subsets, theta.shape[0]), frac, dtype=torch.float64),
                           generator=generator).to(device=theta.device, dtype=torch.bool)
    return _selection_frequencies(theta, y, optimizer, keep, max_support, normalize)


def _selection_frequencies(theta, y, optimizer, keep, max_support, normalize):
    """:func:`stability_selection` for a given (B, N) boolean row mask
    ``keep``: the B subsampled fits run as one ``torch.func.vmap`` batch."""
    theta = torch.as_tensor(theta)
    y = torch.as_tensor(y, dtype=theta.dtype, device=theta.device)
    n_rows = theta.shape[0]
    if normalize:
        fsc = torch.linalg.vector_norm(theta, dim=0) / (1.0 * n_rows) ** 0.5
        th_n = theta / torch.where(fsc > 0, fsc, torch.ones_like(fsc))
        yn = y / (torch.sqrt(torch.mean(y**2)) + 1e-30)
    else:
        th_n, yn = theta, y

    def one(w):
        wf = w.to(th_n.dtype)
        _, active = optimizer.fit_grid(th_n.T @ (th_n * wf[:, None]), th_n.T @ (yn * wf))
        k = active.sum(dim=1)
        ok = k >= 1
        if max_support:
            ok = ok & (k <= max_support)
        return (active & ok[:, None]).any(dim=0)

    sel = torch.func.vmap(one)(torch.as_tensor(keep, dtype=torch.bool, device=theta.device))
    return sel.to(th_n.dtype).mean(dim=0)


def best_per_support(xi, active, score, max_support, per_size: int = 1):
    """Best candidates at each support size 1..``max_support``.

    ``xi``: (L, m) candidate coefficients, ``active``: (L, m) bool supports,
    ``score``: (L,) (lower is better, ``inf`` = invalid).  Returns
    ``(xi_k, ok_k)`` with ``xi_k`` (max_support·per_size, m) and ``ok_k``
    bool — rungs with no candidate of that size come back zeroed with
    ``ok_k`` false.  ``per_size > 1`` keeps the top ``per_size``
    distinct-support candidates per size; rung order is size-major.
    """
    xi = torch.as_tensor(xi)
    active = torch.as_tensor(active, device=xi.device)
    score = torch.as_tensor(score, device=xi.device)
    ks = active.sum(dim=1)
    out_xi, out_ok = [], []
    for k in range(1, max_support + 1):
        s = torch.where(ks == k, score, torch.full_like(score, float("inf")))
        for _ in range(per_size):
            i = torch.argmin(s).reshape(1)
            ok = torch.isfinite(s[i])[0]
            out_xi.append(torch.where(ok, xi[i][0], torch.zeros_like(xi[0])))
            out_ok.append(ok)
            # knock out every candidate sharing the winner's support so the
            # runner-up is a genuinely different structure
            same = (active == active[i]).all(dim=1)
            s = torch.where(same, torch.full_like(s, float("inf")), s)
    return torch.stack(out_xi), torch.stack(out_ok)


def select_by_simulation(
    candidates: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    dense_rhs: Callable,
    u0,
    t0: float,
    t1: float,
    data,
    solver,
    n_steps: int,
    sub: int = 1,
    rel_factor: float = 1.5,
    rel_floor=0.0,
    max_rel: float = 1.0,
    refit_iters: int = 0,
    loss_floor=0.0,
    max_total_support: int = 0,
    sizes: Sequence = None,
    refit_all: bool = False,
    refit_top=1,
    refit_method: str = "bfgs",
    holdout_stride: int = 0,
):
    """Pick the sparsest candidate combination that re-simulates ``data``.

    ``candidates``: per-target ``(xi_k, ok_k)`` pairs from
    :func:`best_per_support` (raw feature scale).  For T targets with K
    rungs each, all K^T coefficient matrices C (m, T) are integrated as
    lanes, ``dense_rhs(t, u, C)`` with ``u`` (L, d) and ``C`` (L, m, T), each
    lane acting alone, from ``u0`` over ``[t0, t1]`` in ``n_steps`` fixed
    steps of ``solver``; every ``sub``-th
    state is compared with ``data`` ((n_save, d), ``n_steps = (n_save - 1) ·
    sub``).

    * ``refit_iters == 0``: among combinations with
      ``rel <= max(rel_factor · min_rel, rel_floor)`` (and ``rel <=
      max_rel``), the least total support wins, ties broken by ``rel`` (the
      max-abs trajectory error relative to the data's scale).
    * ``refit_iters > 0``: finalists — every valid combination with
      ``refit_all``, else the top ``refit_top`` per total support size
      T..``max_total_support`` (an int, or one entry per size) — have their
      coefficients refit to the trajectory (``refit_method`` "bfgs":
      ``refit_iters`` BFGS iterations; "lm": that many damped Gauss-Newton
      steps), and selection runs on the refit mean-squared losses with band
      ``max(rel_factor · min_loss, loss_floor)``.
    * ``holdout_stride > 0``: every ``holdout_stride``-th save point is left
      out of the refit and the score is the mean-squared residual there.

    Ladders built with ``per_size > 1`` pass their rung support sizes as
    ``sizes`` (one sequence per target).  Returns ``(C, score, k_total)``.
    """
    data = torch.as_tensor(data)
    device = data.device
    u0 = torch.as_tensor(u0, device=device)
    T = len(candidates)
    n_rungs = [c[0].shape[0] for c in candidates]
    grids = torch.meshgrid(*[torch.arange(s, device=device) for s in n_rungs],
                           indexing="ij")
    idx = torch.stack([g.reshape(-1) for g in grids], dim=-1)  # (P, T)
    Cs = torch.stack([candidates[t][0][idx[:, t]] for t in range(T)], dim=-1)  # (P, m, T)
    ok = torch.stack([candidates[t][1][idx[:, t]] for t in range(T)], dim=-1).all(dim=-1)
    if sizes is not None:
        k_tot = sum(torch.as_tensor(sizes[t], device=device)[idx[:, t]] for t in range(T))
    else:
        # rung r of best_per_support(per_size=1) has support size r+1
        k_tot = (idx + 1).sum(dim=-1)

    P = Cs.shape[0]
    inf = float("inf")

    def simulate(C):
        """(L, m, T) coefficient lanes -> (L, n_save, d) saved states."""
        y0 = u0.to(C.dtype).expand(C.shape[0], *u0.shape)
        _, ys = integrate_fixed(dense_rhs, y0, t0, t1, C, solver, n_steps)
        return ys[:, ::sub]

    data_scale = data.abs().max() + 1e-30
    rel = (simulate(Cs) - data).abs().amax(dim=(-2, -1)) / data_scale
    rel = torch.where(torch.isfinite(rel) & ok, rel, torch.full_like(rel, inf))
    big = torch.as_tensor(P * 10.0, dtype=rel.dtype, device=device)

    if refit_iters == 0:
        tol = torch.clamp(rel_factor * rel.min(), min=rel_floor)
        fits = rel <= torch.clamp(tol, max=max_rel)
        key = torch.where(fits, k_tot * big + torch.clamp(rel, max=max_rel),
                          torch.full_like(rel, inf))
        best = torch.argmin(key)
        return Cs[best], rel[best], k_tot[best]

    n_save = data.shape[0]
    w_train = w_hold = None
    if holdout_stride:
        # stride >= 2 keeps index 0 (the simulation seed) in the refit set,
        # and stride <= n_save guarantees a nonempty holdout
        if not 2 <= holdout_stride <= n_save:
            raise ValueError(f"holdout_stride must be in [2, {n_save}], got {holdout_stride}")
        hold = (torch.arange(n_save, device=device) % holdout_stride) == (holdout_stride - 1)
        shape = (n_save,) + (1,) * (data.ndim - 1)
        w_train = torch.where(hold, 0.0, 1.0).to(data.dtype).reshape(shape)
        w_hold = torch.where(hold, 1.0, 0.0).to(data.dtype).reshape(shape)
        n_hold = hold.sum() * (data.numel() // n_save)

    if refit_all:
        keep = torch.isfinite(rel)
        if max_total_support:
            keep = keep & (k_tot <= max_total_support)
        C_f, ok_f, k_f = Cs, keep, k_tot
    else:
        k_max = max_total_support or int(
            sum(int(torch.as_tensor(s).max()) for s in sizes) if sizes is not None
            else sum(n_rungs))
        k_sizes = list(range(T, k_max + 1))
        tops = ([int(x) for x in refit_top] if isinstance(refit_top, (list, tuple))
                else [int(refit_top)] * len(k_sizes))
        if len(tops) != len(k_sizes):
            raise ValueError(f"refit_top sequence needs one entry per total size "
                             f"{k_sizes}, got {tops}")
        picks, ok_parts, k_parts = [], [], []
        for k, top in zip(k_sizes, tops):
            s = torch.where((k_tot == k) & torch.isfinite(rel), rel, torch.full_like(rel, inf))
            for _ in range(top):
                i = torch.argmin(s).reshape(1)
                picks.append(i)
                ok_parts.append(torch.isfinite(s[i])[0])
                k_parts.append(k)
                s = s.index_fill(0, i, inf)
        C_f = Cs[torch.cat(picks)]
        ok_f = torch.stack(ok_parts)
        k_f = torch.as_tensor(k_parts, device=device)

    mask = (C_f != 0.0).to(C_f.dtype)

    def residual(C):
        return simulate(C * mask) - data  # (F, n_save, d)

    def holdout_score(C):
        r = w_hold * residual(C)
        return (r * r).sum(dim=(-2, -1)) / n_hold

    if refit_method == "bfgs":
        from ..train.bfgs import bfgs_minimize_lanes  # train is a sibling layer

        def lanes_loss(C):
            r = residual(C)
            if holdout_stride:
                r = w_train * r
            return (r * r).mean(dim=(-2, -1))

        res = bfgs_minimize_lanes(lanes_loss, C_f, maxiters=refit_iters,
                                  initial_stepnorm=0.01)
        C_ref = res.params * mask
        loss_f = holdout_score(C_ref) if holdout_stride else res.value
    elif refit_method == "lm":
        C_ref, loss_f = _refit_lm(simulate, data, C_f, mask, refit_iters, w_train)
        if holdout_stride:
            loss_f = holdout_score(C_ref)
    else:
        raise ValueError(f"refit_method must be 'bfgs' or 'lm', got {refit_method!r}")

    loss_f = torch.where(torch.isfinite(loss_f) & ok_f, loss_f, torch.full_like(loss_f, inf))
    tol = torch.clamp(rel_factor * loss_f.min(), min=loss_floor)
    # isfinite guard: with no valid finalist tol is inf and inf <= inf would
    # "fit", and inf/inf below would poison the key with NaN
    fits = (loss_f <= tol) & torch.isfinite(loss_f)
    norm = torch.clamp(loss_f / (loss_f.min() + 1e-30), max=float(big) - 1.0)
    norm = torch.where(torch.isfinite(norm), norm, big - 1.0)
    key = torch.where(fits, k_f * big + norm, torch.full_like(norm, inf))
    best = torch.argmin(key)
    return C_ref[best], loss_f[best], k_f[best]


def _refit_lm(simulate, data, C0, mask, iters, w_train=None):
    """``iters`` damped Gauss-Newton steps on each lane's trajectory
    residuals, the Jacobian refreshed after each accepted step (the JAX
    package's ``refit_lm``).  Returns ``(C, mean squared residual)``."""
    F = C0.shape[0]
    shape = C0.shape[1:]
    mflat = mask.reshape(F, -1)
    n_res = data.numel()

    def r_flat(x):  # (F, n) -> (F, n_res)
        r = simulate(x.reshape(F, *shape) * mask) - data
        return (r if w_train is None else w_train * r).reshape(F, -1)

    from ..train.lm import lane_jacobian  # train is a sibling layer

    def jac(x):
        return lane_jacobian(r_flat, x) * mflat[:, None, :]

    x = C0.reshape(F, -1)
    r = r_flat(x)
    lv = (r * r).sum(-1)
    lam = torch.full((F,), 1e-3, dtype=x.dtype, device=x.device)
    J = jac(x)
    # masked parameters get a unit diagonal (their J columns are exactly 0)
    inert = torch.diag_embed(1.0 - mflat)
    acc_prev = torch.ones(F, dtype=torch.bool, device=x.device)
    for it in range(iters):
        if it:
            J = torch.where(acc_prev[:, None, None], jac(x), J)
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        H = J.transpose(1, 2) @ J
        diag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=1e-10)
        A = H + lam[:, None, None] * torch.diag_embed(diag) + inert
        x_new = x - torch.linalg.solve(A, g) * mflat
        r_new = r_flat(x_new)
        l_new = (r_new * r_new).sum(-1)
        acc = (l_new < lv) & torch.isfinite(r_new).all(-1)
        lam = torch.clamp(torch.where(acc, lam * 0.3, lam * 3.0), 1e-10, 1e10)
        x = torch.where(acc[:, None], x_new, x)
        r = torch.where(acc[:, None], r_new, r)
        lv = torch.where(acc, l_new, lv)
        acc_prev = acc
    return x.reshape(F, *shape) * mask, lv / n_res
