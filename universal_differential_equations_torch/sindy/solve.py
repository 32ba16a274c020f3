"""SINDy solve front end: problems, model selection, recovered models.

Port of ``universal_differential_equations_tpu/sindy/solve.py``
(SURVEY.md §3.4, C19/C21):

* ``DirectDataDrivenProblem(X, Y)`` — fit Y = Ξ·Θ(X) (``scenario_1.jl:166``),
* ``ContinuousDataDrivenProblem(X, t[, DX][, kernel])`` — derivative targets,
  estimated by kernel collocation when not given (``hudson_bay.jl:48``),
* ``sindy(problem, basis, optimizer)`` with ``denoise`` (optimal SVHT),
  ``normalize``, cross-validation ``sampler`` folds, and model selection by
  AICc or a custom objective g(k, rss, N) (``scenario_2.jl:199``),
* ``SINDyResult`` — printable equations, ``parameters()``/``parameter_map()``
  and an executable recovered RHS for re-simulation, extrapolation and
  gradient refit (``scenario_1.jl:183-207``).

The λ-grid sweep runs on the data's device, one batched solve per
thresholding step; targets and CV folds are a host loop over those batches.
Only the final selections return to the host.  A ``WeakDataDrivenProblem``
(:mod:`.weak`) hands the front end its weak pair (G, B) in place of
(Θ(X), Y).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Union

import numpy as np
import torch

from .basis import Basis
from .collocation import collocate_data
from .optimizers import STLSQ, masked_lstsq
from .weak import WeakDataDrivenProblem

__all__ = [
    "DirectDataDrivenProblem",
    "ContinuousDataDrivenProblem",
    "DataSampler",
    "sindy",
    "SINDyResult",
]


@dataclasses.dataclass(frozen=True)
class DirectDataDrivenProblem:
    """Fit targets Y directly against Θ(X) (``scenario_1.jl:166-167``)."""

    X: torch.Tensor  # (N, n)
    Y: torch.Tensor  # (N, d)


@dataclasses.dataclass(frozen=True)
class ContinuousDataDrivenProblem:
    """Fit estimated derivatives DX against Θ(X).

    When ``DX`` is None, both the smoothed states and their derivatives are
    estimated by kernel collocation (``hudson_bay.jl:48``, C20).
    """

    X: torch.Tensor
    t: torch.Tensor
    DX: Optional[torch.Tensor] = None
    kernel: str = "gaussian"
    bandwidth: Optional[float] = None

    def realize(self):
        if self.DX is not None:
            return self.X, self.DX
        return collocate_data(self.X, self.t, kernel=self.kernel,
                              bandwidth=self.bandwidth)


@dataclasses.dataclass(frozen=True)
class DataSampler:
    """Cross-validation batching for model selection
    (``sampler=DataSampler(Batcher(n=4,shuffle=true))``, ``scenario_1.jl:172``).
    The folds come from numpy's RNG, as in the JAX package, so both packages
    hold out the same rows."""

    n: int = 4
    shuffle: bool = True
    seed: int = 0

    def masks(self, N):
        idx = np.arange(N)
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(idx)
        masks = np.zeros((self.n, N), dtype=np.float64)
        for b, chunk in enumerate(np.array_split(idx, self.n)):
            masks[b, chunk] = 1.0
        return masks  # 1 = held-out rows of fold b


def _svht_denoise(X):
    """Optimal singular-value hard threshold (Gavish & Donoho 2014) — the
    reference's ``denoise=true`` option, applied to the candidate matrix Θ.
    The median of the (descending) singular values is read at fixed
    positions, as numpy's median, so nothing is read on the host and it runs
    under ``torch.func.vmap`` (``select.two_stage_recovery``'s lanes)."""
    N, n = X.shape
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    beta = min(N, n) / max(N, n)
    omega = 0.56 * beta**3 - 0.95 * beta**2 + 1.82 * beta + 1.43
    k = s.shape[-1]
    med = s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])
    return (U * torch.where(s >= omega * med, s, torch.zeros_like(s))) @ Vh


def _aicc(k, rss, N):
    k = k.to(rss.dtype)
    rss = torch.clamp(rss, min=1e-30)
    aic = N * torch.log(rss / N) + 2.0 * k
    corr = 2.0 * k * (k + 1.0) / torch.clamp(N - k - 1.0, min=1.0)
    return aic + corr


def sindy(
    problem,
    basis: Basis,
    optimizer=None,
    *,
    normalize: bool = False,
    denoise: bool = False,
    sampler: Optional[DataSampler] = None,
    selection: Union[str, Callable] = "aicc",
    cv_tolerance: float = 3.0,
    precision: str = "auto",
    exhaustive_k: int = 0,
) -> "SINDyResult":
    """Sparse recovery: returns the best model per target equation across the
    optimizer's threshold grid.

    ``exhaustive_k > 0`` additionally evaluates every support of size
    ≤ exhaustive_k by masked least squares: iterative thresholding cannot
    un-cancel collinear groups, so small supports must compete explicitly.

    ``precision="auto"`` runs the normal-equation sweep in float64 on the
    data's device when the data are float32 (polynomial libraries on
    trajectories reach cond(Θ) ~ 1e7+, and the gram squares it); "device"
    keeps the data's dtype.
    """
    optimizer = STLSQ() if optimizer is None else optimizer
    theta_raw = None
    if isinstance(problem, WeakDataDrivenProblem):
        # weak-form rows: the feature matrix is already integrated, so the
        # "sample count" below is the number of test windows
        theta_raw, Y = problem.realize(basis)
    elif isinstance(problem, ContinuousDataDrivenProblem):
        X, Y = problem.realize()
    else:
        X, Y = problem.X, problem.Y
    Y = torch.as_tensor(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    d = Y.shape[1]

    if theta_raw is None:
        theta_raw = basis.theta(torch.as_tensor(X))  # (N, m)
    N = theta_raw.shape[0]
    if denoise:
        theta_raw = _svht_denoise(theta_raw)
    m = theta_raw.shape[1]
    if normalize:
        # the fully normalized frame — unit-RMS feature columns AND unit-RMS
        # targets — so thresholds compare scale-free coefficients
        scale = torch.linalg.vector_norm(theta_raw, dim=0) / np.sqrt(N)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        y_scale = torch.sqrt(torch.mean(Y**2, dim=0))
        y_scale = torch.where(y_scale > 0, y_scale, torch.ones_like(y_scale))
    else:
        scale = torch.ones((m,), dtype=theta_raw.dtype, device=theta_raw.device)
        y_scale = torch.ones((d,), dtype=theta_raw.dtype, device=theta_raw.device)
    theta = theta_raw / scale
    Y = Y / y_scale

    if selection == "aicc":
        score_fn = _aicc
    elif callable(selection):
        score_fn = selection
    else:
        raise ValueError(f"unknown selection {selection!r}")

    data_dtype = theta.dtype
    if precision == "auto" and theta.dtype == torch.float32:
        theta, Y = theta.double(), Y.double()
    device = theta.device

    support_masks = None
    if exhaustive_k > 0:
        sup = [np.zeros(m, bool)]
        for k in range(1, exhaustive_k + 1):
            for c in itertools.combinations(range(m), k):
                row = np.zeros(m, bool)
                row[list(c)] = True
                sup.append(row)
        support_masks = torch.as_tensor(np.stack(sup), device=device)

    gram = theta.T @ theta
    corrs = theta.T @ Y  # (m, d)
    eps_r = 10.0 * torch.finfo(theta.dtype).eps * torch.diagonal(gram).mean()

    def candidates(gram_x, corr_x):
        """Grid-path candidates plus exhaustive small supports."""
        xi, active = optimizer.fit_grid(gram_x, corr_x)  # (L, m)
        if support_masks is not None:
            xi_e = masked_lstsq(gram_x, corr_x, support_masks, eps_r)
            xi_e = torch.where(support_masks, xi_e, torch.zeros_like(xi_e))
            xi = torch.cat([xi, xi_e])
            active = torch.cat([active, support_masks])
        return xi, active

    folds = None
    if sampler is not None:
        folds = torch.as_tensor(sampler.masks(N), dtype=theta.dtype, device=device)

    def per_target(corr, y):
        xi, active = candidates(gram, corr)  # (L+C, m)
        resid = theta @ xi.T - y[:, None]  # (N, L)
        ks = active.sum(dim=1)
        rss = torch.sum(resid**2, dim=0)  # (L,)
        # relative floor: on exactly representable targets every candidate
        # hits rounding-level rss; flooring ties them so the sparsity penalty
        # decides.  The rounding level follows the *source* feature dtype.
        eps_src = torch.finfo(data_dtype).eps
        floor = max((50.0 * eps_src) ** 2, 1e-20) * torch.sum(y**2) + 1e-300
        if folds is None:
            scores = score_fn(ks, torch.maximum(rss, floor), N)
            best = torch.argmin(scores)
        else:
            cv = []
            for wb in folds:
                keep = 1.0 - wb  # train rows
                gram_b = theta.T @ (theta * keep[:, None])
                corr_b = theta.T @ (y * keep)
                xi_b, _ = candidates(gram_b, corr_b)
                res_b = (theta @ xi_b.T - y[:, None]) * wb[:, None]
                cv.append(torch.sum(res_b**2, dim=0) / torch.clamp(wb.sum(), min=1.0))
            cv_mean = torch.maximum(torch.stack(cv).mean(dim=0), floor / N)
            if callable(selection):
                # a custom objective g(k, rss, N) scores the held-out errors
                # directly (``scenario_2.jl:199``)
                scores = score_fn(ks, cv_mean * N, N)
                best = torch.argmin(scores)
            else:
                # parsimony rule: the sparsest model whose CV error is within
                # ``cv_tolerance``× of the best (removing a needed term
                # inflates held-out error by orders of magnitude; spurious
                # terms buy only O(1) factors)
                ok = cv_mean <= cv_tolerance * torch.min(cv_mean)
                k_min = torch.min(torch.where(ok, ks, torch.iinfo(ks.dtype).max))
                cand = ok & (ks == k_min)
                best = torch.argmin(torch.where(cand, cv_mean, torch.inf))
                scores = cv_mean
        return xi[best], active[best], rss[best], ks[best], scores[best], best

    outs = [per_target(corrs[:, e], Y[:, e]) for e in range(d)]
    xi, active, rss, ks, scores, best_idx = (
        torch.stack([o[j] for o in outs]).cpu().numpy() for j in range(6))
    # undo target normalization: raw-frame coefficients and residuals
    ysc = y_scale.cpu().numpy()
    xi = xi * ysc[:, None]
    rss = rss * ysc**2
    n_grid_candidates = len(optimizer.thresholds)
    # prune numerically-zero survivors (representable targets leave
    # O(eps)-coefficient artifacts on collinear features)
    tiny = np.maximum(1e-8, 100.0 * float(torch.finfo(data_dtype).eps)) * np.max(
        np.abs(xi), axis=1, keepdims=True
    )
    active = active & (np.abs(xi) > tiny)
    xi = np.where(active, xi, 0.0)
    ks = active.sum(axis=1)
    xi = xi / scale.cpu().numpy()[None, :]  # back to the raw-feature frame
    thresholds = np.asarray(optimizer.thresholds)
    return SINDyResult(
        basis=basis,
        coefficients=xi.T,  # (m, d)
        active=active.T.astype(bool),  # (m, d)
        l2_error=np.sqrt(rss),
        sparsity=ks,
        aicc=_aicc(torch.as_tensor(ks), torch.as_tensor(rss), N).numpy(),
        scores=scores,
        # winners drawn from the exhaustive-support grid (index past the
        # threshold sweep) have no threshold — report NaN
        chosen_thresholds=np.where(
            best_idx < n_grid_candidates,
            thresholds[np.minimum(best_idx, n_grid_candidates - 1)],
            np.nan,
        ),
    )


@dataclasses.dataclass
class SINDyResult:
    """Recovered sparse model (the reference's printable, callable result —
    ``scenario_1.jl:176-190``; metrics API of ``loop_evaluation.jl:54-56``).
    Coefficients and masks are numpy arrays, as in the JAX package."""

    basis: Basis
    coefficients: np.ndarray  # (m, d)
    active: np.ndarray  # (m, d) bool
    l2_error: np.ndarray  # (d,)
    sparsity: np.ndarray  # (d,)
    aicc: np.ndarray  # (d,)
    scores: np.ndarray  # (d,)
    chosen_thresholds: np.ndarray  # (d,)

    # -- inspection ---------------------------------------------------------
    def equations(self, lhs: str = "du", digits: int = 4):
        names = self.basis.names
        eqs = []
        for eq in range(self.coefficients.shape[1]):
            parts = []
            for j in range(self.coefficients.shape[0]):
                if self.active[j, eq]:
                    coef = self.coefficients[j, eq]
                    term = f"{coef:+.{digits}g}"
                    if names[j] != "1":
                        term += f"*{names[j]}"
                    parts.append(term)
            rhs_str = " ".join(parts) if parts else "0"
            eqs.append(f"{lhs}{eq+1}/dt = {rhs_str}")
        return eqs

    def __repr__(self):
        return "SINDyResult(\n  " + "\n  ".join(self.equations()) + "\n)"

    def parameters(self) -> np.ndarray:
        """Active coefficient values, equation-major (reference
        ``parameters(res)``)."""
        vals = []
        for eq in range(self.coefficients.shape[1]):
            vals.extend(self.coefficients[self.active[:, eq], eq])
        return np.asarray(vals)

    def parameter_map(self):
        names = self.basis.names
        out = []
        for eq in range(self.coefficients.shape[1]):
            for j in range(self.coefficients.shape[0]):
                if self.active[j, eq]:
                    out.append((f"eq{eq+1}:{names[j]}", float(self.coefficients[j, eq])))
        return out

    # -- executable model (C21) --------------------------------------------
    def _scatter_indices(self):
        # equation-major, matching parameters() ordering
        cols, rows = np.nonzero(self.active.T)
        return rows, cols

    def rhs(self):
        """ODE right-hand side ``f(t, u, p)`` with ``p`` the active
        coefficient vector — recovered equations → executable ODE
        (``scenario_1.jl:183-191``); differentiable in ``p``."""
        rows, cols = self._scatter_indices()
        m, d = self.coefficients.shape
        basis = self.basis
        index = {}  # the scatter indices, one copy per device

        def f(t, u, p):
            idx = index.get(u.device)
            if idx is None:
                idx = index[u.device] = (torch.as_tensor(rows, device=u.device),
                                         torch.as_tensor(cols, device=u.device))
            C = torch.zeros((m, d), dtype=u.dtype, device=u.device).index_put(
                idx, p.to(u.dtype))
            return basis.theta(u) @ C

        return f

    def __call__(self, u, p=None, t=None):
        u = torch.as_tensor(u)
        p = torch.as_tensor(self.parameters() if p is None else p, device=u.device)
        return self.rhs()(t, u, p)
