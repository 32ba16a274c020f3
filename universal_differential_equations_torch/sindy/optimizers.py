"""Sparse-regression optimizers: STLSQ, STRRidge, SR3 (SURVEY.md C19).

Port of ``universal_differential_equations_tpu/sindy/optimizers.py``.  The
reference sweeps large threshold grids (``STLSQ(exp10.(-3:0.01:5))``,
``scenario_1.jl:162-164``).  Where JAX ``vmap``s one threshold's fixed-point
iteration over the grid, here every threshold is a lane of one batched
iteration: each sweep step is one batched solve of ``L`` masked normal
equations.

Masked least squares uses the identity trick: rows/columns of inactive
coefficients are replaced by the identity block, so inactive entries are
exactly zero and the active block stays SPD.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["STLSQ", "STRRidge", "SR3", "masked_lstsq"]


def masked_lstsq(gram, corr, active, ridge=0.0):
    """Solve (Θᵀ W Θ) ξ = Θᵀ W y restricted to ``active`` coefficients.

    ``gram``: (..., m, m), ``corr``: (..., m), ``active``: (..., m) bool, with
    the leading dimensions broadcast.  Inactive entries of the solution are
    exactly zero.  An exactly singular system gives the LU solve's inf/NaN
    entries, as ``jnp.linalg.solve`` does, and does not raise: such a
    candidate scores non-finite and the selection carries on.
    """
    mask = active.to(gram.dtype)
    A = gram * mask[..., :, None] * mask[..., None, :]
    A = A + torch.diag_embed(1.0 - mask) + ridge * torch.diag_embed(mask)
    b = corr * mask
    A, b = torch.broadcast_tensors(A, b[..., None])
    return torch.linalg.solve_ex(A, b[..., 0]).result


def _eps_ridge(gram):
    return 10.0 * torch.finfo(gram.dtype).eps * torch.diagonal(gram, dim1=-2, dim2=-1).mean(-1)


def _threshold_iterate(gram, corr, lams, ridge, maxiter):
    """STLSQ fixed point for every threshold in ``lams`` (L,): solve →
    hard-threshold → repeat.  Returns ``(xi, active)``, both (L, m).

    The active set shrinks monotonically; an all-thresholded run yields the
    empty model (coefficients exactly zero).
    """
    m = gram.shape[-1]
    active = torch.ones((lams.shape[0], m), dtype=torch.bool, device=gram.device)
    xi = masked_lstsq(gram, corr, active, ridge)
    for _ in range(maxiter):
        active = (xi.abs() >= lams[:, None]) & active
        xi = masked_lstsq(gram, corr, active, ridge)
    # unbiased refit on the selected support: the ridge steers the path, but
    # reported coefficients/residuals must not carry its shrinkage bias
    xi = masked_lstsq(gram, corr, active, _eps_ridge(gram))
    return torch.where(active, xi, torch.zeros_like(xi)), active


@dataclasses.dataclass(frozen=True)
class STLSQ:
    """Sequentially thresholded least squares over a threshold grid
    (Brunton et al. 2016; reference ``STLSQ(exp10.(-3:0.01:5))``)."""

    thresholds: Tuple[float, ...] = tuple(float(x) for x in (0.1,))
    maxiter: int = 10
    # path-stabilizing absolute ridge (pysindy's alpha); final coefficients
    # are always refit unbiased on the selected support
    ridge: float = 0.05

    def fit_grid(self, gram, corr):
        lams = torch.as_tensor(self.thresholds, dtype=gram.dtype, device=gram.device)
        return _threshold_iterate(gram, corr, lams, self.ridge, self.maxiter)


@dataclasses.dataclass(frozen=True)
class STRRidge:
    """Sequential thresholded ridge regression (reference
    ``STRRidge(0.01)``, ``loop_recoveries.jl:120``)."""

    thresholds: Tuple[float, ...] = (0.01,)
    ridge: float = 0.01
    maxiter: int = 10

    def fit_grid(self, gram, corr):
        lams = torch.as_tensor(self.thresholds, dtype=gram.dtype, device=gram.device)
        return _threshold_iterate(gram, corr, lams, self.ridge, self.maxiter)


@dataclasses.dataclass(frozen=True)
class SR3:
    """Sparse relaxed regularized regression (Zheng et al. 2019; reference
    ``SR3(1e-2, 0.1)``, ``loop_recoveries.jl:100``, ``seir_exposure.jl:217``).

    Minimizes ½‖y−Θξ‖² + λ·R(w) + ν/2‖ξ−w‖² by alternating a linear solve in
    ξ with a hard-threshold prox in w; the final structure is refit by masked
    least squares for unbiased coefficients.
    """

    thresholds: Tuple[float, ...] = (0.1,)
    nu: float = 1.0
    maxiter: int = 30

    def fit_grid(self, gram, corr):
        m = gram.shape[0]
        eye = torch.eye(m, dtype=gram.dtype, device=gram.device)
        A_inv = torch.linalg.inv(gram + self.nu * eye)
        lams = torch.as_tensor(self.thresholds, dtype=gram.dtype, device=gram.device)
        kappa = torch.sqrt(2.0 * lams / self.nu)[:, None]
        w = (A_inv @ corr).expand(lams.shape[0], m)
        for _ in range(self.maxiter):
            xi = (corr + self.nu * w) @ A_inv.T
            w = torch.where(xi.abs() >= kappa, xi, torch.zeros_like(xi))
        active = w != 0.0
        # same eps-ridge guard as the STLSQ refit: an active block with more
        # features than rows is exactly singular
        xi = masked_lstsq(gram, corr, active, _eps_ridge(gram))
        return torch.where(active, xi, torch.zeros_like(xi)), active
