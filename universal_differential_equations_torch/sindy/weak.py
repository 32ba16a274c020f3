"""Weak-form (integral) sparse regression — different statistics for noise.

Port of ``universal_differential_equations_tpu/sindy/weak.py``.  Pointwise
SINDy regresses derivative estimates against Θ(X) sample by sample, so
measurement noise enters every regression row at full strength.  The weak
form integrates the dynamics against smooth, compactly supported test
functions φ_k and moves the time derivative onto φ by parts (φ_k vanishes at
its window ends):

    ∫ φ_k u̇ dt = -∫ φ_k' u dt

so   -∫ φ_k' u dt  =  ∫ φ_k f_known(u) dt  +  (∫ φ_k Θ(u) dt) · ξ.

Each regression row averages the sample noise over a whole test window, and
no derivative is estimated (Weak SINDy, Messenger & Bortz,
arXiv:2005.04339).  The K test windows are rows of two dense (K, N)
quadrature-weighted matrices, so the weak pair is two small matmuls.

Test functions are polynomial bumps φ(t) ∝ ((t−a)(b−t))^p on sliding windows
[a, b]; with p ≥ 3 the integrand's first p−1 derivatives vanish at the window
ends, so trapezoid quadrature on the sample grid itself is high-order
accurate there.

Selection caveat (measured with the JAX package): overlapping windows make
the weak rows few and strongly correlated, so purely statistical parsimony
over-selects on a weak pair even on clean data.  Pair the weak rows with the
simulation judge (:func:`~.select.cv_ladder` rungs into
:func:`~.select.select_by_simulation`); :func:`~.solve.sindy` accepts a
:class:`WeakDataDrivenProblem`, but its statistical selection is only
trustworthy when rows are plentiful relative to the library.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from .basis import Basis

__all__ = ["test_function_matrices", "weak_pair", "WeakDataDrivenProblem"]


def test_function_matrices(ts, width: int, stride: int = 1, p: int = 5):
    """Quadrature-weighted test-function matrices on the sample grid.

    Args:
      ts: (N,) sample times (trapezoid weights handle uneven grids).
      width: window length in samples (``width >= 3``); window k covers
        samples ``[k·stride, k·stride + width - 1]``.
      stride: window start stride in samples.
      p: bump exponent of φ(t) ∝ ((t−a)(b−t))^p (p ≥ 3 keeps the trapezoid
        rule high-order; 5 is the default).

    Returns ``(Phi, dPhi)``: (K, N) with ``Phi[k, j] = q_j·φ_k(t_j)`` and
    ``dPhi[k, j] = q_j·φ'_k(t_j)`` (q = trapezoid weights restricted to the
    window), rows normalized by ‖φ_k‖_{L2}.  ``Phi @ f(X)`` ≈ ∫φ_k f dt and
    ``dPhi @ X`` ≈ ∫φ'_k u dt for samples X on ``ts``.
    """
    ts = torch.as_tensor(ts)
    N = ts.shape[0]
    width, stride = int(width), int(stride)
    assert width >= 3, f"test-function window needs >= 3 samples, got {width}"
    assert width <= N, f"window width {width} exceeds {N} samples"
    starts = torch.arange(0, N - width + 1, stride, device=ts.device)  # (K,)
    j = torch.arange(N, device=ts.device)
    a = ts[starts][:, None]
    b = ts[starts + width - 1][:, None]
    inside = (j >= starts[:, None]) & (j <= starts[:, None] + width - 1)  # (K, N)
    zero = torch.zeros((), dtype=ts.dtype, device=ts.device)
    t_next = torch.cat([ts[1:], ts[-1:]])
    t_prev = torch.cat([ts[:1], ts[:-1]])
    # trapezoid weights restricted to [a, b]
    q = 0.5 * torch.where(inside, torch.minimum(t_next, b) - torch.maximum(t_prev, a), zero)
    raw = torch.where(inside, (ts - a) * (b - ts), zero)
    phi = raw**p
    dphi = torch.where(inside, p * raw ** (p - 1) * (a + b - 2.0 * ts), zero)
    # dtype-aware degenerate-window guard (a float64 literal would underflow
    # to 0 in float32)
    norm = torch.sqrt(torch.sum(q * phi**2, dim=1, keepdim=True))
    norm = torch.clamp(norm, min=torch.finfo(norm.dtype).tiny)
    return q * phi / norm, q * dphi / norm


def weak_pair(
    ts,
    X,
    basis: Basis,
    known_rhs: Optional[Callable] = None,
    *,
    widths: Optional[Sequence[int]] = None,
    stride: int = 1,
    p: int = 5,
    features: Optional[Callable] = None,
):
    """Weak-form regression pair ``(G, B)`` from noisy state samples.

    Solves for sparse ξ in ``u̇ = f_known(u) + Θ(u)·ξ`` without estimating a
    derivative: ``G[k, i] = ∫φ_k θ_i(u) dt`` and ``B[k, d] = -∫φ'_k u_d dt -
    ∫φ_k f_known(u)_d dt``, so ``G @ ξ ≈ B``.

    Args:
      ts: (N,) sample times.
      X: (N, d) state samples.
      basis: candidate feature library Θ.
      known_rhs: optional known part of the dynamics, a per-sample callable
        ``u -> (d,)`` (mapped with ``torch.func.vmap``); its contribution
        moves to the target side so ξ models only the missing terms.
      features: optional per-sample map ``u -> (q,)`` applied before the
        basis (libraries in derived coordinates, such as the SEIR exposure's
        [S/N, 1e5·I, 1e5·D/N]); ``∫φ'u`` stays on the raw observables.
      widths: window widths in samples, stacked multi-scale (default: one
        width ≈ N/2, at least 2p + 3).
      stride / p: see :func:`test_function_matrices`.

    Returns ``(G, B)`` with G: (K, m), B: (K, d), usable wherever a
    pointwise ``(Θ(X), Y)`` pair is.
    """
    ts = torch.as_tensor(ts)
    X = torch.as_tensor(X)
    N = ts.shape[0]
    if widths is None:
        widths = (max(2 * int(p) + 3, N // 2),)
    mats = [test_function_matrices(ts, w, stride=stride, p=p) for w in widths]
    Phi = torch.cat([m[0] for m in mats])
    dPhi = torch.cat([m[1] for m in mats])
    feat = X if features is None else torch.func.vmap(features)(X)
    G = Phi @ basis.theta(feat)
    B = -(dPhi @ X)
    if known_rhs is not None:
        B = B - Phi @ torch.func.vmap(known_rhs)(X)
    return G, B


@dataclasses.dataclass(frozen=True)
class WeakDataDrivenProblem:
    """Weak-form problem for the :func:`~.solve.sindy` front end.

    The sibling of ``DirectDataDrivenProblem`` and
    ``ContinuousDataDrivenProblem``: the front end fits the weak pair (G, B)
    in place of (Θ(X), Y), so coefficients come back in the same basis
    scale and the :class:`~.solve.SINDyResult` round trip is unchanged.
    """

    X: torch.Tensor  # (N, d) state samples
    t: torch.Tensor  # (N,) sample times
    known_rhs: Optional[Callable] = None
    widths: Optional[Tuple[int, ...]] = None
    stride: int = 1
    p: int = 5
    features: Optional[Callable] = None

    def realize(self, basis: Basis):
        return weak_pair(self.t, self.X, basis, self.known_rhs, widths=self.widths,
                         stride=self.stride, p=self.p, features=self.features)
