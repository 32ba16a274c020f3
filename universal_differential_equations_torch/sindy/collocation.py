"""Kernel collocation: derivative estimation from noisy trajectories (C20).

Port of ``universal_differential_equations_tpu/sindy/collocation.py``: the
reference's ``ContinuousDataDrivenProblem(Xₙ, t, GaussianKernel())``
(``hudson_bay.jl:48``).  Local linear (weighted) regression at every sample
time — the smoothed state is the local intercept, the derivative the local
slope — as a few dense contractions over the (N, N) weight matrix.
"""
from __future__ import annotations

import torch

__all__ = ["collocate_data"]

_KERNELS = {
    "gaussian": lambda r: torch.exp(-0.5 * r * r),
    "epanechnikov": lambda r: torch.clamp(1.0 - r * r, min=0.0),
    "triangular": lambda r: torch.clamp(1.0 - r.abs(), min=0.0),
}


def collocate_data(X, t, kernel: str = "gaussian", bandwidth=None):
    """Estimate smoothed states and derivatives from samples.

    Args:
      X: (N, n) noisy samples at times ``t`` (N,).
      kernel: 'gaussian' | 'epanechnikov' | 'triangular'.
      bandwidth: kernel width in time units; default is four median sample
        spacings.

    Returns:
      (X_smooth, DX): both (N, n).
    """
    X = torch.as_tensor(X)
    t = torch.as_tensor(t, dtype=X.dtype, device=X.device)
    if bandwidth is None:
        # numpy's median: the mean of the two middle values for an even count
        bandwidth = 4.0 * torch.quantile(torch.diff(t), 0.5)
    K = _KERNELS[kernel]

    dt = t[None, :] - t[:, None]  # dt[i, j] = t_j - t_i
    W = K(dt / bandwidth)  # (N, N)

    S0 = W.sum(dim=1)  # (N,)
    S1 = (W * dt).sum(dim=1)
    S2 = (W * dt * dt).sum(dim=1)
    T0 = W @ X  # (N, n)
    T1 = (W * dt) @ X

    det = S0 * S2 - S1 * S1
    det = torch.where(det.abs() > 1e-30, det, torch.full_like(det, 1e-30))
    a = (S2[:, None] * T0 - S1[:, None] * T1) / det[:, None]  # intercept
    b = (S0[:, None] * T1 - S1[:, None] * T0) / det[:, None]  # slope
    return a, b
