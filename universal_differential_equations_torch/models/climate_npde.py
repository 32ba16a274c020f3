"""Climate 1-D neural-PDE model family (``Climate/NeuralPDE/npde.jl``).

Port of ``universal_differential_equations_tpu/models/climate_npde.py``.
Method-of-lines diffusion–advection column: upwind ∂z (D1) and diffusive ∂zz
(D2, κ=0.05) operators built with ghost-node boundary handling exactly as the
reference's ``getops`` (``npde.jl:17-46``), a spectral-radius estimate for the
stabilized solvers' ``eigen_est`` hook, the nonlinear flux truth
``Φ(u)=cos(sin(u³)+sin(cos(u²)))`` (``npde.jl:54-57``), and the neural flux
``D1·NN(u) + D2·u`` (``npde.jl:72-78``).

The operators are dense (30×30, or 126×126 on the reference data's 128
levels) matrices: at this size one dense product is one small matmul and
needs no sparse layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layers import MLP

__all__ = ["getops", "get_u0", "true_rhs", "make_neural_rhs", "eigen_est"]


def getops(n_grid: int = 32, kappa: float = 0.05, dtype=torch.float32, device=None):
    """Build (D1, D2) interior operators with ghost-node BCs
    (``npde.jl:17-46``).  Returns dense (N-2, N-2) matrices and the
    spectral-radius of D2 (the reference's ``EIGEN_EST``) as a Python float,
    from numpy's eigenvalues."""
    N = n_grid
    dz = 1.0 / (N - 1)
    n = N - 2  # interior points

    # D1: first-order upwind ∂z; the ghost column the reference folds in is
    # zeroed by its QQ, so the interior matrix is the plain upwind difference
    D1 = np.diag(np.ones(n)) + np.diag(-np.ones(n - 1), -1)
    D1 = D1 / dz

    # D2: standard second difference with homogeneous Dirichlet ghosts
    D2 = (
        np.diag(-2.0 * np.ones(n))
        + np.diag(np.ones(n - 1), -1)
        + np.diag(np.ones(n - 1), 1)
    )
    D2 = kappa / dz**2 * D2

    eig = float(np.max(np.abs(np.linalg.eigvals(D2))))
    return (torch.as_tensor(D1, dtype=dtype, device=device),
            torch.as_tensor(D2, dtype=dtype, device=device), eig)


def eigen_est(D2):
    """Power-iteration spectral-radius estimate (20 steps, on D2's device)
    for the stabilized solvers' ``eigen_est`` hook (``npde.jl:61``).
    Returns a 0-d tensor; reads nothing back to the host."""
    n = D2.shape[0]
    v = torch.ones((n,), dtype=D2.dtype, device=D2.device) / torch.sqrt(
        torch.tensor(n * 1.0, dtype=D2.dtype, device=D2.device))
    lam = torch.zeros((), dtype=D2.dtype, device=D2.device)
    for _ in range(20):
        w = D2 @ v
        lam = torch.linalg.vector_norm(w)
        v = w / torch.clamp(lam, min=1e-30)
    return lam


def get_u0(n_grid: int = 32, dtype=torch.float32, device=None):
    """Gaussian bump initial condition on the interior grid (``npde.jl:49-52``)."""
    z = torch.linspace(0.0, 1.0, n_grid, dtype=dtype, device=device)[1:-1]
    return torch.exp(-200.0 * (z - 0.75) ** 2)


def true_rhs(t, u, ops):
    """Truth: nonlinear flux through the upwind operator (``npde.jl:54-57``)."""
    D1, D2 = ops
    phi = torch.cos(torch.sin(u**3) + torch.sin(torch.cos(u**2)))
    return D1 @ phi + D2 @ u


def make_neural_rhs(generator, n: int = 30, hidden: int = 8, dtype=torch.float32,
                    device=None):
    """Neural flux model: ``du = D1·NN(u) + D2·u`` with NN 30→8→30 tanh
    (``npde.jl:72-78``).  Returns ``(rhs, params0, net)``, ``params0`` drawn
    from the ``torch.Generator`` ``generator``; ``args = (params, D1, D2)``."""
    net = MLP([n, hidden, n], activation="tanh", final_activation="tanh")
    params0 = net.init(generator, dtype, device)

    def rhs(t, u, args):
        params, D1, D2 = args
        return D1 @ net.apply(params, u) + D2 @ u

    return rhs, params0, net
