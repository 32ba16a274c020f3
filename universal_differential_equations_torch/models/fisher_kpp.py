"""Fisher-KPP universal PDE (``FisherKPP/Fisher-KPP-CNN*.jl``).

Port of ``universal_differential_equations_tpu/models/fisher_kpp.py``.
Reaction–diffusion ρ_t = r·ρ(1−ρ) + D·ρ_xx on a periodic 26-point line,
method of lines (``Fisher-KPP-CNN.jl:51-67``).  The learned model is a
pointwise reaction network plus a learnable 3-tap periodic stencil scaled by
D0 (``:92-126``), in seven reaction variants: the paper MLP 1→10→20→10→1,
the small MLPs 1→w→1 (w = 3, 2, 1) and the spectral Fourier bases with
3, 5 and 7 terms.

On a CUDA float32 state the MLP variants' RHS runs as one launch of the fused
reaction+stencil kernel (:mod:`..ops.stencil`), at any grid size.
"""
from __future__ import annotations

import torch

from ..nn.layers import MLP, FourierBasis
from ..ops.stencil import FusedUpdetRHS

__all__ = ["NX", "generate_data", "make_model", "make_residuals", "true_rhs",
           "periodic_laplacian", "rho0", "zero_sum_penalty"]

D_TRUE = 0.01
R_TRUE = 1.0
NX = 26
DX = 0.04
T_END = 5.0
DT_SAVE = 0.5


def periodic_laplacian(u):
    """Second difference with periodic wrap, scaled by 1/dx²."""
    return (torch.roll(u, 1, -1) - 2.0 * u + torch.roll(u, -1, -1)) / DX**2


def rho0(dtype=torch.float32, device=None):
    """Reference IC-1: a tanh-edged plateau (``Fisher-KPP-CNN.jl:29-31``)."""
    x = torch.arange(NX, dtype=dtype, device=device) * DX
    amp, delta = 1.0, 0.2
    return (
        amp
        * (
            torch.tanh((x - (0.5 - delta / 2)) / (delta / 10))
            - torch.tanh((x - (0.5 + delta / 2)) / (delta / 10))
        )
        / 2
    )


def true_rhs(t, u, args):
    return R_TRUE * u * (1.0 - u) + D_TRUE * periodic_laplacian(u)


def generate_data(rtol=1e-8, atol=1e-10, dtype=torch.float32, device=None):
    """Training snapshots on the reference's 0.5-spaced grid: ``(ts, ys)``."""
    from ..adjoint.sensitivity import NoAdjoint
    from ..api import solve
    from ..core.problem import ODEProblem
    from ..solvers.runge_kutta import Tsit5

    ts = torch.arange(0.0, T_END + DT_SAVE / 2, DT_SAVE, dtype=dtype, device=device)
    sol = solve(
        ODEProblem(true_rhs, rho0(dtype, device), (0.0, T_END)), Tsit5(), saveat=ts,
        rtol=rtol, atol=atol, adjoint=NoAdjoint(), step_to_saveat=True,
    )
    # truth-solve discipline: at unreachable tolerances the stepper exhausts
    # max_steps and the clamped tail would silently poison the training data
    if not bool(sol.success):
        raise RuntimeError("Fisher-KPP truth solve failed (tolerances?)")
    return ts, sol.ys


# Reaction-MLP widths for the reference's wall-clock study
# (Fisher-KPP-CNN-Small.jl:88-94, rows at :311-391).
_MLP_VARIANTS = {
    "mlp": [1, 10, 20, 10, 1],  # the paper version (Fisher-KPP-CNN.jl:92-96)
    "small": [1, 3, 1],    # the "15 parameters" study row
    "small7": [1, 2, 1],   # the "7 parameters" study row
    "small4": [1, 1, 1],   # the "4 parameters" row — reference never converges
}
_FOURIER_VARIANTS = {"fourier": 3, "fourier5": 5, "fourier7": 7}


def make_model(generator, variant: str = "mlp", dtype=torch.float32, device=None):
    """Learnable reaction + stencil model: ``(rhs, params0)``.

    ``params0 = {"rx": reaction params, "w": 3-tap stencil, "D0": scalar}``,
    named and laid out as in the JAX package.  The stencil starts at the
    reference's [1.1, -2.5, 1.0] and D0 at 6.5 (``Fisher-KPP-CNN.jl:98-107``).
    Reaction weights are drawn from ``generator`` (a CPU ``torch.Generator``).
    The Fourier reaction is ``{1, sin(u), cos(u), …} @ w`` on the raw state
    (see the JAX module for why the reference's u/π scaling was dropped).
    """
    mlp_rx = None
    if variant in _MLP_VARIANTS:
        rx = mlp_rx = MLP(_MLP_VARIANTS[variant], activation="tanh")
        rx_params = rx.init(generator, dtype, device)

        def apply_rx(p, u):
            return rx.apply(p, u[:, None])[:, 0]
    elif variant in _FOURIER_VARIANTS:
        n = _FOURIER_VARIANTS[variant]
        basis = FourierBasis(n, include_constant=True)
        w = 0.01 * torch.randn((1, n), generator=generator, dtype=torch.float64)
        rx_params = {"w": w.to(dtype=dtype, device=device)}

        def apply_rx(p, u):
            return basis(u) @ p["w"][0]
    else:
        raise ValueError(f"unknown variant {variant!r}")

    params0 = {
        "rx": rx_params,
        "w": torch.tensor([1.1, -2.5, 1.0], dtype=dtype, device=device),
        "D0": torch.tensor(6.5, dtype=dtype, device=device),
    }

    def rhs(t, u, params):
        if mlp_rx is not None and _use_fused(u):
            flat = [t_ for wb in mlp_rx.as_matmul_params(params["rx"]) for t_ in wb]
            return FusedUpdetRHS.apply(u, params["w"], params["D0"], *flat)
        w = params["w"]
        conv = w[0] * torch.roll(u, 1) + w[1] * u + w[2] * torch.roll(u, -1)
        return apply_rx(params["rx"], u) + params["D0"] * conv

    return rhs, params0


def _use_fused(u) -> bool:
    """Fused-kernel dispatch: a float32 1-D state on a CUDA device, any N.

    The same dtype rule as the JAX package (a float64 state takes the plain
    path), without the TPU's N % 1024 tiling rule.
    """
    return u.is_cuda and u.dtype == torch.float32 and u.ndim == 1


def zero_sum_penalty(params, weight: float = 100.0):
    """Zero-sum stencil constraint (``Fisher-KPP-CNN.jl:140-143``), in the
    smooth form ``10⁴·(Σw)²`` the JAX package uses."""
    s = torch.sum(params["w"])
    return weight * weight * s * s


def make_residuals(rhs, ts, data):
    """The LM residuals of the case study and the benchmark: the solve's
    states minus the data on the save grid, and the zero-sum penalty's square
    root as one more row."""
    from ..adjoint.sensitivity import ForwardSensitivity
    from ..api import solve
    from ..core.problem import ODEProblem
    from ..solvers.runge_kutta import Tsit5

    def residuals(p):
        sol = solve(
            ODEProblem(rhs, data[0], (0.0, T_END), p), Tsit5(),
            saveat=ts, rtol=1e-4, atol=1e-6,
            adjoint=ForwardSensitivity(), max_steps=192,
        )
        pen = torch.sqrt(zero_sum_penalty(p) + 1e-30)
        r = torch.cat([(sol.ys - data).reshape(-1), pen[None]])
        # unstable candidates that exhaust max_steps give inf residuals, so
        # the optimizer rejects them instead of fitting a clamped tail
        return torch.where(sol.success, r, torch.inf)

    return residuals
