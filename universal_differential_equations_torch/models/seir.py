"""SEIR exposure case study (``SEIR_exposure/seir_exposure.jl``).

Port of ``universal_differential_equations_tpu/models/seir.py``.  A 7-state
COVID model (S, E, I, R, N, D, C) with a quarantine-responsive transmission
rate β(t) (``seir_exposure.jl:16-30``), and its two learned variants: (a) the
black-box neural ODE replacing 5 of the 7 equations (``:52-64``) and (b) the
UDE replacing only the exposure term with an MLP on the physics-restricted
inputs ``[S/N, I, D/N]`` (``:114-130``).

The reference works at population scale 1.4e7 in float64.  The system is
homogeneous of degree 1 in the state, so every state here is normalized by
S0: the same dynamics with the same parameters, and float32-safe.

Every right-hand side takes one state ``(7,)`` or a batch ``(..., 7)``: it
unbinds the last axis and stacks its outputs there, and reads no tensor on
the host, so it runs under ``torch.func.vmap``, ``grad`` and ``jacfwd``.
"""
from __future__ import annotations

import torch

from ..nn.layers import MLP

__all__ = ["P_SEIR", "U0_NORM", "corona_rhs", "beta_t", "exposure_rhs", "make_neural_ode",
           "make_exposure_ude", "true_exposure", "make_recovered_rhs"]

_S0 = 14e6
# F, β0, α, κ, μ, σ, γ, d, λ (seir_exposure.jl:34), in float64 on the CPU;
# cast them to the problem's dtype and device.  F is an absolute import rate,
# rescaled by S0 inside the right-hand sides.
P_SEIR = torch.tensor([10.0, 0.5944, 0.4239, 1117.3, 0.02, 1 / 3, 1 / 5, 0.2, 1 / 11.2],
                      dtype=torch.float64)
# u0 = [0.9·S0, 0, 0, 0, S0, 0, 0] / S0
U0_NORM = torch.tensor([0.9, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0], dtype=torch.float64)
# the same constants as Python floats, for the learned variants' known physics
_F, _BETA0, _ALPHA, _KAPPA, _MU, _SIGMA, _GAMMA, _D, _LAM = P_SEIR.tolist()


def beta_t(t, D, N, p=None):
    """Quarantine-responsive transmission β = β0(1−α)(1−D/N)^κ
    (``seir_exposure.jl:30``)."""
    p = P_SEIR if p is None else p
    beta0, alpha, kappa = p[1], p[2], p[3]
    return beta0 * (1.0 - alpha) * (1.0 - D / N) ** kappa


def corona_rhs(t, u, p):
    """Ground-truth 7-state model in normalized population units
    (``corona!``, ``seir_exposure.jl:16-29``)."""
    S, E, I, R, N, D, C = u.unbind(-1)
    F, beta0, alpha, kappa, mu, sigma, gamma, d, lam = p.unbind(-1)
    F = F / _S0  # imported-cases rate in normalized units
    bt = beta_t(t, D, N, p)
    exposure = beta0 * S * F / N + bt * S * I / N
    dS = -exposure - mu * S
    dE = exposure - (sigma + mu) * E
    dI = sigma * E - (gamma + mu) * I
    dR = gamma * I - mu * R
    dN = -mu * N
    dD = d * gamma * I - lam * D
    dC = sigma * E
    return torch.stack([dS, dE, dI, dR, dN, dD, dC], -1)


def true_exposure(u, p=None):
    """The quarantine-driven part of the exposure the UDE must learn:
    z = β(t)·S·I/N (``seir_exposure.jl:210``)."""
    S, E, I, R, N, D, C = u.unbind(-1)
    return beta_t(0.0, D, N, P_SEIR if p is None else p) * S * I / N


def exposure_rhs(u, z):
    """The seven derivatives of states ``u`` (..., 7) with the exposure term
    replaced by ``z`` (...): the physics the UDE, the recovered models and the
    weak-form arm keep (``dudt_``, ``seir_exposure.jl:117-130``)."""
    S, E, I, R, N, D, C = u.unbind(-1)
    imported = _BETA0 * S * (_F / _S0) / N
    dS = -imported - z - _MU * S
    dE = imported + z - (_SIGMA + _MU) * E
    dI = _SIGMA * E - (_GAMMA + _MU) * I
    dR = _GAMMA * I - _MU * R
    dN = -_MU * N
    dD = _D * _GAMMA * I - _LAM * D
    dC = _SIGMA * E
    return torch.stack([dS, dE, dI, dR, dN, dD, dC], -1)


def make_neural_ode(generator, width: int = 64, dtype=torch.float32, device=None,
                    output_scale: float = 1e-5):
    """Black-box neural ODE: MLP 7→64→64→64→5 replaces (dS, dE, dI, dR, dD);
    dN and dC stay physical (``dudt_node``, ``seir_exposure.jl:55-64``).

    ``output_scale`` maps the O(1) net outputs onto the magnitude of the
    normalized derivatives (E, I, R ~1e-5/day).  Weights are drawn from
    ``generator`` (a CPU ``torch.Generator``).  Returns ``(rhs, params0,
    net)``.
    """
    net = MLP([7, width, width, width, 5], activation="tanh")
    params0 = net.init(generator, dtype, device)

    def rhs(t, u, params):
        S, E, I, R, N, D, C = u.unbind(-1)
        feats = torch.stack([S / N, E * 1e5, I * 1e5, R * 1e5, N, D / N * 1e5, C * 1e5], -1)
        dS, dE, dI, dR, dD = (output_scale * net.apply(params, feats)).unbind(-1)
        return torch.stack([dS, dE, dI, dR, -_MU * N, dD, _SIGMA * E], -1)

    return rhs, params0, net


def make_exposure_ude(generator, width: int = 64, dtype=torch.float32, device=None):
    """UDE: MLP 3→64→64→1 on the physics-restricted features
    [S/N, 1e5·I, 1e5·D/N] replaces only the exposure term (``dudt_``,
    ``seir_exposure.jl:117-130``).  Returns ``(rhs, params0, net)``."""
    net = MLP([3, width, width, 1], activation="tanh")
    params0 = net.init(generator, dtype, device)

    def rhs(t, u, params):
        S, E, I, R, N, D, C = u.unbind(-1)
        z = 1e-5 * net.apply(params, torch.stack([S / N, I * 1e5, D / N * 1e5], -1))[..., 0]
        return exposure_rhs(u, z)

    return rhs, params0, net


def make_recovered_rhs(sindy_result):
    """The recovered symbolic exposure in place of the net (``approx``,
    ``seir_exposure.jl:232-246``); parameters are the active coefficients."""
    rec = sindy_result.rhs()

    def rhs(t, u, coeffs):
        S, E, I, R, N, D, C = u.unbind(-1)
        z = 1e-5 * rec(t, torch.stack([S / N, I * 1e5, D / N * 1e5], -1), coeffs)[..., 0]
        return exposure_rhs(u, z)

    return rhs
