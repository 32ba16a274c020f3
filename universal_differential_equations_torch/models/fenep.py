"""FENE-P non-Newtonian rheology UDE (``NonNewtonianFluids/FENEP.jl``).

Port of ``universal_differential_equations_tpu/models/fenep.py``.

Ground truth: the 6-equation FENE-P constitutive model — 3 differential
stress equations and 3 algebraic conformation relations — an index-1 DAE
solved by the BDF solver with a ``differential_vars`` mask (the reference
uses Sundials IDA, ``FENEP.jl:24-39``).

Surrogate: a 1-state UDE whose RHS is a small net ``f1([σ̃, γ̇(t)])`` with a
second net ``f0([σ̃, γ̇(t)])`` as the stress readout (``FENEP.jl:41-62``),
trained across a family of oscillatory strain rates and tested on a held-out
frequency against the exact DAE solution.

``gamma_d`` is called with a tensor time of the state's dtype and device
(``torch.cos`` refuses a Python float).  The truth functions'
``x64_host=True`` solves a float32 request in float64 on the request's own
device and returns float32; the JAX package runs that solve on the host CPU
only because a TPU has no usable float64.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..adjoint.sensitivity import NoAdjoint
from ..api import solve
from ..core.problem import DAEProblem, ODEProblem
from ..nn.layers import MLP
from ..solvers.bdf import daeint

__all__ = ["fenep_residual", "fenep_stiff_rhs", "find_sigma_exact",
           "find_sigma_exact_ode", "make_surrogate", "P_FENEP"]

P_FENEP = (2.0, 4.0, 2.0)  # λ, η, L (FENEP.jl:27-29)


def fenep_residual(gamma_d: Callable, p=P_FENEP):
    """DAE residual F(t, u, du) for states (θ11, θ22, θ12, τ11, τ22, τ12)
    (``FENEP.jl:9-22``)."""
    lam, eta, L = p

    def F(t, u, du, args):
        th, tau = u[:3], u[3:]
        t11, t22, t12 = tau.unbind(0)
        a = L**2 / (L**2 - 3.0)
        f_lam = (L**2 + (lam / eta / a) * (t22 + t11)) / (L**2 - 3.0)
        gd = gamma_d(t)
        stress = torch.stack([
            t11 + du[0] - 2.0 * lam * gd * t12 / f_lam,
            t22 + du[1],
            t12 + du[2] - lam * gd * t22 / f_lam - eta / f_lam * gd,
        ])
        # the three conformation rows θij - λ·τij/f at once (the same
        # operations, in the same order, as row by row)
        return torch.cat([stress, th - lam * tau / f_lam])

    return F


def _work(tsave, x64_host):
    """``(tsave, dtype)``: the save grid as a tensor in the dtype the solve
    runs in, and the dtype the caller gets back."""
    tsave = torch.as_tensor(tsave)
    dtype = tsave.dtype
    if x64_host and dtype == torch.float32:
        tsave = tsave.to(torch.float64)
    return tsave, dtype


def find_sigma_exact(tsave, gamma_d, p=P_FENEP, rtol=1e-7, atol=1e-9,
                     max_steps=16384, x64_host: bool = True):
    """Exact shear stress τ12(t) from the BDF DAE solve (``find_σ_exact``,
    ``FENEP.jl:24-39``), on ``tsave``'s device: ``(τ12, success)``.

    ``x64_host=True`` runs a float32 request in float64 (on the same device)
    and returns float32: tight-tolerance truth generation is where float32
    Newton cannot meet the error test; training stays in float32.
    """
    ts, dtype = _work(tsave, x64_host)
    lam, eta, L = p
    zeros = torch.zeros(6, dtype=ts.dtype, device=ts.device)
    gd0 = gamma_d(torch.zeros((), dtype=ts.dtype, device=ts.device))
    du0 = torch.where(torch.arange(6, device=ts.device) == 2,
                      eta * gd0 * (L**2 - 3.0) / L**2, zeros)
    prob = DAEProblem(
        f=fenep_residual(gamma_d, p),
        u0=zeros, du0=du0,
        tspan=(ts[0], ts[-1]),
        differential_vars=torch.tensor([True, True, True, False, False, False],
                                       device=ts.device),
    )
    sol = daeint(prob, saveat=ts, rtol=rtol, atol=atol, max_steps=max_steps)
    return sol.ys[:, 5].to(dtype), sol.success  # τ12 column


def fenep_stiff_rhs(gamma_d: Callable, p=P_FENEP):
    """Explicit stiff-ODE form of the FENE-P model in the conformation
    variables θ = (θ11, θ22, θ12).

    The algebraic half of the DAE (``FENEP.jl:9-22``) is index-1 —
    ``θij = λ·τij/f(τ)`` with ``f`` depending only on ``τ11+τ22`` — so it
    inverts in closed form: ``f(θ) = L² / ((L²−3) − (θ11+θ22)/(η·a))`` and
    ``τij = θij·f/λ``.  The three differential equations then close as an
    explicit stiff ODE, the consumer path for the implicit solvers: solving
    it must reproduce the BDF DAE's τ12.

    Returns ``(rhs, tau_of_theta)``: the ODE rhs over θ and the readout
    mapping θ → (τ11, τ22, τ12) (one state, or a batch along the first axis).
    """
    lam, eta, L = p
    a = L**2 / (L**2 - 3.0)

    def f_of_theta(theta):
        return L**2 / ((L**2 - 3.0) - (theta[..., 0] + theta[..., 1]) / (eta * a))

    def tau_of_theta(theta):
        return theta * f_of_theta(theta)[..., None] / lam

    def rhs(t, theta, args):
        f = f_of_theta(theta)
        t11, t22, t12 = (theta * f / lam).unbind(-1)
        gd = gamma_d(t)
        return torch.stack([
            -t11 + 2.0 * lam * gd * t12 / f,
            -t22,
            -t12 + lam * gd * t22 / f + eta * gd / f,
        ])

    return rhs, tau_of_theta


def find_sigma_exact_ode(tsave, gamma_d, solver, p=P_FENEP, rtol=1e-7,
                         atol=1e-9, max_steps=16384, x64_host: bool = True):
    """Exact τ12(t) via the index-1-reduced stiff ODE and an implicit solver
    (Kvaerno3/SDIRK4/SDIRK3/Rosenbrock23) — the cross-check of the BDF DAE
    truth of :func:`find_sigma_exact`: ``(τ12, success)``."""
    ts, dtype = _work(tsave, x64_host)
    rhs, tau_of_theta = fenep_stiff_rhs(gamma_d, p)
    prob = ODEProblem(rhs, torch.zeros(3, dtype=ts.dtype, device=ts.device),
                      (ts[0], ts[-1]), None)
    sol = solve(prob, solver, saveat=ts, rtol=rtol, atol=atol, adjoint=NoAdjoint(),
                max_steps=max_steps)
    return tau_of_theta(sol.ys)[:, 2].to(dtype), sol.success


def make_surrogate(generator, hidden: int = 4, linear: bool = False,
                   dtype=torch.float32, device=None):
    """The reference's two small nets: ``f1`` (latent dynamics) and ``f0``
    (stress readout), 2→4→1 tanh, or the linear baseline (``FENEP.jl:83-86``).
    Weights are drawn from ``generator`` (``f1``'s first).  Returns
    ``(f1_net, f0_net, params0)``."""
    if linear:
        f1 = MLP([2, 1], activation="identity")
        f0 = MLP([2, 1], activation="identity")
    else:
        f1 = MLP([2, hidden, 1], activation="tanh")
        f0 = MLP([2, hidden, 1], activation="tanh")
    params0 = {"f1": f1.init(generator, dtype, device), "f0": f0.init(generator, dtype, device)}
    return f1, f0, params0
