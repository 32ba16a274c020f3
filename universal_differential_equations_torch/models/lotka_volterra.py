"""Lotka-Volterra UDE model family (reference ``LotkaVolterra/`` case studies).

Port of ``universal_differential_equations_tpu/models/lotka_volterra.py``:
generate LV truth at tight tolerance, corrupt it with mean-proportional
noise, train a UDE whose MLP learns the missing interaction terms, recover
their closed form with SINDy, and extrapolate (``scenario_1.jl`` end to
end; the pipeline is ``examples/lv_scenario_1.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..adjoint.sensitivity import NoAdjoint
from ..api import solve
from ..core.problem import ODEProblem
from ..nn.layers import MLP
from ..solvers.runge_kutta import Vern7

__all__ = [
    "lotka_rhs",
    "generate_data",
    "make_ude",
    "make_recovered_rhs",
    "P_TRUE",
    "U0",
]

# reference parameters and initial condition (``scenario_1.jl:37-39``), in
# float64 on the CPU; cast them to the problem's dtype and device
P_TRUE = torch.tensor([1.3, 0.9, 0.8, 1.8], dtype=torch.float64)
U0 = torch.tensor([0.44249296, 4.6280594], dtype=torch.float64)


def lotka_rhs(t, u, p):
    """du1 = α u1 - β u1 u2 ; du2 = γ u1 u2 - δ u2 (``scenario_1.jl:30-35``)."""
    x, y = u[0], u[1]
    alpha, beta, gamma, delta = p[0], p[1], p[2], p[3]
    return torch.stack([alpha * x - beta * x * y, gamma * x * y - delta * y])


def generate_data(
    noise=None,
    tspan: Tuple[float, float] = (0.0, 3.0),
    dt_save: float = 0.1,
    noise_magnitude: float = 5e-3,
    u0=None,
    p=None,
    rtol: float = 1e-12,
    atol: float = 1e-12,
    dtype=torch.float64,
    device=None,
):
    """Truth at Vern7/1e-12 on a 0.1-grid over the reference's (0, 3)
    training window plus mean-proportional noise (``scenario_1.jl:36-53``).

    ``noise`` is a ``torch.Generator`` that draws the standard-normal noise on
    the CPU, or an array of such draws of the data's shape (so a caller can
    hand in another package's draws).  Returns ``(ts, X_clean, X_noisy)``.
    """
    u0 = U0 if u0 is None else u0
    p = P_TRUE if p is None else p
    ts = torch.as_tensor(np.arange(tspan[0], tspan[1] + dt_save / 2, dt_save),
                         dtype=dtype, device=device)
    prob = ODEProblem(lotka_rhs, torch.as_tensor(u0, dtype=dtype, device=device), tspan,
                      torch.as_tensor(p, dtype=dtype, device=device))
    sol = solve(prob, Vern7(), saveat=ts, rtol=rtol, atol=atol,
                adjoint=NoAdjoint(), step_to_saveat=True)
    # at an unreachable tolerance the stepper exhausts max_steps and the
    # clamped tail would silently poison the training data
    if not bool(sol.success):
        raise RuntimeError(f"truth generation failed at rtol={rtol} (float32 cannot "
                           "reach 1e-12-class tolerances — use float64)")
    X = sol.ys
    if isinstance(noise, torch.Generator):
        draws = torch.randn(X.shape, generator=noise, dtype=torch.float64)
    else:
        draws = torch.tensor(np.asarray(noise))
    draws = draws.to(dtype=dtype, device=device)
    return ts, X, X + noise_magnitude * X.mean(dim=0) * draws


def make_ude(generator, hidden: int = 5, depth: int = 3, activation="rbf",
             p_known=None, dtype=torch.float32, device=None):
    """Scenario-1 hybrid model: known linear physics + MLP interactions.

    ``du1 = α u1 + NN1(u)``, ``du2 = -δ u2 + NN2(u)`` with the 2→5→5→5→2
    Gaussian-RBF net (``scenario_1.jl:59-73``).  Returns ``(rhs, params0,
    net)`` with ``params`` the bare NN pytree (a list of ``{"w", "b"}``).
    """
    p_known = P_TRUE if p_known is None else p_known
    net = MLP([2] + [hidden] * depth + [2], activation=activation)
    params0 = net.init(generator, dtype, device)
    alpha = float(p_known[0])
    delta = float(p_known[3])

    def rhs(t, u, params):
        nn = net.apply(params, u)
        return torch.stack([alpha * u[0] + nn[0], -delta * u[1] + nn[1]])

    return rhs, params0, net


def make_recovered_rhs(sindy_result, p_known=None):
    """Hybrid RHS with the SINDy-recovered interactions in place of the NN
    (``scenario_1.jl:183-191``): parameters are the active SINDy
    coefficients, refittable by gradient descent (C21)."""
    p_known = P_TRUE if p_known is None else p_known
    interaction = sindy_result.rhs()
    alpha = float(p_known[0])
    delta = float(p_known[3])

    def rhs(t, u, p):
        term = interaction(t, u, p)
        return torch.stack([alpha * u[0] + term[0], -delta * u[1] + term[1]])

    return rhs
