"""Neural-ODE convenience wrapper.

Port of ``universal_differential_equations_tpu/models/neural_ode.py``: the
reference's ``neural_ode(NN, u0, tspan, alg; saveat, save_start)``
(``Climate/Training/neural_pde_rayleigh_taylor_instability.jl:125``), a thin
front end that makes the network itself the right-hand side.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..adjoint.sensitivity import AbstractAdjoint
from ..api import solve
from ..core.problem import ODEProblem

__all__ = ["neural_ode", "NeuralODE"]


def neural_ode(net, params, u0, tspan, solver=None, *, saveat=None,
               rtol=1e-6, atol=1e-8, adjoint: Optional[AbstractAdjoint] = None,
               max_steps: Optional[int] = None, time_input: bool = False):
    """Solve ``du/dt = net(params, u)`` (or ``net(params, [u; t])`` with
    ``time_input=True``).  Returns the ``Solution``; differentiable with
    respect to ``params`` under the chosen adjoint."""
    if time_input:
        def rhs(t, u, p):
            t = torch.as_tensor(t, dtype=u.dtype, device=u.device).reshape(1)
            return net.apply(p, torch.cat([u, t]))
    else:
        def rhs(t, u, p):
            return net.apply(p, u)

    prob = ODEProblem(rhs, u0, tspan, params)
    return solve(prob, solver, saveat=saveat, rtol=rtol, atol=atol,
                 adjoint=adjoint, max_steps=max_steps)


class NeuralODE:
    """Callable neural-ODE layer: ``NeuralODE(net, tspan)(params, u0)``
    returns the terminal state (or the saved states with ``saveat``) — the
    one-step propagator pattern of the climate training pipeline
    (``neural_pde_rayleigh_taylor_instability.jl:124-127``)."""

    def __init__(self, net, tspan, solver=None, *, rtol=1e-6, atol=1e-8,
                 adjoint=None, max_steps=256, saveat=None):
        self.net = net
        self.tspan = tspan
        self.solver = solver
        self.kw = dict(rtol=rtol, atol=atol, adjoint=adjoint,
                       max_steps=max_steps, saveat=saveat)

    def __call__(self, params, u0):
        sol = neural_ode(self.net, params, u0, self.tspan, self.solver, **self.kw)
        return sol.ys if self.kw["saveat"] is not None else sol.y_final
