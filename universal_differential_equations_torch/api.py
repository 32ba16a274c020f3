"""``solve`` — the single AD-dispatching front end (SURVEY.md C11).

Port of ``universal_differential_equations_tpu/api.py``: one entry point that
takes a problem, a solver, tolerances, a ``saveat`` grid and a sensitivity
algorithm, and returns a ``Solution`` whose save-grid values are
differentiable according to the chosen adjoint.  States may be pytrees of
tensors; they are raveled to flat vectors internally and unraveled on output.

The default adjoint is ``InterpolatingAdjoint``, as in the JAX package.  A
``DAEProblem`` goes to the BDF solver (``solvers/bdf.py:daeint``); an
``SDEProblem`` raises a ``TypeError`` that names ``sdeint``, which takes the
Brownian noise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .adjoint.sensitivity import AbstractAdjoint, InterpolatingAdjoint
from .core.controller import PIController
from .core.problem import DAEProblem, ODEProblem, SDEProblem
from .core.solution import Solution
from .flatten_util import ravel_pytree
from .solvers.bdf import daeint
from .solvers.runge_kutta import Tsit5

__all__ = ["solve"]


def _check_saveat_in_tspan(ts, t0, t1):
    """Reject saveat values outside tspan up front.

    The dense-output fill clamps to the integrated interval, so an
    out-of-range save time would otherwise return the endpoint value
    silently.  Skipped when ``ts`` is wrapped by a ``torch.func`` transform
    (the counterpart of JAX skipping tracers).
    """
    try:
        ts_c = ts.detach().cpu().numpy()
        t0_c, t1_c = float(t0), float(t1)
    except RuntimeError:
        return
    lo, hi = min(t0_c, t1_c), max(t0_c, t1_c)
    slack = 1e-6 * max(1.0, hi - lo)  # f32 rounding of user-computed grids
    if ts_c.size and (np.min(ts_c) < lo - slack or np.max(ts_c) > hi + slack):
        raise ValueError(
            f"saveat times span [{np.min(ts_c)}, {np.max(ts_c)}] but tspan is "
            f"({t0_c}, {t1_c}): values outside tspan would be clamped to the "
            f"endpoint by dense output. Extend tspan or trim saveat.")


def solve(
    problem,
    solver=None,
    *,
    saveat=None,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    dt0: Optional[float] = None,
    max_steps: Optional[int] = None,
    adjoint: Optional[AbstractAdjoint] = None,
    dense: bool = False,
    controller: Optional[PIController] = None,
    step_to_saveat: bool = False,
):
    """Solve an initial value problem on the state's device.

    Args:
      problem: ``ODEProblem``, or ``DAEProblem``, which goes to ``daeint``
        with ``saveat``, ``rtol``, ``atol``, ``dt0``, ``max_steps`` (default
        4096) and ``dense``.
      solver: step method; defaults to ``Tsit5()``.
      saveat: 1-D tensor (or sequence) of output times within ``tspan``.
        ``None`` saves the two endpoints.  Values off the step grid are
        filled by the order-matched dense output.
      rtol / atol: PI-controller tolerances.
      dt0: initial step; ``None`` uses Hairer's automatic selection.
      max_steps: step-attempt budget.  Defaults to the adjoint's preference —
        4096 for the while-loop paths, 512 for the discrete adjoint.
      adjoint: sensitivity algorithm; defaults to ``InterpolatingAdjoint()``.
        Every adjoint works under ``torch.autograd``, ``torch.func.grad``,
        ``torch.func.vjp`` and ``torch.func.vmap`` (lanes may differ in
        ``u0``, ``args``, ``tspan`` and ``saveat``; each lane takes its solo
        solve's steps, and a finished lane waits for the others).  Under
        ``torch.func.jacfwd`` use ``ForwardSensitivity``: the continuous
        adjoints have no forward-mode rule.
      dense: attach continuous output so ``sol(t)`` / ``sol(t, nu=1)`` work.
      controller: step-size controller.
      step_to_saveat: force accepted steps to land exactly on the ``saveat``
        points, so saved values are step values with no interpolation.

    Returns:
      ``Solution`` with ``ts``/``ys`` on the save grid.
    """
    if isinstance(problem, SDEProblem):
        raise TypeError(
            "SDE problems need Brownian noise: use "
            "universal_differential_equations_torch.solvers.sde.sdeint(problem, generator=...)"
        )
    if isinstance(problem, DAEProblem):
        # unified front-end dispatch: DAEs go to the BDF solver
        return daeint(problem, saveat=saveat, rtol=rtol, atol=atol, dt0=dt0,
                      max_steps=max_steps or 4096, dense=dense)
    if not isinstance(problem, ODEProblem):
        raise TypeError(f"unsupported problem type {type(problem)}")

    solver = Tsit5() if solver is None else solver
    adjoint = InterpolatingAdjoint() if adjoint is None else adjoint
    controller = PIController() if controller is None else controller
    if max_steps is None:
        max_steps = adjoint.default_max_steps

    t0, t1 = problem.tspan
    y0_flat, unravel = ravel_pytree(problem.u0)
    dtype, device = y0_flat.dtype, y0_flat.device
    user_f = problem.f

    def f_flat(t, y, args):
        return ravel_pytree(user_f(t, unravel(y), args))[0]

    if saveat is None:
        # tensor ops, not float(): under vmap the span ends may be batched
        ts = torch.stack([torch.as_tensor(t, dtype=dtype, device=device) for t in (t0, t1)])
    else:
        ts = torch.as_tensor(saveat, dtype=dtype, device=device)
        if ts.ndim != 1:
            raise ValueError("saveat must be a 1-D array of times")
        _check_saveat_in_tspan(ts, t0, t1)

    # Evaluate the RHS once on the initial state so a u0/args/f mismatch
    # surfaces as a named error at the solve() boundary instead of a
    # broadcasting failure deep inside the stepper.
    try:
        du = f_flat(torch.as_tensor(t0, dtype=dtype, device=device), y0_flat,
                    problem.args)
    except Exception as e:
        raise TypeError(
            f"problem.f failed when evaluated on the initial state "
            f"(u0 ravels to shape {tuple(y0_flat.shape)}): {type(e).__name__}: {e}"
        ) from e
    if du.shape != y0_flat.shape:
        raise ValueError(
            f"problem.f returned a pytree that ravels to shape "
            f"{tuple(du.shape)}, but u0 ravels to {tuple(y0_flat.shape)} — du "
            f"must match the state (check remake(...) updates for shape drift)")

    tstops = ts if step_to_saveat else None
    ys_flat, res = adjoint.run(
        f_flat, y0_flat, t0, t1, problem.args, ts, solver, controller,
        rtol, atol, dt0, max_steps, tstops,
    )
    return Solution(
        ts=ts,
        ys=unravel(ys_flat),
        t_final=res.t_final,
        y_final=unravel(res.y_final),
        success=res.success,
        num_accepted=res.n_acc,
        num_rejected=res.n_rej,
        num_rhs_evals=res.nfe,
        dense=res.dense if dense else None,
        error_sum=res.err_sum,
        _unravel=unravel,
    )
