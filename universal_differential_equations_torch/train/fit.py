"""Training loops: the ``Optimization.solve`` / ``Flux.train!`` equivalent.

Port of ``universal_differential_equations_tpu/train/fit.py``: a ``fit`` loop
with host-side callbacks every ``callback_every`` steps for loss logging,
early stop and checkpoint hooks (``scenario_1.jl:99-118``), early exit on a
loss threshold (``Fisher-KPP-CNN-Fourier.jl:225``), optimizer-state
continuation across calls, and LR decay on plateau
(``neural_pde_rayleigh_taylor_instability.jl:175-181``).

The optimizer is a PyTorch optimizer factory over the parameter leaves, for
example ``lambda ps: torch.optim.Adam(ps, lr=0.1)``; ``torch.optim.Adam``'s
arithmetic is ``optax.adam``'s (bias-corrected moments, ``eps`` outside the
square root) to rounding.  Where JAX runs each chunk of steps as one
compiled ``lax.scan``, the port steps eagerly and calls back on the same
chunk boundaries.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..flatten_util import tree_flatten
from .bfgs import BFGSResult, bfgs_minimize

__all__ = ["fit", "fit_bfgs", "FitResult", "reduce_on_plateau"]


@dataclasses.dataclass
class FitResult:
    params: Any
    losses: torch.Tensor  # (num_steps,)
    num_steps: int
    stopped_early: bool = False
    opt_state: Any = None  # the optimizer's state_dict (resume / cross-stage LR)

    @property
    def final_loss(self):
        return float(self.losses[self.num_steps - 1]) if self.num_steps else float("inf")

    # reference naming: res.minimizer / res.u (Optimization.jl)
    @property
    def minimizer(self):
        return self.params


def fit(
    loss_fn: Callable,
    params,
    optimizer: Callable,
    maxiters: int,
    *,
    callback: Optional[Callable] = None,
    callback_every: int = 50,
    early_stop_loss: Optional[float] = None,
    opt_state=None,
) -> FitResult:
    """Minimize ``loss_fn(params)`` with a PyTorch optimizer.

    ``optimizer(leaves)`` builds the optimizer over the parameter tensors.
    ``callback(step, loss, params) -> bool`` is invoked every
    ``callback_every`` steps (and after a shorter last chunk); returning True
    stops training (the reference's callback protocol,
    ``scenario_1.jl:97-105``).  ``opt_state``: a previous
    ``FitResult.opt_state`` continues that optimizer (ADAM moments and step
    count) instead of starting a fresh one.
    """
    leaves, build = tree_flatten(params)
    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in leaves]
    opt = optimizer(leaves)
    if opt_state is not None:
        # loading shares the state tensors, which the steps update in place
        opt.load_state_dict(copy.deepcopy(opt_state))

    def current():
        return build([leaf.detach() for leaf in leaves])

    losses = []
    steps_done = 0
    stopped = False
    while steps_done < maxiters:
        chunk = min(callback_every, maxiters - steps_done)
        for _ in range(chunk):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(build(leaves))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        steps_done += chunk
        last = float(losses[-1])
        if callback is not None and callback(steps_done, last, current()):
            stopped = True
            break
        if early_stop_loss is not None and last < early_stop_loss:
            stopped = True
            break
    return FitResult(
        params=current(),
        losses=torch.stack(losses) if losses else torch.zeros((0,)),
        num_steps=steps_done,
        stopped_early=stopped,
        opt_state=opt.state_dict(),
    )


def fit_bfgs(loss_fn, params, maxiters=1000, **kw) -> BFGSResult:
    """BFGS refinement stage (reference ADAM→BFGS chaining,
    ``scenario_1.jl:114-118``)."""
    return bfgs_minimize(loss_fn, params, maxiters=maxiters, **kw)


def reduce_on_plateau(lr0: float, *, factor: float = 0.1, patience: int = 2,
                      min_lr: float = 1e-8):
    """Stateful host-side LR schedule: multiply by ``factor`` after
    ``patience`` non-improving callback windows (the climate training loop's
    schedule, ``neural_pde_rayleigh_taylor_instability.jl:175-181``).

    Returns a single ``update(loss) -> lr`` callable: feed it the loss from
    the fit callback and write the returned rate into the optimizer's
    ``param_groups``.
    """
    state = {"best": float("inf"), "stale": 0, "lr": lr0}

    def update(loss):
        if loss < state["best"] - 1e-12:
            state["best"] = loss
            state["stale"] = 0
        else:
            state["stale"] += 1
            if state["stale"] > patience:
                state["lr"] = max(state["lr"] * factor, min_lr)
                state["stale"] = 0
        return state["lr"]

    return update
