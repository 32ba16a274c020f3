"""LV scenario 3 on the port: a universal PDE with reaction recovery.

    python -m universal_differential_equations_torch.examples.lv_scenario_3 [--quick] --device cuda

The port of ``examples/lotka_volterra/scenario_3.py`` (``scenario_3.jl`` end
to end), stage by stage with the same constants: the Fisher-KPP truth on the
26-point periodic line (float32) → a universal PDE whose learnable model is a
per-point reaction MLP 1→5→5→5→1 plus a learnable 3-tap stencil (zero-sum
penalty) scaled by D0 (``scenario_3.jl:83-114``) → alternating rounds of
ADAM(0.01) and Levenberg-Marquardt through forward sensitivities → SINDy on
the flattened (state, learned reaction) pairs with ``monomial_basis(u, 10)``
plus a constant (``scenario_3.jl:189-204``).

The right-hand side is plain PyTorch with ``torch.roll``, as the JAX
script's own ``rhs`` is: it does not go through the fused RHS kernel, which
only ``models/fisher_kpp.make_model`` dispatches to.  Every stage runs on
``--device`` (default ``cuda``; it raises where there is no card —
``--device cpu`` must be asked for).  The initial weights come from
``torch.Generator(3)``, seeded as the JAX script's key; it draws other
numbers than ``jax.random``.  Left out: the plots.

The gates are the JAX script's, with and without ``--quick``: training loss
< 0.05, and the recovered reaction within 0.08 of u(1−u) on [0, 1].  The last
line of the output is a JSON object with the stage wall times and the gates.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch import sindy as sd
from universal_differential_equations_torch.examples.lv_scenario_1 import _card, stopwatch
from universal_differential_equations_torch.flatten_util import ravel_pytree
from universal_differential_equations_torch.models import fisher_kpp as fk
from universal_differential_equations_torch.nn import MLP

F32 = torch.float32
SEED = 3  # the JAX script's PRNGKey(3)
LAMS = tuple(10.0 ** e for e in np.arange(-4.0, 2.0, 0.05))


def make_model(generator, dtype=F32, device=None):
    """The reaction MLP 1→5→5→5→1, the stencil taps [1.1, −2.5, 1.0] and
    D0 = 6.5: ``(rhs, params0, rx)`` with ``params = {"rx", "w", "D0"}``."""
    rx = MLP([1, 5, 5, 5, 1], activation="tanh")
    params0 = {"rx": rx.init(generator, dtype, device),
               "w": torch.tensor([1.1, -2.5, 1.0], dtype=dtype, device=device),
               "D0": torch.tensor(6.5, dtype=dtype, device=device)}

    def rhs(t, u, p):
        w = p["w"]
        conv = w[0] * torch.roll(u, 1) + w[1] * u + w[2] * torch.roll(u, -1)
        return rx.apply(p["rx"], u[:, None])[:, 0] + p["D0"] * conv

    return rhs, params0, rx


def make_residuals(rhs, ts, data):
    """The residuals: the trajectory misfit through forward sensitivities
    (≤ 192 steps), √ of the zero-sum penalty, and the 3e-3 weight decay on
    the reaction net (the traveling wave samples the plateaus densely, so
    the mid-front reaction is only weakly constrained)."""

    def residuals(p):
        sol = ude.solve(ude.ODEProblem(rhs, data[0], (0.0, fk.T_END), p), ude.Tsit5(),
                        saveat=ts, rtol=1e-4, atol=1e-6, adjoint=ude.ForwardSensitivity(),
                        max_steps=192)
        pen = torch.sqrt(fk.zero_sum_penalty(p) + 1e-30)
        flat_rx = ravel_pytree(p["rx"])[0]
        rr = (3e-3 / flat_rx.numel()) ** 0.5 * flat_rx
        return torch.cat([(sol.ys - data).reshape(-1), pen[None], rr])

    return residuals


def train(residuals, params0, quick, rounds=None, adam_steps=None, lm_iters=None):
    """Alternating ADAM(0.01) basin hops (early stop at loss 0.005) and LM
    (``loss_tol`` 0.005) until a round ends below 0.005.  The budgets default
    to the JAX script's (``quick``: 2 rounds of 150 steps and ≤ 30 LM
    iterations; else 4 rounds of 500 and ≤ 100).  Returns ``(params, loss,
    rounds)``, ``rounds`` a list of (ADAM loss, LM loss) pairs."""
    rounds = (2 if quick else 4) if rounds is None else rounds
    adam_steps = (150 if quick else 500) if adam_steps is None else adam_steps
    lm_iters = (30 if quick else 100) if lm_iters is None else lm_iters

    def loss(p):
        r = residuals(p)
        return torch.sum(r * r)

    params, best, log = params0, float("inf"), []
    for k in range(rounds):
        warm = ude.fit(loss, params, lambda ps: torch.optim.Adam(ps, lr=0.01), adam_steps,
                       callback_every=150, early_stop_loss=0.005)
        res = ude.levenberg_marquardt(residuals, warm.params, maxiters=lm_iters, loss_tol=0.005)
        params, best = res.params, float(res.loss)
        log.append((warm.final_loss, best))
        print(f"  round {k}: adam {warm.final_loss:.4f} -> LM {best:.5f}", flush=True)
        if best < 0.005:
            break
    return params, best, log


def reaction_pairs(rhs, rx, params, ts, data):
    """The flattened (state, learned reaction) pairs along the trained
    solution (``scenario_3.jl:189-192``): ``(u, r)``, both (11·26, 1)."""
    sol = ude.solve(ude.ODEProblem(rhs, data[0], (0.0, fk.T_END), params), ude.Tsit5(),
                    saveat=ts, rtol=1e-6, atol=1e-8, adjoint=ude.NoAdjoint(), max_steps=512)
    u = sol.ys.reshape(-1, 1)
    return u, rx.apply(params["rx"], u)


def scenario_basis():
    """Powers u¹…u¹⁰ plus a constant."""
    return sd.monomial_basis(1, 10) + sd.Basis((sd.Term("poly", exponents=(0,)),), 1)


def recover(u, r):
    """SINDy on the pairs; the trained reaction carries smooth wiggles the
    dense polynomials can chase, so a generous parsimony factor (100) keeps
    the physical 2-term model."""
    return sd.sindy(sd.DirectDataDrivenProblem(u, r), scenario_basis(), sd.STLSQ(LAMS),
                    normalize=True, sampler=sd.DataSampler(4), exhaustive_k=2,
                    cv_tolerance=100.0)


def functional_error(rec, dtype=F32, device=None):
    """max |recovered − u(1−u)| on 101 points of [0, 1]: the traveling wave
    samples only the plateaus densely, so u², u³ alias on the data and the
    claim is functional."""
    ug = torch.linspace(0.0, 1.0, 101, dtype=dtype, device=device)[:, None]
    return float((rec(ug)[:, 0] - ug[:, 0] * (1 - ug[:, 0])).abs().max())


def main(quick=False, device="cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    walls, lap = stopwatch(device)
    ts, data = fk.generate_data(dtype=F32, device=device)
    print(f"universal-PDE data: {tuple(data.shape)} (Nx={fk.NX}, float32)")
    lap("data")
    rhs, params0, rx = make_model(torch.Generator().manual_seed(SEED), device=device)
    p_tr, loss, rounds = train(make_residuals(rhs, ts, data), params0, quick)
    print(f"training done: loss {loss:.5f}")
    lap("train")
    rec = recover(*reaction_pairs(rhs, rx, p_tr, ts, data))
    ferr = functional_error(rec, device=device)
    print("recovered reaction:", rec.equations("dr")[0])
    print(f"sparsity {int(rec.sparsity[0])}, max |recovered - u(1-u)| on [0,1] = {ferr:.4f} "
          "(true reaction peak 0.25)")
    lap("sindy")
    gates = dict(loss=loss < 0.05, reaction=ferr < 0.08)
    out = dict(device=_card(device), quick=quick, walls=walls, total_s=sum(walls.values()),
               rounds=rounds, loss=loss, equations=rec.equations("dr"), func_err=ferr,
               gates=gates)
    if not all(gates.values()):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"scenario 3 gate failed: {gates}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="2 rounds of 150 ADAM steps and ≤ 30 LM iterations (4 of 500 and "
                         "≤ 100 without)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device)), flush=True)
