"""Fisher-KPP universal PDE on the port: a learnable reaction plus a diffusion stencil.

    python -m universal_differential_equations_torch.examples.fisher_kpp
        [--variant mlp|small|small7|small4|fourier|fourier5|fourier7]
        [--runs N] [--quick] [--device cuda] [--plot]

The port of ``examples/fisher_kpp/fisher_kpp.py`` (``FisherKPP/Fisher-KPP-
CNN{,-Small,-Fourier}.jl``) with the same constants: the truth on the
periodic 26-point line (float32), a learned pointwise reaction (an MLP or a
Fourier basis) plus a learnable 3-tap stencil scaled by D0 with a zero-sum
penalty (``models/fisher_kpp.py``), trained to the reference's exit criterion
(loss < 0.01) by ADAM(0.01) warmup (MLP reactions only) and then
Levenberg-Marquardt through forward sensitivities, with one ADAM(0.001)+LM
refine pass where the criterion is missed.  Attempts run in a fixed restart
ladder (seed, seed+1000, …; 3 attempts, 8 for ``small4``) until one passes
:func:`_run_gate`; a run's wall covers every attempt.

On a CUDA float32 state the MLP variants' right-hand side is the fused
reaction+stencil kernel (``ops/stencil.py``): ADAM's gradients go through its
reverse rule (``FusedUpdetRHS.backward``), LM's Jacobians through its tangent
kernel.  Every stage runs on ``--device`` (default ``cuda``; it raises where
there is no card — ``--device cpu`` must be asked for).  Initial weights come
from ``torch.Generator(seed)``, which draws other numbers than
``jax.random``.

``--plot`` writes the JAX script's figures to ``build/plots/fisher_kpp/``:
``{variant}_truth.pdf``, ``_learned.pdf``, ``_error.pdf`` and
``_reaction.pdf`` (:func:`write_plots`), and for the MLP variants the live
training dashboard ``dashboard.png``, rewritten every 100 steps of the ADAM
warmup (:func:`make_dashboard`).  It needs matplotlib, imported before the
data is made.

Gates, per run, as in the JAX script: loss < 0.01, |Σw| < 1e-2 and
D0·(w₀+w₂)/2·dx² within 35 % of D; for ``small4`` (which the reference never
converges) a final loss below 1.05 × the reference's worst run, 0.437.  The
last line of the output is a JSON object with the walls, losses, ladders and
gates.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch.models import fisher_kpp as fk
from universal_differential_equations_torch.utils import card_name, require_viz

VARIANTS = ("mlp", "small", "small7", "small4", "fourier", "fourier5", "fourier7")
# The reference's CPU wall-clock means (5 runs each, BASELINE.md): "small" is
# the study's 15-parameter row; small7 and small4 are counted by their
# reaction nets; small4 has no baseline: the reference never converges there.
BASELINES = {"fourier": 236.8, "fourier5": 248.2, "fourier7": 250.6,
             "small": 1963.4, "small7": 2508.0, "small4": None, "mlp": None}
# the reference's final-loss band where small4 failed to converge
# (Fisher-KPP-CNN-Small.jl:370-390: 0.2225-0.4370 after 2211-5764 s)
SMALL4_REFERENCE_FLOOR = 0.2225  # their best run
SMALL4_REFERENCE_WORST = 0.4370  # their worst run
PLOTS = Path(__file__).resolve().parents[2] / "build" / "plots" / "fisher_kpp"


def make_loss(residuals):
    return lambda p: torch.sum(residuals(p) ** 2)


def effective_diffusion(params):
    """D0·(w₀+w₂)/2·dx²: the diffusion constant the learned stencil carries."""
    w = params["w"].detach().cpu()
    return float(params["D0"]) * float(w[0] + w[2]) / 2 * fk.DX**2


def _run_gate(variant, params, final):
    """Per-run claim: the reference's exit criterion plus stencil
    localization; for the architecturally capped small4, a loss below the
    reference's best run (0.2225), its good loss shelf."""
    if variant == "small4":
        return final < SMALL4_REFERENCE_FLOOR
    wsum = float(params["w"].sum())
    return (final < 0.01 and abs(wsum) < 1e-2
            and abs(effective_diffusion(params) - fk.D_TRUE) < 0.35 * fk.D_TRUE)


def _adam(lr):
    return lambda leaves: torch.optim.Adam(leaves, lr=lr)


def train(variant, params0, residuals, *, adam_steps, lm_iters, refine_steps, on_stage=None,
          dashboard=None):
    """One training attempt: ADAM(0.01) warmup (MLP reactions, which are
    nonlinear in their parameters) → LM to loss < 0.01, and where that is
    missed one ADAM(0.001) + LM refine pass (none with ``refine_steps=0``).
    ``on_stage(name, loss)`` runs after each stage; ``dashboard`` is the
    warmup's ``fit`` callback, every 100 steps.  Returns ``(params,
    final_loss)``."""
    loss = make_loss(residuals)
    stage = on_stage or (lambda name, value: None)
    params = params0
    if not variant.startswith("fourier"):
        warm = ude.fit(loss, params, _adam(0.01), adam_steps, callback=dashboard,
                       callback_every=100, early_stop_loss=0.01)
        params = warm.params
        stage("adam", warm.final_loss)
    res = ude.levenberg_marquardt(residuals, params, maxiters=lm_iters, loss_tol=0.01)
    params, final = res.params, float(res.loss)
    stage("lm", final)
    if final >= 0.01 and refine_steps:
        res2 = ude.fit(loss, params, _adam(0.001), refine_steps, callback_every=100,
                       early_stop_loss=0.01)
        stage("refine_adam", res2.final_loss)
        res = ude.levenberg_marquardt(residuals, res2.params, maxiters=lm_iters, loss_tol=0.01)
        params, final = res.params, float(res.loss)
        stage("refine_lm", final)
    return params, final


def _train_attempt(seed, variant, ts, data, quick=False, on_stage=None, dashboard=None):
    rhs, params0 = fk.make_model(torch.Generator().manual_seed(seed), variant,
                                 device=data.device)
    return train(variant, params0, fk.make_residuals(rhs, ts, data),
                 adam_steps=150 if quick else 500, lm_iters=30 if quick else 100,
                 refine_steps=200 if quick else 1000, on_stage=on_stage, dashboard=dashboard)


def train_once(seed, variant, ts, data, quick=False, on_stage=None, dashboard=None):
    """Train to the reference's exit criterion under the restart ladder:
    attempts run in the fixed order seed, seed+1000, …, stopping at the first
    that passes :func:`_run_gate`.  Returns ``(params, final, wall,
    attempt_losses)`` for the best attempt; the wall covers every attempt."""
    t0 = time.perf_counter()
    best_params, best_final = None, float("inf")
    attempt_losses = []
    for k in range(8 if variant == "small4" else 3):
        params, final = _train_attempt(seed + 1000 * k, variant, ts, data, quick, on_stage,
                                       dashboard)
        attempt_losses.append(final)
        if final < best_final:
            best_params, best_final = params, final
        if _run_gate(variant, params, final):
            break
    return best_params, best_final, time.perf_counter() - t0, attempt_losses


def run_passes(variant, params, final):
    """The script's per-run gate: small4 inside the reference's
    non-convergent band, every other variant :func:`_run_gate`."""
    if variant == "small4":
        return final < SMALL4_REFERENCE_WORST * 1.05
    return _run_gate(variant, params, final)


def learned_figures(variant, ts, data, params):
    """The figures' work on ``params``' device: the learned field, a Tsit5
    solve from ``data[0]`` (rtol 1e-6, atol 1e-8, ≤ 512 steps), and the learned
    reaction on 101 constant fields, where ``rhs(c·1) = r(c) + D0·Σw·c``
    exactly.  Returns numpy ``(pred (T, NX), u_grid (101,), learned_r
    (101,))``."""
    rhs, _ = fk.make_model(torch.Generator().manual_seed(0), variant, dtype=data.dtype,
                           device=data.device)
    sol = ude.solve(ude.ODEProblem(rhs, data[0], (0.0, fk.T_END), params), ude.Tsit5(),
                    saveat=ts, rtol=1e-6, atol=1e-8, adjoint=ude.NoAdjoint(), max_steps=512)
    u_grid = np.linspace(0.0, 1.0, 101)
    with torch.no_grad():
        rhs_c = torch.stack([rhs(0.0, torch.full((fk.NX,), float(u), dtype=data.dtype,
                                                 device=data.device), params)[0]
                             for u in u_grid])
    wsum = float(params["w"].detach().cpu().numpy().sum())
    d0 = float(params["D0"])
    learned_r = rhs_c.cpu().numpy().astype(float) - d0 * wsum * u_grid
    return sol.ys.cpu().numpy(), u_grid, learned_r


def write_plots(variant, ts, data, params, outdir=None):
    """The JAX script's figures (``Fisher-KPP-CNN.jl:163-233`` analogues):
    truth and learned space-time fields, their difference, and the learned
    reaction against the logistic truth, into ``outdir`` (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    pred, u_grid, learned_r = learned_figures(variant, ts, data, params)
    data = data.cpu().numpy()
    extent = (0.0, fk.T_END, 0.0, fk.NX * fk.DX)
    viz.save(viz.plot_field(data.T, extent, title="ρ(x, t) truth", cbar_label="ρ"),
             outdir / f"{variant}_truth.pdf")
    viz.save(viz.plot_field(pred.T, extent, title="ρ(x, t) learned UPDE", cbar_label="ρ"),
             outdir / f"{variant}_learned.pdf")
    viz.save(viz.plot_field(pred.T - data.T, extent, title="learned − truth",
                            cbar_label="Δρ", diverging=True), outdir / f"{variant}_error.pdf")
    viz.save(viz.plot_function_comparison(
        u_grid, learned_r, fk.R_TRUE * u_grid * (1.0 - u_grid),
        labels=("learned reaction", "r·u(1−u)"), xlabel="ρ",
        title=f"reaction term ({variant})"), outdir / f"{variant}_reaction.pdf")
    print(f"plots written to {outdir}")


def make_dashboard(variant, outdir=None):
    """The live training dashboard (``Fisher-KPP-CNN.jl:163-233``), a ``fit``
    callback that rewrites ``dashboard.png`` in ``outdir`` (``PLOTS``): the
    loss beside the stencil ``w`` and ``D0``, copied from the card."""
    from universal_differential_equations_torch import viz

    def panel(ax, step, params):
        w = params["w"].detach().cpu().numpy()
        ax.bar([0, 1, 2], w, color=viz.SERIES[0])
        ax.set_xticks([0, 1, 2])
        ax.set_xticklabels(["w₋₁", "w₀", "w₊₁"])
        ax.set_title(f"stencil (Σw = {w.sum():+.1e}), D0 = {float(params['D0']):.2f}",
                     fontsize=8)

    return viz.TrainingDashboard(Path(PLOTS if outdir is None else outdir) / "dashboard.png",
                                 panel=panel, title=f"fisher-kpp {variant}")


def main(variant="fourier", runs=1, quick=False, device="cuda", plot=False):
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    ts, data = fk.generate_data(device=device)
    print(f"data: {tuple(data.shape)} snapshots (Nx={fk.NX}) on {card_name(device)}", flush=True)
    clock = [time.perf_counter()]

    def on_stage(name, loss):
        now = time.perf_counter()
        print(f"[{name}] loss {loss:.6g} after {now - clock[0]:.2f} s", flush=True)
        clock[0] = now

    # the reference's live dashboard, rewritten during the ADAM warmup
    dashboard = make_dashboard(variant) if plot and variant != "fourier" else None
    walls, losses, ladders, gates = [], [], [], []
    for run in range(runs):
        clock[0] = time.perf_counter()
        params, final, wall, ladder = train_once(run, variant, ts, data, quick, on_stage,
                                                 dashboard)
        w = params["w"].detach().cpu()
        walls.append(wall)
        losses.append(final)
        ladders.append(ladder)
        gates.append(run_passes(variant, params, final))
        print(f"run {run}: loss {final:.4f} in {wall:.1f} s, attempts {ladder} | stencil "
              f"{w.tolist()} (sum {float(w.sum()):+.2e}), D0·w·dx² "
              f"{effective_diffusion(params):.4f} vs {fk.D_TRUE}", flush=True)
    mean = sum(walls) / len(walls)
    baseline = BASELINES[variant]
    print(f"variant={variant}: mean wall {mean:.1f} s over {runs} runs; reference CPU "
          f"baseline: {baseline} s")
    if baseline:
        print(f"speedup vs reference: {baseline / mean:.1f}x")
    out = dict(device=card_name(device), variant=variant, quick=quick, walls=walls,
               losses=losses, ladders=ladders, gates=gates,
               speedup=baseline / mean if baseline else None)
    if not all(gates):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"fisher_kpp {variant}: a run failed its gate: {gates}")
    if plot:
        write_plots(variant, ts, data, params)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="fourier", choices=VARIANTS)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--quick", action="store_true",
                    help="150 ADAM warmup steps and ≤ 30 LM iterations per pass (500 and "
                         "≤ 100 without)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    ap.add_argument("--plot", action="store_true",
                    help="write the figures and the training dashboard to "
                         "build/plots/fisher_kpp/")
    args = ap.parse_args()
    print(json.dumps(main(args.variant, args.runs, args.quick, args.device, args.plot)),
          flush=True)
