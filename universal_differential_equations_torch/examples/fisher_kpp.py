"""Fisher-KPP universal PDE on the port: a learnable reaction plus a diffusion stencil.

    python -m universal_differential_equations_torch.examples.fisher_kpp
        [--variant mlp|small|small7|small4|fourier|fourier5|fourier7]
        [--runs N] [--quick] [--device cuda]

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
``jax.random``.  Left out: the plots and the live dashboard.

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

import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch.models import fisher_kpp as fk
from universal_differential_equations_torch.utils import card_name

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


def train(variant, params0, residuals, *, adam_steps, lm_iters, refine_steps, on_stage=None):
    """One training attempt: ADAM(0.01) warmup (MLP reactions, which are
    nonlinear in their parameters) → LM to loss < 0.01, and where that is
    missed one ADAM(0.001) + LM refine pass (none with ``refine_steps=0``).
    ``on_stage(name, loss)`` runs after each stage.  Returns ``(params,
    final_loss)``."""
    loss = make_loss(residuals)
    stage = on_stage or (lambda name, value: None)
    params = params0
    if not variant.startswith("fourier"):
        warm = ude.fit(loss, params, _adam(0.01), adam_steps, callback_every=100,
                       early_stop_loss=0.01)
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


def _train_attempt(seed, variant, ts, data, quick=False, on_stage=None):
    rhs, params0 = fk.make_model(torch.Generator().manual_seed(seed), variant,
                                 device=data.device)
    return train(variant, params0, fk.make_residuals(rhs, ts, data),
                 adam_steps=150 if quick else 500, lm_iters=30 if quick else 100,
                 refine_steps=200 if quick else 1000, on_stage=on_stage)


def train_once(seed, variant, ts, data, quick=False, on_stage=None):
    """Train to the reference's exit criterion under the restart ladder:
    attempts run in the fixed order seed, seed+1000, …, stopping at the first
    that passes :func:`_run_gate`.  Returns ``(params, final, wall,
    attempt_losses)`` for the best attempt; the wall covers every attempt."""
    t0 = time.perf_counter()
    best_params, best_final = None, float("inf")
    attempt_losses = []
    for k in range(8 if variant == "small4" else 3):
        params, final = _train_attempt(seed + 1000 * k, variant, ts, data, quick, on_stage)
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


def main(variant="fourier", runs=1, quick=False, device="cuda"):
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

    walls, losses, ladders, gates = [], [], [], []
    for run in range(runs):
        clock[0] = time.perf_counter()
        params, final, wall, ladder = train_once(run, variant, ts, data, quick, on_stage)
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
    args = ap.parse_args()
    print(json.dumps(main(args.variant, args.runs, args.quick, args.device)), flush=True)
