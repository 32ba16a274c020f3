"""FENE-P rheology UDE on the port: learning a closure against a stiff DAE truth.

    python -m universal_differential_equations_torch.examples.fenep
        [--quick] [--device cuda] [--init jax|torch]

The port of ``examples/non_newtonian/fenep.py`` (``NonNewtonianFluids/FENEP.jl``):
the exact shear stress from the BDF DAE solver (the reference's Sundials
IDA) for strain rates γ̇ = 12·cos(ωt), ω ∈ 1.0:0.2:2.0 over (0, 6.2831), and
the held-out γ̇ = 12·cos(1.5t) over (0, 10), 100 save points each (7 truth
solves, float64 on the device: ``x64_host``); the index-1 reduction solved by
Kvaerno3, SDIRK4, SDIRK3 and Rosenbrock23 must reproduce the held-out truth
within 1e-3 relative; then a 1-state UDE with two 2→4→1 tanh nets (``f1`` the
latent dynamics, ``f0`` the stress readout) and the linear baseline are each
trained by ADAM(0.015), 2000 steps (300 with ``--quick``), on the six modes
at once: one ``torch.func.vmap`` of Tsit5 solves (rtol 1e-5, atol 1e-7,
``DiscreteAdjoint``, 256 attempts) in float32.

The gate, as in the JAX script: the neural surrogate's held-out error is
below the linear model's.  Every stage runs on ``--device`` (default
``cuda``).  ``--init jax`` (the default) starts both arms from the JAX
script's own initial weights, ``make_surrogate(jax.random.PRNGKey(3))``,
committed as ``examples/data/fenep_init.npz`` (written by
``tools/fenep_init.py``); ``--init torch`` draws them from
``torch.Generator(3)``.  The held-out responses are saved to
``build/fenep/fenep_test_response.npz``; ``--plot`` is not ported yet (slice
H).  The last line of the output is a JSON object with the walls, the
cross-checks, each arm's losses and the gate.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch.examples.lv_scenario_1 import stopwatch
from universal_differential_equations_torch.models import fenep
from universal_differential_equations_torch.utils import card_name

F32 = torch.float32
ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "fenep"
INIT = Path(__file__).resolve().parent / "data" / "fenep_init.npz"

TSPAN = (0.0, 6.2831)
OMEGAS = np.arange(1.0, 2.01, 0.2)
OMEGA_TEST = 1.5
CROSSCHECK = ("Kvaerno3", "SDIRK4", "SDIRK3", "Rosenbrock23")


def strain_rate(omega):
    """γ̇(t) = 12·cos(ωt)."""
    return lambda t: 12.0 * torch.cos(omega * t)


def build_data(device="cuda", dtype=F32):
    """``(ts, sigmas, ts10, sigma_test)``: the six training modes' exact τ12
    on 100 points of ``TSPAN`` and the held-out mode's on 100 points of
    (0, 10), each truth solve asserting its success."""
    ts = torch.linspace(TSPAN[0], TSPAN[1], 100, dtype=dtype, device=device)
    sig = []
    for w in OMEGAS:
        s, ok = fenep.find_sigma_exact(ts, strain_rate(float(w)))
        if not bool(ok):
            raise AssertionError(f"DAE solve failed for omega={w}")
        sig.append(s)
    ts10 = torch.linspace(0.0, 10.0, 100, dtype=dtype, device=device)
    s_test, ok = fenep.find_sigma_exact(ts10, strain_rate(OMEGA_TEST))
    if not bool(ok):
        raise AssertionError(f"DAE solve failed for omega={OMEGA_TEST}")
    return ts, torch.stack(sig), ts10, s_test


def make_loss(f1, f0, ts, sigmas):
    """``(loss, predict_sigma)``: the summed squared stress error over the
    modes ``OMEGAS`` (one vmapped solve), and one mode's predicted τ12."""
    dtype, device = ts.dtype, ts.device

    def predict_sigma(params, omega, tgrid, t_end):
        def rhs(t, u, p):
            gd = 12.0 * torch.cos(omega * t)
            return f1.apply(p["f1"], torch.cat([u, gd[None]]))

        prob = ude.ODEProblem(rhs, torch.zeros(1, dtype=dtype, device=device), (0.0, t_end),
                              params)
        sol = ude.solve(prob, ude.Tsit5(), saveat=tgrid, rtol=1e-5, atol=1e-7,
                        adjoint=ude.DiscreteAdjoint(), max_steps=256)
        gd = 12.0 * torch.cos(omega * tgrid)
        inp = torch.stack([sol.ys[:, 0], gd], dim=1)
        return f0.apply(params["f0"], inp)[:, 0]

    t_end = float(ts[-1])
    omegas = torch.as_tensor(OMEGAS, dtype=dtype, device=device)

    def loss(params):
        per_mode = torch.func.vmap(
            lambda w, s: torch.sum((predict_sigma(params, w, ts, t_end) - s) ** 2)
        )(omegas, sigmas)
        return torch.sum(per_mode)

    return loss, predict_sigma


def crosscheck_implicit_solvers(ts10, sigma_test):
    """The index-1 reduction of FENE-P (``models.fenep.fenep_stiff_rhs``),
    solved by each solver of ``CROSSCHECK`` (Kvaerno3, SDIRK4, SDIRK3,
    Rosenbrock23), must reproduce the BDF truth of the held-out mode within
    1e-3 relative: ``{name: rel}``."""
    scale = float(torch.max(torch.abs(sigma_test)))
    out = {}
    for solver in (getattr(ude, name)() for name in CROSSCHECK):
        s_ode, ok = fenep.find_sigma_exact_ode(ts10, strain_rate(OMEGA_TEST), solver)
        if not bool(ok):
            raise AssertionError(f"{solver.name} stiff-ODE solve failed")
        rel = float(torch.max(torch.abs(s_ode - sigma_test))) / scale
        print(f"  {solver.name} stiff-ODE vs BDF DAE: max rel dev {rel:.2e}", flush=True)
        if not rel < 1e-3:
            raise AssertionError(f"{solver.name} disagrees with the DAE truth: {rel:.2e}")
        out[solver.name] = rel
    return out


def initial_surrogate(linear, init="jax", device="cuda", dtype=F32):
    """``make_surrogate``'s nets with the JAX script's initial weights
    (``init="jax"``, from ``fenep_init.npz``) or ``torch.Generator(3)``'s."""
    f1, f0, params = fenep.make_surrogate(torch.Generator().manual_seed(3), linear=linear,
                                          dtype=dtype, device=device)
    if init == "jax":
        arm = "linear" if linear else "neural"
        with np.load(INIT) as z:
            tree = {net: [{leaf: z[f"{arm}.{net}.{i}.{leaf}"] for leaf in layer}
                          for i, layer in enumerate(params[net])] for net in params}
        params = ude.params_from_jax(tree, device=device, dtype=dtype)
    elif init != "torch":
        raise ValueError(f"init must be 'jax' or 'torch', got {init!r}")
    return f1, f0, params


def main(quick=False, plot=False, device="cuda", init="jax", steps=None):
    """The case study; ``steps`` overrides the ADAM budget per arm (2000, 300
    with ``quick``).  Raises ``RuntimeError`` after printing the result where
    the gate fails."""
    if plot:
        raise NotImplementedError("--plot waits for the port of viz.py (slice H)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    steps = (300 if quick else 2000) if steps is None else steps
    walls, lap = stopwatch(device)
    ts, sigmas, ts10, sigma_test = build_data(device)
    print(f"DAE data generation: {len(OMEGAS)} train modes + 1 test on {card_name(device)}")
    lap("truth")
    crosscheck = crosscheck_implicit_solvers(ts10, sigma_test)
    lap("crosscheck")

    results, preds = {}, {}
    for tag, linear in (("neural", False), ("linear", True)):
        f1, f0, params0 = initial_surrogate(linear, init, device)
        loss, predict_sigma = make_loss(f1, f0, ts, sigmas)
        res = ude.fit(loss, params0, lambda ps: torch.optim.Adam(ps, lr=0.015), steps,
                      callback_every=500)
        with torch.no_grad():
            test_pred = predict_sigma(res.params, OMEGA_TEST, ts10, float(ts10[-1]))
        test_err = float(torch.sum((test_pred - sigma_test) ** 2))
        lap(f"train_{tag}")
        print(f"{tag}: train loss {res.final_loss:.2f}, test err {test_err:.2f}, "
              f"{walls[f'train_{tag}'] / steps:.4f} s per ADAM step", flush=True)
        results[tag] = dict(train_loss=res.final_loss, test_err=test_err,
                            s_per_step=walls[f"train_{tag}"] / steps)
        preds[tag] = test_pred.cpu().numpy()

    gate = results["neural"]["test_err"] < results["linear"]["test_err"]
    print(f"NN beats linear baseline by "
          f"{results['linear']['test_err'] / results['neural']['test_err']:.1f}x")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(OUT_DIR / "fenep_test_response.npz", t=ts10.cpu().numpy(),
             exact=sigma_test.cpu().numpy(), neural=preds["neural"], linear=preds["linear"])
    out = dict(device=card_name(device), quick=quick, init=init, steps=steps,
               crosscheck=crosscheck, walls=walls, total_s=sum(walls.values()),
               gates=dict(neural_beats_linear=gate), **results)
    if device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if not gate:
        print(json.dumps(out), flush=True)
        raise RuntimeError("the NN surrogate must beat the linear baseline (FENEP.jl comparison)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="300 ADAM steps per arm (2000 without)")
    ap.add_argument("--plot", action="store_true", help="not ported yet (slice H)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    ap.add_argument("--init", default="jax", choices=("jax", "torch"),
                    help="initial weights: the JAX script's (default) or torch.Generator(3)'s")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, plot=args.plot, device=args.device,
                          init=args.init)), flush=True)
