"""Climate 1-D neural PDE on the port, trained on Rayleigh-Taylor averages.

    python -m universal_differential_equations_torch.examples.climate_neural_pde_data
        [--quick] [--reference-bar] [--data auto|generated|reference] [--plot] [--device cuda]

The port of ``examples/climate/neural_pde_data.py`` (``Climate/NeuralPDE/
npde_data.jl``) in its generated-data mode, float32: the committed b̄(z, t)
horizontal averages of the RT run (41 × 64,
``examples/climate/data/rt_horizontal_averages.npz``) coarse-grained to a
32-level column (``--quick`` generates a 16×2×16 run to t = 1 and trains at
16 levels), the ghost-node D1/D2 operators (``npde_data.jl:17-39``), a flux
net of five 30→30 tanh layers (4,650 parameters) inside
``du/dt = D1·Φ(u) + D2·u`` (``npde_data.jl:62-74``), trained by ADAM(0.01)
for 300 steps (30 with ``--quick``) through Tsit5 and the interpolating
adjoint, keeping the best parameters seen at the 30-step callbacks.  The
trained flux is rolled out with ROCK4 at rtol 1e-3 and cross-checked by an
RKC2 rollout.

``--reference-bar`` runs only the reproduced reference protocol
(:func:`reference_protocol_bar`): 20 ADAM(0.01) steps through ROCK4's
interpolating adjoint at rtol 1e-5, and writes its rollout rel-L2 to
``build/climate/npde_ref_protocol.json``.  ``--data reference`` (the
reference's own Oceananigans JLD2 file) raises: that file is not in the
repository.

Gates, as in the JAX script: the RKC2 rollout within 5 % of ROCK4's; outside
``--quick``, the best loss < 0.2 × the initial one and the ROCK4 rollout's
rel-L2 against the data < 0.6.  Every stage runs on ``--device`` (default
``cuda``); the initial weights come from ``torch.Generator(0)``, which draws
other numbers than ``jax.random``.  ``--plot`` writes the JAX script's two
figures (data and ROCK4 rollout as z-t fields) to ``build/plots/climate/``
(:func:`write_plots`); it needs matplotlib, imported before the data.
The last line of the output is a JSON object with the walls, losses and
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
from universal_differential_equations_torch.examples.climate_training_rt import DATA, OUT_DIR
from universal_differential_equations_torch.models import climate_npde as cn
from universal_differential_equations_torch.models.climate_datagen import (
    coarse_grain,
    rayleigh_taylor_3d,
)
from universal_differential_equations_torch.utils import card_name, require_viz

F32 = torch.float32
PLOTS = Path(__file__).resolve().parents[2] / "build" / "plots" / "climate"
SEED = 0  # the JAX script's PRNGKey(0)
REFERENCE_JLD2 = "rayleigh_taylor_instability_3d_horizontal_averages.jld2"


def load_or_generate(quick: bool, source: str = "auto", path=DATA, device="cuda"):
    """``(t, z, b)``: with ``quick`` a 16×2×16 run to t = 1 (noise from
    ``torch.Generator(1)``), else the averages at ``path``."""
    if source == "reference":
        raise FileNotFoundError(
            f"--data reference trains on the reference's Oceananigans output "
            f"{REFERENCE_JLD2} (npde_data.jl:41), which is not in the repository; "
            f"use --data generated")
    if quick:
        shape, endt = (16, 2, 16), 1.0
        print(f"generating RT data on a {shape} grid ...")
        return rayleigh_taylor_3d(N=shape, end_time=endt, save_every=0.1,
                                  key=torch.Generator().manual_seed(1), device=device)
    with np.load(path) as d:
        return d["t"], d["z"], d["b"]


def column(t, b, n_grid, device):
    """``(ts, data, u0)``: float32 save times, the interior levels of the
    profiles coarse-grained to ``n_grid`` (``:46`` ``u0=[2:end-1]``) and the
    first of them."""
    if b.shape[1] != n_grid:
        b = np.asarray(coarse_grain(b, b.shape[1] // n_grid))
    ts = torch.as_tensor(t, dtype=F32, device=device)
    data = torch.as_tensor(np.asarray(b[:, 1:-1], np.float32), device=device)
    return ts, data, data[0]


def make_model(n, D1, D2, device):
    """``(rhs, params0, net)``: five ``n``→``n`` tanh layers, like the
    reference Chain (``:62-63``), inside ``D1·NN(u) + D2·u``; ``args`` are the
    net's parameters."""
    net = ude.MLP([n] * 6, activation="tanh", final_activation="tanh")
    params0 = net.init(torch.Generator().manual_seed(SEED), F32, device)

    def rhs(tt, u, p):
        return D1 @ net.apply(p, u) + D2 @ u

    return rhs, params0, net


def make_loss(rhs, u0, tspan, ts, data, solver, rtol, atol, max_steps):
    """Σ (u(ts) − data)² through ``solver`` and the interpolating adjoint."""

    def loss_fn(p):
        sol = ude.solve(ude.ODEProblem(rhs, u0, tspan, p), solver, saveat=ts, rtol=rtol,
                        atol=atol, adjoint=ude.InterpolatingAdjoint(), max_steps=max_steps)
        return torch.sum((sol.ys - data) ** 2)

    return loss_fn


def stabilized_rollout(rhs, u0, tspan, ts, params, solver):
    """The trained flux rolled out by a stabilized solver at rtol 1e-3."""
    return ude.solve(ude.ODEProblem(rhs, u0, tspan, params), solver, saveat=ts, rtol=1e-3,
                     atol=1e-4, adjoint=ude.NoAdjoint(), max_steps=8192)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def reference_protocol_bar(rhs, u0, tspan, ts, data, eig, params0, out_dir=OUT_DIR):
    """The reference's own training protocol as a comparison bar: the same
    net and ``params0``, plain full-batch ADAM(0.01) for 20 steps
    (``npde_data.jl:107-109``: final params kept), through ROCK4 (ρ·2.5,
    sized for 200 steps) and its interpolating adjoint at reltol 1e-5 /
    abstol 1e-6 (``:80``), scored by the ROCK4 rollout's rel-L2.  Writes
    ``npde_ref_protocol.json`` under ``out_dir``."""
    train_solver = ude.ROCK4.for_problem(eig * 2.5, tspan, n_steps_hint=200)
    loss_fn = make_loss(rhs, u0, tspan, ts, data, train_solver, 1e-5, 1e-6, 8192)
    losses = []

    def cb(step, l, p):
        losses.append(float(l))
        print(f"  protocol step {step:3d}  loss {l:.4e}", flush=True)
        return False

    t0 = time.time()
    res = ude.fit(loss_fn, params0, lambda ps: torch.optim.Adam(ps, lr=0.01), 20,
                  callback_every=1, callback=cb)
    wall = time.time() - t0
    rock4 = ude.ROCK4.for_problem(eig * 1.1, tspan, n_steps_hint=60)
    sol = stabilized_rollout(rhs, u0, tspan, ts, res.params, rock4)
    ok = bool(sol.success) and bool(torch.isfinite(sol.ys).all())
    rel = _rel(sol.ys, data) if ok else float("inf")
    payload = {"rel_l2": rel, "rollout_success": ok, "final_loss": float(res.final_loss),
               "losses": losses, "wall_s": round(wall, 1), "train_solver": train_solver.name,
               "protocol": "npde_data.jl:107-109 ADAM(0.01) x 20, rtol 1e-5/atol 1e-6, "
                           "final params"}
    path = Path(out_dir) / "npde_ref_protocol.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1))
    print(f"reference-protocol bar: rollout rel-L2 = {rel}, final loss "
          f"{float(res.final_loss):.4e} in {wall:.1f}s -> {path}")
    return payload


def write_plots(z, n_grid, tspan, data, rollout_ys, outdir=None):
    """``npde_data.jl``'s figure: the data and the ROCK4 rollout as z-t
    fields over the interior levels of the coarse-grained column, into
    ``outdir`` (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    # the physical vertical coordinate: the coarse-grained interior levels of
    # the centred RT domain (as climate_data_generation's rt_averages.pdf)
    zc = np.asarray(coarse_grain(np.asarray(z)[None, :], len(z) // n_grid))[0]
    extent = (tspan[0], tspan[1], float(zc[1]), float(zc[-2]))
    viz.save(viz.plot_field(data.cpu().numpy().T, extent,
                            title="b̄(z, t) data (interior levels)", ylabel="z",
                            cbar_label="b̄"), outdir / "npde_data_truth.pdf")
    viz.save(viz.plot_field(rollout_ys.cpu().numpy().T, extent,
                            title="neural-PDE ROCK4 rollout", ylabel="z", cbar_label="b̄"),
             outdir / "npde_data_rollout.pdf")
    print(f"plots written to {outdir}")


def main(quick=False, device="cuda", source="auto", reference_bar=False, plot=False,
         out_dir=OUT_DIR, adam_steps=None):
    """The pipeline; ``adam_steps`` overrides the ADAM budget (300; 30 with
    ``quick``)."""
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    t, z, b = load_or_generate(quick, source, device=device)
    # the generated dataset trains at 32 levels (16 in --quick)
    n_grid = 16 if quick else 32
    ts, data, u0 = column(t, b, n_grid, device)
    n = n_grid - 2
    print(f"{data.shape[0]} profiles at {n_grid} levels over t in [0, {float(ts[-1]):.1f}]; "
          f"{card_name(device)}")
    D1, D2, eig = cn.getops(n_grid, dtype=F32, device=device)
    tspan = (float(ts[0]), float(ts[-1]))
    rhs, params0, _ = make_model(n, D1, D2, device)
    out = dict(device=card_name(device), quick=quick, levels=n_grid, profiles=data.shape[0])

    if reference_bar:
        out["reference_bar"] = reference_protocol_bar(rhs, u0, tspan, ts, data, eig, params0,
                                                      out_dir)
        return out

    loss_fn = make_loss(rhs, u0, tspan, ts, data, ude.Tsit5(), 1e-4, 1e-6, 2048)
    with torch.no_grad():
        l0 = float(loss_fn(params0))
    # the best loss and parameters seen at the callbacks: plain ADAM's last
    # step can be a noisy jump, and the gate and rollout read what training
    # reached
    best = {"loss": float("inf"), "params": params0}

    def track(step, l, p):
        if l < best["loss"]:
            best["loss"], best["params"] = l, p
        print(f"  step {step:4d}  loss {l:.4e}", flush=True)
        return False

    adam_steps = (30 if quick else 300) if adam_steps is None else adam_steps
    t0 = time.perf_counter()
    res = ude.fit(loss_fn, params0, lambda ps: torch.optim.Adam(ps, lr=0.01), adam_steps,
                  callback_every=30, callback=track)
    wall = time.perf_counter() - t0
    print(f"ADAM(0.01): loss {l0:.4e} -> best {best['loss']:.4e} (final "
          f"{res.final_loss:.4e}) in {wall:.1f}s")

    # rollout with the stabilized solver and eigen_est, the reference's ROCK4 hook
    t1 = time.perf_counter()
    rock4 = ude.ROCK4.for_problem(eig * 1.1, tspan, n_steps_hint=60)
    sol = stabilized_rollout(rhs, u0, tspan, ts, best["params"], rock4)
    rel = _rel(sol.ys, data)
    print(f"ROCK4 rollout (stages={rock4.stages}): success={bool(sol.success)}, rel-L2 vs "
          f"data = {rel:.4f}")
    # cross-check with the second stabilized family: the RKC2 rollout of the
    # same trained flux must land on the same trajectory
    rkc2 = ude.RKC2.for_problem(eig * 1.1, tspan, n_steps_hint=60)
    sol2 = stabilized_rollout(rhs, u0, tspan, ts, best["params"], rkc2)
    dev = _rel(sol2.ys, sol.ys)
    print(f"RKC2 rollout cross-check (stages={rkc2.stages}): success={bool(sol2.success)}, "
          f"dev vs ROCK4 = {dev:.2e}")
    rollout_wall = time.perf_counter() - t1

    gates = dict(rkc2=bool(sol2.success) and dev < 0.05)
    if not quick:
        gates.update(loss=best["loss"] < 0.2 * l0, rollout=bool(sol.success) and rel < 0.6)
    counts = {s.name: dict(accepted=int(x.num_accepted), rejected=int(x.num_rejected),
                           rhs_evals=int(x.num_rhs_evals))
              for s, x in ((rock4, sol), (rkc2, sol2))}
    out.update(l0=l0, best=best["loss"], final=res.final_loss, adam_steps=adam_steps,
               train_s=wall, s_per_step=wall / max(adam_steps, 1), rollout_s=rollout_wall,
               rel=rel, dev_rkc2=dev, rollouts=counts, gates=gates)
    if device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if not all(gates.values()):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"climate neural-PDE (data) gate failed: {gates}")
    if plot:
        write_plots(z, n_grid, tspan, data, sol.ys)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--plot", action="store_true",
                    help="write the figures to build/plots/climate/")
    ap.add_argument("--data", choices=("auto", "reference", "generated"), default="auto",
                    help="'generated' (and 'auto') trains on the RT averages; 'reference' "
                         "needs the reference's JLD2, which is not in the repository")
    ap.add_argument("--reference-bar", action="store_true",
                    help="run only the reproduced reference protocol (20 x ADAM(0.01) "
                         "through ROCK4) and write its rollout rel-L2")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device, source=args.data,
                          reference_bar=args.reference_bar, plot=args.plot)), flush=True)
