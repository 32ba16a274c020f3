"""Climate neural-ODE propagator on the port, trained on Rayleigh-Taylor horizontal averages.

    python -m universal_differential_equations_torch.examples.climate_training_rt
        [--quick] [--data PATH] [--checkpoint PATH] [--plot] [--device cuda]

The port of ``examples/climate/training_rt.py``
(``Climate/Training/neural_pde_rayleigh_taylor_instability.jl``): load the
b̄(z, t) horizontal averages of a 3-D RT run (by default the committed
41 × 64 dataset, ``examples/climate/data/rt_horizontal_averages.npz``;
``--quick`` generates a 16×2×16 run to t = 0.6 instead), resample each level
onto the 0.1 grid, coarse-grain to 16 levels (8 with ``--quick``), build the
one-step pairs (bₙ, bₙ₊₁) (40 from the committed data), and train the chain
16→32→64→64→32→16 (tanh, 9,424 parameters) as a neural-ODE one-step
propagator over (0, 0.1) with Tsit5 at rtol 1e-4 — every pair's solve in one
``torch.func.vmap``, its gradient through the interpolating adjoint.
Training is ADAM(1e-3), re-initialized every epoch (25 epochs of 100 steps;
3 of 20 with ``--quick``), with ``reduce_on_plateau(factor=0.1,
patience=2)`` and best-loss checkpointing, over the seed ladder (42, 7, 19):
the model with the lowest 40-step free-rollout rel-L2 is kept, and the
ladder stops at the first seed that passes both gates.

Gates, as in the JAX script (not with ``--quick``): the kept model's one-step
loss < 2e-4 and its rollout rel-L2 < 0.20.  The model is saved to
``build/climate/dbdt_nn.npz`` (``dbdt_nn_quick.npz``), in the file format
both packages read.  ``--checkpoint PATH`` evaluates a saved model (for
example the JAX package's committed ``examples/climate/data/dbdt_nn.npz``)
without training.  Every stage runs on ``--device`` (default ``cuda``);
initial weights come from ``torch.Generator(seed)``, which draws other
numbers than ``jax.random``.  ``--plot`` writes the JAX script's figures
(data and rollout fields, profile snapshots, the rollout GIF) to
``build/plots/climate/`` for the kept or ``--checkpoint`` model
(:func:`write_plots`); it needs matplotlib and Pillow, imported before the
data.  The last line of the output is a JSON object with the walls, per-seed results
and gates.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch.io import load_pytree, save_pytree
from universal_differential_equations_torch.models.climate_datagen import (
    coarse_grain,
    rayleigh_taylor_3d,
)
from universal_differential_equations_torch.utils import card_name, require_viz

F32 = torch.float32
ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "examples" / "climate" / "data" / "rt_horizontal_averages.npz"
OUT_DIR = ROOT / "build" / "climate"
PLOTS = ROOT / "build" / "plots" / "climate"
DT_PAIR = 0.1
SEEDS = (42, 7, 19)


def load_or_generate(quick: bool, path=DATA, device="cuda"):
    """``(t, z, b)``: the averages at ``path``, or with ``quick`` a 16×2×16
    run to t = 0.6 (noise from ``torch.Generator(1)``)."""
    if not quick:
        with np.load(path) as d:
            return d["t"], d["z"], d["b"]
    shape, endt = (16, 2, 16), 0.6
    print(f"generating RT data on a {shape} grid ...")
    return rayleigh_taylor_3d(N=shape, end_time=endt, save_every=0.1,
                              key=torch.Generator().manual_seed(1), device=device)


def coarse_pairs(t, b, cr):
    """Resample every level onto the 0.1 grid (the saves land at chunk
    boundaries), coarse-grain to ``cr`` levels: ``(t_u, b_cs, n_pairs)``,
    numpy float64, with ``n_pairs = min(100, len(t_u) - 1)``."""
    t_u = np.arange(0.0, t[-1] + 1e-9, DT_PAIR)
    b_u = np.stack([np.interp(t_u, t, b[:, k]) for k in range(b.shape[1])], 1)
    b_cs = np.asarray(coarse_grain(b_u, b_u.shape[1] // cr))
    return t_u, b_cs, min(100, len(t_u) - 1)


def make_model(cr):
    """``(net, prop)``: the chain cr→2cr→4cr→4cr→2cr→cr (tanh) and its
    one-step propagator over (0, 0.1), Tsit5 at rtol 1e-4, ≤ 64 steps."""
    net = ude.MLP([cr, 2 * cr, 4 * cr, 4 * cr, 2 * cr, cr], activation="tanh")
    return net, ude.NeuralODE(net, (0.0, DT_PAIR), rtol=1e-4, atol=1e-6, max_steps=64)


def make_loss(prop, bn, bn1):
    """The one-step loss: every pair's solve in one ``torch.func.vmap``."""

    def loss_fn(params):
        pred = torch.func.vmap(lambda b0: prop(params, b0))(bn)
        return torch.mean((pred - bn1) ** 2)

    return loss_fn


def rollout_rel(prop, params, b_cs, n_roll):
    """The free rollout of the propagator from the first profile (``:188``):
    ``(rel-L2 against b_cs[:n_roll+1], roll)``."""
    device = params[0]["w"].device
    roll = [torch.as_tensor(b_cs[0], dtype=F32, device=device)]
    with torch.no_grad():
        for _ in range(n_roll):
            roll.append(prop(params, roll[-1]))
    roll = np.stack([r.cpu().numpy() for r in roll])
    ref = b_cs[: n_roll + 1]
    return float(np.linalg.norm(roll - ref) / np.linalg.norm(ref)), roll


def train_seed(net, loss_fn, seed, epochs, steps_per_epoch, ckpt_path, device):
    """One seed of the ladder: ADAM(lr) re-initialized every epoch, the
    plateau schedule fed the epoch's final loss.  Returns ``(params, best)``,
    ``best`` the :class:`BestCheckpoint`'s best-seen loss."""
    params = net.init(torch.Generator().manual_seed(seed), F32, device)
    ckpt = ude.BestCheckpoint(ckpt_path)
    sched = ude.reduce_on_plateau(1e-3, factor=0.1, patience=2)
    lr = 1e-3
    for epoch in range(epochs):
        res = ude.fit(loss_fn, params, lambda ps, lr=lr: torch.optim.Adam(ps, lr=lr),
                      steps_per_epoch, callback=ckpt, callback_every=steps_per_epoch)
        params, loss = res.params, res.final_loss
        new_lr = sched(loss)
        if new_lr != lr:
            print(f"  plateau: lr {lr:.1e} -> {new_lr:.1e}")
            lr = new_lr
        print(f"epoch {epoch + 1:3d}  train_loss = {loss:.3e}", flush=True)
    return params, ckpt.best


def write_plots(t_u, z, b_cs, roll, cr, outdir=None):
    """The reference's rollout-vs-data animations (``:186-202``) and their
    static analogues: the data and the free rollout ``roll`` as z-t fields,
    four profile snapshots, and ``rt_rollout.gif``, into ``outdir``
    (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    n_roll = len(roll) - 1
    extent = (0.0, float(t_u[n_roll]), float(z[0]), float(z[-1]))
    viz.save(viz.plot_field(b_cs[: n_roll + 1].T, extent,
                            title="b̄(z, t) data (coarse-grained LES)", ylabel="z",
                            cbar_label="b̄"), outdir / "rt_data.pdf")
    viz.save(viz.plot_field(roll.T, extent, title="b̄(z, t) neural-ODE free rollout",
                            ylabel="z", cbar_label="b̄"), outdir / "rt_rollout.pdf")
    zc = np.asarray(coarse_grain(np.asarray(z)[None, :], len(z) // cr))[0]
    fig, ax = viz.new_figure(4.2, 3.4)
    for j, frac in enumerate((0.0, 0.33, 0.66, 1.0)):
        i = int(frac * n_roll)
        ax.plot(b_cs[i], zc, color=viz.SERIES[j], linewidth=1.8, alpha=0.35)
        ax.plot(roll[i], zc, color=viz.SERIES[j], linewidth=1.1, linestyle="--",
                label=f"t = {t_u[i]:.1f}")
    ax.set_xlabel("b̄")
    ax.set_ylabel("z")
    ax.set_title("profiles: data (solid) vs rollout (dashed)")
    ax.legend(fontsize=8)
    viz.save(fig, outdir / "rt_profiles.pdf")
    viz.animate_profiles(outdir / "rt_rollout.gif", zc, b_cs[: n_roll + 1], pred=roll,
                         ts=t_u[: n_roll + 1], xlabel="b̄", title="free rollout")
    print(f"plots written to {outdir}")


def main(quick=False, device="cuda", data=DATA, checkpoint=None, plot=False, out_dir=OUT_DIR,
         epochs=None, steps_per_epoch=None):
    """The pipeline; ``epochs`` and ``steps_per_epoch`` override the budgets
    (25 × 100; 3 × 20 with ``quick``)."""
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    t, z, b = load_or_generate(quick, data, device)
    cr = 8 if quick else 16  # coarse resolution (reference: 16, :69)
    t_u, b_cs, n_pairs = coarse_pairs(t, b, cr)
    bn = torch.as_tensor(b_cs[:n_pairs], dtype=F32, device=device)
    bn1 = torch.as_tensor(b_cs[1:n_pairs + 1], dtype=F32, device=device)
    print(f"{n_pairs} training pairs at {cr} levels, t in [0, {t_u[-1]:.1f}]; "
          f"{card_name(device)}")
    net, prop = make_model(cr)
    loss_fn = make_loss(prop, bn, bn1)
    n_roll = len(b_cs) - 1
    out = dict(device=card_name(device), quick=quick, pairs=n_pairs, levels=cr)

    if checkpoint is not None:
        like = net.init(torch.Generator().manual_seed(0), F32, device)
        params = load_pytree(checkpoint, like, device=device)
        one_step = float(loss_fn(params))
        rel, roll = rollout_rel(prop, params, b_cs, n_roll)
        print(f"checkpoint {checkpoint}: one-step {one_step:.3e}, rollout rel-L2 {rel:.4f}")
        out.update(checkpoint=str(checkpoint), loss=one_step, rel=rel)
        if plot:
            write_plots(t_u, z, b_cs, roll, cr)
        return out

    ckpt_path = Path(out_dir) / ("dbdt_nn_quick.npz" if quick else "dbdt_nn.npz")
    epochs = (3 if quick else 25) if epochs is None else epochs
    steps_per_epoch = (20 if quick else 100) if steps_per_epoch is None else steps_per_epoch
    seeds = (42,) if quick else SEEDS
    t0 = time.perf_counter()
    best, ladder = None, []
    for seed in seeds:
        ts = time.perf_counter()
        params, best_seen = train_seed(net, loss_fn, seed, epochs, steps_per_epoch,
                                       ckpt_path, device)
        rel, roll = rollout_rel(prop, params, b_cs, n_roll)
        # the final params' own one-step loss, not the best seen (which may
        # belong to other params than the ones kept and saved)
        one_step = float(loss_fn(params))
        wall = time.perf_counter() - ts
        print(f"seed {seed}: final one-step {one_step:.3e} (best seen {best_seen:.3e}), "
              f"rollout rel-L2 {rel:.4f}, {wall:.1f} s", flush=True)
        ladder.append(dict(seed=seed, loss=one_step, best_seen=best_seen, rel=rel, wall_s=wall))
        if best is None or rel < best["rel"]:
            best = dict(params=params, rel=rel, loss=one_step, seed=seed, roll=roll)
        if rel < 0.20 and one_step < 2e-4:
            break
    # the saved checkpoint is the selected model
    save_pytree(ckpt_path, best["params"])
    wall = time.perf_counter() - t0
    print(f"trained in {wall:.1f}s; selected seed {best['seed']} (one-step {best['loss']:.3e}, "
          f"rollout rel-L2 {best['rel']:.4f}) -> {ckpt_path}")
    out.update(train_s=wall, ladder=ladder, seed=best["seed"], loss=best["loss"],
               rel=best["rel"], written=str(ckpt_path),
               adam_steps=len(ladder) * epochs * steps_per_epoch)
    if device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if not quick:
        gates = dict(one_step=best["loss"] < 2e-4, rollout=best["rel"] < 0.20)
        out["gates"] = gates
        if not all(gates.values()):
            print(json.dumps(out), flush=True)
            raise RuntimeError(f"RT propagator gate failed: {gates}")
    if plot:
        write_plots(t_u, z, b_cs, best["roll"], cr)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--data", default=str(DATA),
                    help="the b(z, t) averages to train on (.npz with t, z, b)")
    ap.add_argument("--checkpoint", default=None,
                    help="evaluate this saved model instead of training")
    ap.add_argument("--plot", action="store_true",
                    help="write the figures and the rollout GIF to build/plots/climate/")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device, data=args.data,
                          checkpoint=args.checkpoint, plot=args.plot)), flush=True)
