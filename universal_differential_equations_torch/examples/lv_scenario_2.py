"""LV scenario 2 on the port: partial observability with jointly learned physics.

    python -m universal_differential_equations_torch.examples.lv_scenario_2 [--quick] [--plot] \\
        --device cuda

The port of ``examples/lotka_volterra/scenario_2.py`` (``scenario_2.jl``),
stage by stage with the same constants: x is measured on the 0.1-grid over
(0, 6) but y only at 6 evenly spaced times; the predator decay rate δ is
learned jointly with the 2→5→5→5→2 RBF net (``{"delta", "nn"}``,
``scenario_2.jl:87-95``); the loss is the reference's hand-rolled multiple
shooting over the 5 y-measurement segments, solved together by one
``torch.func.vmap`` over ``solve`` with ``ForwardSensitivity``, with an
endpoint penalty on y and L2 weight regularization (``:113-124``); ADAM(0.1)
then Levenberg-Marquardt through ``torch.func.jacfwd``; SINDy then recovers
the missing interactions with the reference's model-selection objective
``g(x) = x[1] ≤ 1 ? Inf : 2x[1] − 2log(x[2])`` (``:199``).

Every stage runs in float32 on ``--device`` (default ``cuda``; it raises
where there is no card — ``--device cpu`` must be asked for), as the JAX
script runs on its accelerator.  The data and initial parameters come from
``torch.Generator(2222)``, not ``jax.random``.  ``--plot`` writes the JAX
script's ``scenario_2_fit.pdf`` to ``build/plots/lotka_volterra/``
(:func:`write_plots`); it needs matplotlib, imported before the data is made.

Without ``--quick`` the run must learn δ within 0.3 of 1.8 and recover
``u1*u2`` in both equations (``scenario_2.py``'s asserts).  The last line of
the output is a JSON object with the stage wall times and the results.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch import sindy as sd
from universal_differential_equations_torch.examples.lv_scenario_1 import stopwatch
from universal_differential_equations_torch.flatten_util import ravel_pytree
from universal_differential_equations_torch.models import lotka_volterra as lv
from universal_differential_equations_torch.utils import card_name, require_viz

F32 = torch.float32
SEED = 2222  # the reference's PRNGKey(2222)
N_SEG = 5
LAMS = tuple(10.0 ** e for e in np.arange(-3.0, 5.0, 0.1))
PLOTS = Path(__file__).resolve().parents[2] / "build" / "plots" / "lotka_volterra"


def make_data(noise, dtype=F32, device=None):
    """LV truth on (0, 6) at rtol = atol = 1e-6, 0.1-grid, 5e-3 noise:
    ``(ts, X, Xn)`` (``noise`` as for ``lotka_volterra.generate_data``)."""
    return lv.generate_data(noise, tspan=(0.0, 6.0), rtol=1e-6, atol=1e-6, dtype=dtype,
                            device=device)


def segments(ts, Xn, n_seg=N_SEG):
    """The 5 y-measurement windows: ``(seg_ts, seg_x, y_left, y_right)``,
    each window 12 grid intervals long."""
    seg_len = (ts.shape[0] - 1) // n_seg
    starts = np.arange(n_seg) * seg_len
    seg_ts = torch.stack([ts[s:s + seg_len + 1] for s in starts])
    seg_x = torch.stack([Xn[s:s + seg_len + 1, 0] for s in starts])
    y_left = Xn[starts, 1]
    y_right = Xn[starts + seg_len, 1]
    return seg_ts, seg_x, y_left, y_right


def make_model(generator, dtype=F32, device=None):
    """``(rhs, params0, net)``: ``du1 = α u1 + NN₁(u)``, ``du2 = −δ u2 +
    NN₂(u)`` with δ learned (``{"delta": U(0, 1), "nn": ...}``)."""
    net = ude.MLP([2, 5, 5, 5, 2], activation="rbf")
    delta = torch.rand((), generator=generator, dtype=torch.float64)
    params0 = {"delta": delta.to(dtype=dtype, device=device),
               "nn": net.init(generator, dtype, device)}
    alpha = float(lv.P_TRUE[0])

    def rhs(t, u, p):
        uhat = net.apply(p["nn"], u)
        return torch.stack([alpha * u[0] + uhat[0], -p["delta"] * u[1] + uhat[1]])

    return rhs, params0, net


def make_residuals(rhs, seg_ts, seg_x, y_left, y_right):
    """The segment residuals (``scenario_2.jl:113-124``): per segment, start
    at (x, y) data on the left boundary and fit x along the window; the y
    endpoint enters squared (the reference's |·| kink stalls line searches),
    weighted 3; the net's weights are regularized.  All segments are one
    vmapped solve with forward sensitivities, so ``jacfwd`` carries it."""
    seg_span = float(seg_ts[0, -1] - seg_ts[0, 0])

    def residuals(p):
        def segment(x0, y0, tw):
            prob = ude.ODEProblem(rhs, torch.stack([x0, y0]), (0.0, seg_span), p)
            return ude.solve(prob, ude.Tsit5(), saveat=tw - tw[0], rtol=1e-6, atol=1e-6,
                             adjoint=ude.ForwardSensitivity(), max_steps=128).ys

        preds = torch.func.vmap(segment)(seg_x[:, 0], y_left, seg_ts)  # (5, 13, 2)
        flat = ravel_pytree(p["nn"])[0]
        rx = (preds[:, :, 0] - seg_x).reshape(-1)
        ry = 3.0 * (preds[:, -1, 1] - y_right)
        rr = (1e-3 / flat.numel()) ** 0.5 * flat
        return torch.cat([rx, ry, rr])

    return residuals


def selection_g(k, rss, N):
    """``scenario_2.jl:199``'s ``g``: AIC ``2k + N·log(rss/N)``, with models
    of at most one active term rejected outright."""
    k = k.to(rss.dtype)
    return torch.where(k <= 1, torch.full_like(rss, float("inf")),
                       2.0 * k + N * torch.log(rss / N))


def reconstruct(rhs, p, u0):
    """The full trajectory from ``u0`` on a 0.05-grid over (0, 6):
    ``(half_ts, Xh)``."""
    half_ts = torch.arange(0.0, 6.01, 0.05, dtype=u0.dtype, device=u0.device)
    sol = ude.solve(ude.ODEProblem(rhs, u0, (0.0, 6.0), p), ude.Tsit5(), saveat=half_ts,
                    rtol=1e-6, atol=1e-6, adjoint=ude.NoAdjoint())
    return half_ts, sol.ys


def recover(rhs, net, p, u0):
    """Full-trajectory reconstruction (:func:`reconstruct`) and SINDy on the
    net's outputs with ``selection_g``: ``(result, basis)``."""
    _, Xh = reconstruct(rhs, p, u0)
    Yh = net.apply(p["nn"], Xh)
    basis = sd.polynomial_basis(2, 5) + sd.sin_basis(2)
    res = sd.sindy(sd.DirectDataDrivenProblem(Xh, Yh), basis, sd.STLSQ(LAMS),
                   normalize=True, sampler=sd.DataSampler(4), exhaustive_k=2,
                   selection=selection_g)
    return res, basis


def write_plots(half_ts, Xh, ts, Xn, delta, outdir=None):
    """``scenario_2.jl``'s figure: the reconstruction against the dense
    x-measurements and the six y-measurements, into ``outdir``
    (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    ts, Xn = ts.cpu().numpy(), Xn.cpu().numpy()
    fig = viz.plot_timeseries(
        half_ts, Xh, labels=["x (UDE)", "y (UDE)"],
        title=f"partial observability: y seen {N_SEG + 1}× (learned δ = {float(delta):.3f}, "
              f"true {float(lv.P_TRUE[3]):.1f})", ylabel="population")
    ax = fig.axes[0]
    ax.scatter(ts, Xn[:, 0], s=9, color=viz.SERIES[0], alpha=0.5, edgecolors="none",
               label="x data (dense)")
    seg_len = (len(ts) - 1) // N_SEG
    y_idx = np.append(np.arange(N_SEG) * seg_len, N_SEG * seg_len)
    ax.scatter(ts[y_idx], Xn[y_idx, 1], s=40, marker="D", color=viz.SERIES[1], zorder=4,
               label="y data (6 points)")
    ax.legend(fontsize=8, ncol=2)
    viz.save(fig, outdir / "scenario_2_fit.pdf")
    print(f"plots written to {outdir}")


def main(quick=False, device="cuda", plot=False):
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    walls, lap = stopwatch(device)
    gen = torch.Generator().manual_seed(SEED)
    ts, _, Xn = make_data(gen, device=device)
    seg_ts, seg_x, y_left, y_right = segments(ts, Xn)
    print(f"data: x on {ts.shape[0]} points, y on {N_SEG + 1} points")
    rhs, params0, net = make_model(gen, device=device)
    residuals = make_residuals(rhs, seg_ts, seg_x, y_left, y_right)
    lap("data")

    def loss(p):
        r = residuals(p)
        return torch.sum(r * r)

    r1 = ude.fit(loss, params0, lambda ps: torch.optim.Adam(ps, lr=0.1),
                 100 if quick else 200, callback_every=100)
    lap("adam")
    lm_walls = []
    last = [time.perf_counter()]

    def on_iter(k, value):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        lm_walls.append(now - last[0])
        last[0] = now

    r2 = ude.levenberg_marquardt(residuals, r1.params, maxiters=50 if quick else 150,
                                 callback=on_iter)
    lap("lm")
    delta = float(r2.params["delta"])
    print(f"training: adam {r1.final_loss:.4f} -> LM {float(r2.loss):.4f} in "
          f"{r2.iterations} iterations; learned δ = {delta:.4f} (true {float(lv.P_TRUE[3])})")

    res, basis = recover(rhs, net, r2.params, Xn[0])
    print("recovered interactions:")
    for eq in res.equations():
        print("   " + eq[:90])
    names = basis.names
    got = [sorted(names[j] for j in np.nonzero(res.active[:, e])[0]) for e in range(2)]
    lap("sindy")
    gates = dict(delta=abs(delta - float(lv.P_TRUE[3])) < 0.3,
                 xy=all("u1*u2" in g for g in got))
    out = dict(device=card_name(device), quick=quick, walls=walls, total_s=sum(walls.values()),
               adam_loss=r1.final_loss, lm_loss=float(r2.loss), lm_iterations=r2.iterations,
               lm_s_per_iteration=float(np.median(lm_walls)) if lm_walls else None,
               delta=delta, equations=res.equations(), gates=gates)
    if not quick and not all(gates.values()):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"scenario 2 gate failed: {gates}, terms {got}")
    if plot:
        write_plots(*reconstruct(rhs, r2.params, Xn[0]), ts, Xn, delta)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="100 ADAM steps and 50 LM iterations; no accuracy gate")
    ap.add_argument("--plot", action="store_true",
                    help="write the figure to build/plots/lotka_volterra/")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device, plot=args.plot)), flush=True)
