"""100-dimensional Hamilton-Jacobi-Bellman equation via deep BSDE, on the port.

    python -m universal_differential_equations_torch.examples.hjb_100d
        [--quick] [--adaptive] [--no-mesh] [--device cuda]

The port of ``examples/highdim_pde/hjb_100d.py`` (``highdim_pde/lambaem.jl``):
the LQG control problem u_t + Δu − λ‖∇u‖² = 0, u(T,x) = g(x) =
log(½ + ½‖x‖²), solved at x0 = 0 with two ReLU networks (100→110→110→1 and
101→110→110→110→100), m = 100 trajectories, ADAM(0.03), pabstol 1e-2, 50 time
steps and 2500 iterations (20 and 1400 with ``--quick``), validated against
the 10⁵-sample analytic Monte-Carlo value with the reference's rel-L2 < 0.2
assertion.  ``--adaptive`` is the reference's ``alg=LambaEM(), abstol,
reltol`` mode: an AdaptiveEM pilot picks the grid and refinement doubles it
until u(0, x0) stops moving.

Everything runs on ``--device`` (default ``cuda``) in float32; the initial
weights come from ``torch.Generator().manual_seed(0)`` and the Monte-Carlo
draws from seed 7.  The trajectories are the distributed axis: with several
ranks (``torchrun``, with the ``UDE_DISTRIBUTED`` opt-in) the 100 paths are
split over the largest number of ranks that divides 100, as the JAX script
splits them over devices::

    UDE_DISTRIBUTED=1 torchrun --nproc-per-node 4 -m \\
        universal_differential_equations_torch.examples.hjb_100d --quick

One process runs them all on its card; ``--no-mesh`` turns the split off.
``--plot`` writes the JAX script's ``hjb_loss.pdf`` to
``build/plots/highdim_pde/`` from rank 0 (:func:`write_plots`); it needs
matplotlib, imported before training.  The last line of the
output (rank 0's) is a JSON object with the row ``hjb100d_rel_l2`` and,
beside it, ``train_wall_s`` and the seconds per iteration (the trainer's
``StepTimer`` over its last 50 iterations).
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch.deepbsde import (
    NNPDENS,
    TerminalPDEProblem,
    mc_analytical_hjb,
    solve_terminal_pde,
)
from universal_differential_equations_torch.parallel import (
    ensemble_mesh,
    initialize_distributed,
    process_count,
    process_rank,
)
from universal_differential_equations_torch.utils import card_name, require_viz

D = 100
LAM = 1.0
PLOTS = Path(__file__).resolve().parents[2] / "build" / "plots" / "highdim_pde"


def hjb_problem(device, dtype=torch.float32):
    """``(problem, alg)``: the HJB at d = 100 and the reference's two nets."""
    g = lambda x: torch.log(0.5 + 0.5 * torch.sum(x * x))  # noqa: E731
    f = lambda t, x, u, z: -LAM * torch.sum(z * z)  # noqa: E731
    mu = lambda t, x: torch.zeros_like(x)  # noqa: E731
    sigma = lambda t, x: math.sqrt(2.0)  # √2·I  # noqa: E731
    prob = TerminalPDEProblem(g, f, mu, sigma, torch.zeros(D, dtype=dtype, device=device),
                              (0.0, 1.0))
    hls = D + 10
    alg = NNPDENS(u0_net=ude.MLP([D, hls, hls, 1], activation="relu"),
                  grad_net=ude.MLP([D + 1, hls, hls, hls, D], activation="relu"))
    return prob, alg


def auto_mesh(device, m=100):
    """The trajectory mesh of ``mesh="auto"``: the first k ranks, k the
    largest divisor of ``m`` not above the rank count; None at one rank, and
    on a rank outside the mesh (which then runs every trajectory itself)."""
    n_mesh = max(k for k in range(1, process_count() + 1) if m % k == 0)
    if n_mesh == 1:
        return None
    mesh = ensemble_mesh(n_mesh, device=device)
    return mesh if mesh.index is not None else None


def write_plots(losses, u0, analytical, rel_l2, outdir=None):
    """``lambaem.jl``'s figure: the terminal-condition loss over training,
    annotated with u(0, 0) against the analytic MC value, into ``outdir``
    (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    fig = viz.plot_loss_history(losses, title="deep-BSDE terminal loss (100-D HJB)")
    fig.axes[0].annotate(f"u(0,0) = {u0:.3f}   analytic MC = {analytical:.3f}   "
                         f"rel L2 = {rel_l2:.4f}", (0.02, 0.04), xycoords="axes fraction",
                         fontsize=8)
    viz.save(fig, outdir / "hjb_loss.pdf")
    print(f"plots written to {outdir}")


def main(quick=False, plot=False, adaptive=False, mesh="auto", device="cuda"):
    """The case study; raises ``AssertionError`` after printing the result
    where rel-L2 is not below 0.2.  ``mesh``: ``"auto"`` (:func:`auto_mesh`),
    None, or a ``parallel.Mesh`` whose ranks all make the call; with ``plot``
    rank 0 writes the figure."""
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    if mesh == "auto":
        mesh = auto_mesh(device)
    lead = process_rank() == 0
    prob, alg = hjb_problem(device)
    print(f"deep-BSDE HJB d={D} on {card_name(device)}", flush=True)
    if mesh is not None and lead:
        print(f"sharding 100 trajectories over a {mesh.size}-rank "
              f"'{mesh.axis_names[0]}' mesh", flush=True)
    t0 = time.perf_counter()
    res = solve_terminal_pde(
        prob, alg, torch.Generator().manual_seed(0), trajectories=100, mesh=mesh,
        n_steps=20 if quick else 50,
        maxiters=1400 if quick else 2500,
        learning_rate=0.03, pabstol=1e-2, verbose=lead,
        adaptive=adaptive, sde_abstol=2e-2, sde_reltol=2e-2,
        max_refinements=1 if quick else 2,
    )
    wall = time.perf_counter() - t0
    if adaptive:
        print(f"adaptive grid: final n_steps = {res.n_steps}")

    t_mc = time.perf_counter()
    analytical = mc_analytical_hjb(prob.g, prob.x0, 1.0, LAM, torch.Generator().manual_seed(7))
    mc_s = time.perf_counter() - t_mc
    u0 = float(res.u0)
    rel_l2 = abs(u0 - analytical) / abs(u0)
    iters = len(res.losses)
    print(f"deep-BSDE u(0,0) = {u0:.4f}  (analytical MC {analytical:.4f})")
    print(f"rel L2 error = {rel_l2:.4f}  [reference asserts < 0.2]")
    print(f"training: {iters} iters in {wall:.1f}s ({wall / iters:.4f} s per iteration; "
          f"{res.s_per_iter:.4f} s over the last 50), final loss {float(res.losses[-1]):.4f}, "
          f"converged={res.converged}")
    out = dict(metric="hjb100d_rel_l2", value=rel_l2, unit="rel-L2", baseline=0.2,
               device=card_name(device), ranks=1 if mesh is None else mesh.size,
               quick=quick, adaptive=adaptive, u0=u0,
               analytical=analytical, iterations=iters, n_steps=res.n_steps,
               train_wall_s=wall, s_per_iter=wall / iters, s_per_iter_last50=res.s_per_iter,
               mc_s=mc_s, final_loss=float(res.losses[-1]), converged=res.converged)
    if device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if lead:
        print(json.dumps(out), flush=True)
    assert rel_l2 < 0.2, "HJB accuracy assertion failed"
    if plot and lead:
        write_plots(res.losses, u0, analytical, rel_l2)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="20 time steps and 1400 iterations (50 and 2500 without)")
    ap.add_argument("--plot", action="store_true",
                    help="write the loss figure to build/plots/highdim_pde/ (rank 0)")
    ap.add_argument("--adaptive", action="store_true",
                    help="error-controlled time grid (the LambaEM role): "
                         "AdaptiveEM pilot + pinned-grid refinement")
    ap.add_argument("--no-mesh", action="store_true",
                    help="no trajectory sharding over the job's ranks")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    _a = ap.parse_args()
    initialize_distributed(device=_a.device)
    main(quick=_a.quick, plot=_a.plot, adaptive=_a.adaptive,
         mesh=None if _a.no_mesh else "auto", device=_a.device)
