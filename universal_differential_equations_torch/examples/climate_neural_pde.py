"""Climate 1-D neural PDE on the port: a learned flux in a diffusion-advection column.

    python -m universal_differential_equations_torch.examples.climate_neural_pde
        [--quick] [--plot] [--device cuda]

The port of ``examples/climate/neural_pde.py`` (``Climate/NeuralPDE/npde.jl``)
with the same constants, in float32: ghost-node D1/D2 operators on a
32-level column (30 interior points) with their spectral radius feeding the
stabilized solvers (the reference's ``eigen_est`` hook), the Tsit5 truth of
the nonlinear flux Φ(u)=cos(sin u³ + sin cos u²) at rtol 1e-6, a 30→8→30
tanh network (518 parameters) learning the flux inside ``D1·NN(u) + D2·u``,
trained by ADAM(0.01) on the forward-sensitivity residual loss and then
Levenberg-Marquardt (``loss_tol`` 1e-4), the interpolating-adjoint loss and
gradient timed over 10 calls (the reference measured 0.879 s,
``Climate/NeuralPDE/timing.txt``), and the t = 10 rollouts of the trained
flux with ROCK4, RKC1(s=16) and ROCK2, which must land on one trajectory.

Every stage runs on ``--device`` (default ``cuda``; it raises where there is
no card — ``--device cpu`` must be asked for).  The initial weights come
from ``torch.Generator(0)``, seeded as the JAX script's key; it draws other
numbers than ``jax.random``.  ``--plot`` writes the JAX script's two figures
(the learned flux, the ROCK4 rollout) to ``build/plots/climate/``
(:func:`write_plots`); it needs matplotlib, imported before the truth.

Gates, as in the JAX script: the LM loss < 0.05; the RKC1 and ROCK2 rollouts
succeed within 5 % (relative L2) of ROCK4's.  The last line of the output is
a JSON object with the JAX script's keys (``loss``, ``adjoint_ms``,
``rock4_evals``, ``rock2_evals``) and the stage walls, step counts and gates.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch.examples.lv_scenario_1 import stopwatch
from universal_differential_equations_torch.flatten_util import tree_flatten
from universal_differential_equations_torch.models import climate_npde as cn
from universal_differential_equations_torch.utils import card_name, require_viz

F32 = torch.float32
PLOTS = Path(__file__).resolve().parents[2] / "build" / "plots" / "climate"
SEED = 0  # the JAX script's PRNGKey(0)
N_GRID = 32
T_END = 1.5
REFERENCE_ADJOINT_S = 0.879  # Climate/NeuralPDE/timing.txt


def problem(dtype=F32, device=None):
    """``(D1, D2, eig, u0, ts)``: the 32-level column's operators, the
    spectral radius of D2, the initial bump and the 30 save times."""
    D1, D2, eig = cn.getops(N_GRID, dtype=dtype, device=device)
    u0 = cn.get_u0(N_GRID, dtype, device)
    ts = torch.linspace(0.0, T_END, 30, dtype=dtype, device=device)
    return D1, D2, eig, u0, ts


def truth(D1, D2, u0, ts):
    """The Tsit5 truth at rtol 1e-6, atol 1e-8 (raises unless it succeeded)."""
    sol = ude.solve(ude.ODEProblem(cn.true_rhs, u0, (0.0, T_END), (D1, D2)), ude.Tsit5(),
                    saveat=ts, rtol=1e-6, atol=1e-8, adjoint=ude.NoAdjoint(), max_steps=4096)
    if not bool(sol.success):
        raise RuntimeError("the truth solve failed")
    return sol.ys


def make_residuals(rhs, u0, ts, data, D1, D2):
    """Trajectory residuals through forward sensitivities (≤ 1024 steps,
    rtol 1e-4): LM's Jacobians and ADAM's reverse sweep both go through the
    bounded stepping loop."""

    def residuals(p):
        sol = ude.solve(ude.ODEProblem(rhs, u0, (0.0, T_END), (p, D1, D2)), ude.Tsit5(),
                        saveat=ts, rtol=1e-4, atol=1e-6, adjoint=ude.ForwardSensitivity(),
                        max_steps=1024)
        return (sol.ys - data).reshape(-1)

    return residuals


def adjoint_loss(rhs, u0, ts, data, D1, D2, adjoint=None):
    """The timed loss: the squared misfit through the interpolating adjoint
    (``adjoint`` overrides it), differentiable in ``p`` and the operators,
    as in the JAX script."""
    adjoint = ude.InterpolatingAdjoint() if adjoint is None else adjoint

    def loss(p):
        sol = ude.solve(ude.ODEProblem(rhs, u0, (0.0, T_END), (p, D1, D2)), ude.Tsit5(),
                        saveat=ts, rtol=1e-4, atol=1e-6, adjoint=adjoint, max_steps=1024)
        return torch.sum((sol.ys - data) ** 2)

    return loss


def value_and_grad(loss, params):
    """``(loss, grads)`` of ``loss`` at ``params`` (a list of leaf dicts)."""
    leaves, build = tree_flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    val = loss(build(leaves))
    return val.detach(), torch.autograd.grad(val, leaves)


def train(residuals, params0, adam_steps, lm_iters):
    """ADAM(0.01) on Σr², then LM with ``loss_tol`` 1e-4: ``(warm, res)``."""
    def loss(p):
        r = residuals(p)
        return torch.sum(r * r)

    warm = ude.fit(loss, params0, lambda ps: torch.optim.Adam(ps, lr=0.01), adam_steps,
                   callback_every=100)
    res = ude.levenberg_marquardt(residuals, warm.params, maxiters=lm_iters, loss_tol=1e-4)
    return warm, res


def rollout(rhs, u0, params, D1, D2, solver, t_end=10.0):
    """A forward solve of the trained flux to ``t_end`` (rtol = atol = 1e-4,
    30 save points, ≤ 8192 steps)."""
    ts = torch.linspace(0.0, t_end, 30, dtype=u0.dtype, device=u0.device)
    return ude.solve(ude.ODEProblem(rhs, u0, (0.0, t_end), (params, D1, D2)), solver,
                     saveat=ts, rtol=1e-4, atol=1e-4, adjoint=ude.NoAdjoint(), max_steps=8192)


def rollout_solvers(eig):
    """The three stabilized solvers of the t = 10 rollouts, as the JAX
    script sizes them: ROCK4 and ROCK2 for 60 steps, RKC1 with 16 stages,
    each at 1.1 × the spectral radius."""
    return (ude.ROCK4.for_problem(eig * 1.1, (0.0, 10.0), n_steps_hint=60),
            ude.RKC1(stages=16, rho=float(eig) * 1.1),
            ude.ROCK2.for_problem(eig * 1.1, (0.0, 10.0), n_steps_hint=60))


def _dev(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def flux_curves(net, params, data):
    """The flux figure's curves over the visited state range (200 points
    from ``data``'s min to max, on ``params``' device): the net on constant
    profiles (its middle output) and Φ(u), each mean-centred, since the flux
    enters through D1 only and an additive constant is unobservable.
    Returns numpy ``(u, net flux, true flux)``."""
    uu = torch.linspace(float(data.min()), float(data.max()), 200, dtype=F32,
                        device=data.device)
    phi_true = torch.cos(torch.sin(uu**3) + torch.sin(torch.cos(uu**2))).cpu().numpy()
    with torch.no_grad():
        phi_net = net.apply(params, uu[:, None].expand(-1, N_GRID - 2))[:, 15].cpu().numpy()
    return uu.cpu().numpy(), phi_net - phi_net.mean(), phi_true - phi_true.mean()


def write_plots(curves, rollout_ys, outdir=None):
    """``npde.jl``'s figures: the learned flux against Φ(u) (``curves`` from
    :func:`flux_curves`) and the t = 10 ROCK4 rollout as a z-t field, into
    ``outdir`` (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    uu, phi_net, phi_true = curves
    viz.save(viz.plot_function_comparison(
        uu, phi_net, phi_true, labels=("NN flux", "Φ(u) truth"), xlabel="u",
        ylabel="flux (mean-centered)",
        title="learned nonlinear flux (up to the D1-null constant)"), outdir / "npde_flux.pdf")
    viz.save(viz.plot_field(rollout_ys.cpu().numpy().T, (0.0, 10.0, 0.0, 1.0),
                            title="neural-PDE rollout to t=10 (ROCK4)", ylabel="z",
                            cbar_label="u"), outdir / "npde_rollout.pdf")
    print(f"plots written to {outdir}")


def main(quick=False, device="cuda", plot=False, adam_steps=None, lm_iters=None,
         adjoint_calls=10):
    """The case study; ``adam_steps``/``lm_iters`` override the budgets
    (300/60, 100/20 with ``quick``) and ``adjoint_calls`` the number of timed
    adjoint gradients.  Raises ``RuntimeError`` after printing the result
    where a gate fails."""
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    adam_steps = (100 if quick else 300) if adam_steps is None else adam_steps
    lm_iters = (20 if quick else 60) if lm_iters is None else lm_iters
    walls, lap = stopwatch(device)
    D1, D2, eig, u0, ts = problem(device=device)
    rock4_train = ude.ROCK4.for_problem(eig * 1.1, (0.0, T_END), n_steps_hint=40)
    print(f"operators: 30 interior points, rho(D2)={eig:.1f}, ROCK4 stages="
          f"{rock4_train.stages} (reference: ROCK4 with eigen_est); {card_name(device)}")
    data = truth(D1, D2, u0, ts)
    lap("truth")

    rhs, params0, net = cn.make_neural_rhs(torch.Generator().manual_seed(SEED), device=device)
    residuals = make_residuals(rhs, u0, ts, data, D1, D2)
    warm, res = train(residuals, params0, adam_steps, lm_iters)
    loss = float(res.loss)
    print(f"training: adam {warm.final_loss:.4f} -> LM {loss:.6f} ({res.iterations} LM iters)")
    lap("train")

    # the adjoint loss+gradient, timed after one warm-up call
    vg = adjoint_loss(rhs, u0, ts, data, D1, D2)
    value_and_grad(vg, res.params)
    lap("adjoint_warmup")
    for _ in range(adjoint_calls):
        value_and_grad(vg, res.params)
    lap("adjoint_timed")
    per_eval = walls["adjoint_timed"] / adjoint_calls
    print(f"adjoint loss+gradient: {per_eval * 1e3:.1f} ms (reference measured "
          f"{REFERENCE_ADJOINT_S * 1e3:.0f} ms -> {REFERENCE_ADJOINT_S / per_eval:.2f}x)")

    # long-horizon rollouts with the stabilized solvers (npde.jl:121-123)
    rock4, rkc1, rock2 = rollout_solvers(eig)
    long = rollout(rhs, u0, res.params, D1, D2, rock4)
    finite = bool(torch.isfinite(long.ys).all())
    print(f"t=10 rollout with ROCK4(s={rock4.stages}): success={bool(long.success)}, "
          f"finite={finite}")
    long1 = rollout(rhs, u0, res.params, D1, D2, rkc1)
    dev1 = _dev(long1.ys, long.ys)
    print(f"t=10 rollout with RKC1(s=16): success={bool(long1.success)}, dev vs ROCK4 = "
          f"{dev1:.2e}, steps {int(long1.num_accepted)} vs ROCK4's {int(long.num_accepted)}")
    long2 = rollout(rhs, u0, res.params, D1, D2, rock2)
    dev2 = _dev(long2.ys, long.ys)
    print(f"t=10 rollout with ROCK2(s={rock2.stages}): success={bool(long2.success)}, dev vs "
          f"ROCK4 = {dev2:.2e}, RHS evals {int(long2.num_rhs_evals)} vs ROCK4's "
          f"{int(long.num_rhs_evals)} at equal tolerance")
    lap("rollouts")

    counts = {s.name: dict(accepted=int(sol.num_accepted), rejected=int(sol.num_rejected),
                           rhs_evals=int(sol.num_rhs_evals))
              for s, sol in ((rock4, long), (rkc1, long1), (rock2, long2))}
    gates = dict(loss=loss < 0.05, rkc1=bool(long1.success) and dev1 < 0.05,
                 rock2=bool(long2.success) and dev2 < 0.05)
    out = dict(loss=loss, adjoint_ms=per_eval * 1e3, rock4_evals=int(long.num_rhs_evals),
               rock2_evals=int(long2.num_rhs_evals), device=card_name(device), quick=quick,
               adam_loss=warm.final_loss, lm_iterations=res.iterations, walls=walls,
               total_s=sum(walls.values()), rollouts=counts, dev_rkc1=dev1, dev_rock2=dev2,
               rock4_finite=finite, gates=gates)
    if device.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    if not all(gates.values()):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"climate neural-PDE gate failed: {gates}")
    if plot:
        write_plots(flux_curves(net, res.params, data), long.ys)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="100 ADAM steps and ≤ 20 LM iterations (300 and ≤ 60 without)")
    ap.add_argument("--plot", action="store_true",
                    help="write the figures to build/plots/climate/")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device, plot=args.plot)), flush=True)
