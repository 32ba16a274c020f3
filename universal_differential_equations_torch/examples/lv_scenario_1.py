"""LV scenario 1 on the port: automated identification of nonlinear interactions.

    python -m universal_differential_equations_torch.examples.lv_scenario_1 [--quick] [--x64] \\
        [--plot] --device cuda

The port of ``examples/lotka_volterra/scenario_1.py`` (``scenario_1.jl`` end
to end), stage by stage with the same constants: truth at Vern7/1e-12 →
5e-3 mean-proportional noise → UDE with the 2→5→5→5→2 RBF MLP learning the
interaction terms → ADAM(0.1) in float32 → BFGS in float64, both through the
interpolating adjoint → SINDy (polynomial degree 5 + sin, STLSQ λ-ladder)
with simulation-validated selection → refit of the recovered parameters →
extrapolation to t = 50.

Every stage runs on ``--device`` (default ``cuda``; it raises where there is
no card — ``--device cpu`` must be asked for).  The JAX script moves its
float64 BFGS and SINDy sweeps to the host CPU because its accelerator has no
fast float64; the H100 has, so here they stay on the card.  The
stability-selection readout draws its row subsamples from
``torch.Generator(17)``, not ``jax.random``.

``--x64`` runs the whole script in float64 as the JAX script's ``--x64``
does: the net and ADAM in float64, then BFGS on ADAM's loss (rtol = atol =
1e-6) with gtol 1e-10 (:func:`training_losses`).  ``--plot`` writes the JAX
script's four figures to ``build/plots/lotka_volterra/``
(:func:`write_plots`); it needs matplotlib, imported before the data is made.

Without ``--quick`` the run must reach ``coef_err < 0.02`` and
``period_err < 0.1`` (``scenario_1.py:385``).  The last line of the output is
a JSON object with the stage wall times and the results.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch import sindy as sd
from universal_differential_equations_torch.core.integrate import integrate_fixed
from universal_differential_equations_torch.models import lotka_volterra as lv
from universal_differential_equations_torch.utils import card_name, require_viz

F32, F64 = torch.float32, torch.float64
SEED = 1234  # the reference's PRNGKey(1234)
SUB = 4  # fixed Tsit5 substeps per save interval in the refit judge
LAMS = tuple(10.0 ** e for e in np.arange(-3.0, 5.0, 0.05))  # exp10.(-3:5)
PLOTS = Path(__file__).resolve().parents[2] / "build" / "plots" / "lotka_volterra"


def stopwatch(device):
    """``(walls, lap)``: ``lap(name)`` records the seconds since the last lap
    (after the device's queue drains) under ``name`` and prints them."""
    walls, clock = {}, [time.perf_counter()]

    def lap(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        walls[name] = now - clock[0]
        clock[0] = now
        print(f"[{name}] {walls[name]:.2f} s", flush=True)

    return walls, lap


def scenario_basis():
    """The candidate library: polynomials to degree 5 in (x, y), plus sin."""
    return sd.polynomial_basis(2, 5) + sd.sin_basis(2)


def make_loss(rhs, X, ts, tol):
    """The training loss: mean squared error of the UDE's solve against ``X``
    at ``ts``, through the interpolating adjoint at rtol = atol = ``tol``."""
    prob = ude.ODEProblem(rhs, X[0], (0.0, float(ts[-1])))

    def loss(p):
        sol = ude.solve(ude.remake(prob, args=p), ude.Tsit5(), saveat=ts,
                        rtol=tol, atol=tol, adjoint=ude.InterpolatingAdjoint())
        return torch.mean((sol.ys - X) ** 2)

    return loss


def training_losses(rhs, ts64, X64, x64, quick=False):
    """The two training stages' losses and BFGS options, from the float64
    data: ADAM's loss at rtol = atol = 1e-6 in float32 (float64 with
    ``x64``); BFGS in float64, on the loss at 1e-8 with gtol 1e-12 (1e-10
    with ``quick``), or with ``x64`` on ADAM's loss with gtol 1e-10, as the
    JAX script's ``--x64`` run.  Returns ``(adam_loss, bfgs_loss,
    bfgs_kw)``."""
    dtype = F64 if x64 else F32
    adam_loss = make_loss(rhs, X64.to(dtype), ts64.to(dtype), 1e-6)
    if x64:
        return adam_loss, adam_loss, dict(gtol=1e-10)
    return (adam_loss, make_loss(rhs, X64, ts64, 1e-8),
            dict(gtol=1e-10 if quick else 1e-12))


def candidate_rhs(basis):
    """The known growth and decay plus a candidate's interaction terms
    ``θ(u) @ C``: ``u`` (2,) with ``C`` (m, 2), or lanes ``u`` (S, 2) with
    ``C`` (S, m, 2), one candidate per lane."""
    alpha, delta = float(lv.P_TRUE[0]), float(lv.P_TRUE[3])

    def rhs(t, u, C):
        term = torch.einsum("...m,...md->...d", basis.theta(u), C)
        return torch.stack([alpha * u[..., 0] + term[..., 0],
                            -delta * u[..., 1] + term[..., 1]], -1)

    return rhs


def judge_loss(basis, u0, X, ts, mask):
    """The refit judge's loss over fixed-step Tsit5 (``SUB`` substeps per
    save interval), each candidate's coefficients masked to its support:
    ``C`` (m, 2) gives a scalar, lanes ``C`` (S, m, 2) give (S,)."""
    rhs, n_sub, t1 = candidate_rhs(basis), (len(ts) - 1) * SUB, float(ts[-1])

    def loss(C):
        y0 = u0 if C.dim() == 2 else u0.expand(C.shape[0], 2)
        _, ys = integrate_fixed(rhs, y0, 0.0, t1, C * mask, ude.Tsit5(), n_sub)
        return ((ys[..., ::SUB, :] - X) ** 2).mean(dim=(-2, -1))

    return loss


def refit(rec_rhs, p0, u0, X, ts, maxiters):
    """BFGS refit of the recovered parameters on the data
    (``scenario_1.jl:183-191``)."""

    def loss_rec(p):
        sol = ude.solve(ude.ODEProblem(rec_rhs, u0, (0.0, float(ts[-1])), p), ude.Tsit5(),
                        saveat=ts, rtol=1e-6, atol=1e-6)
        return torch.mean((sol.ys - X) ** 2)

    res = ude.bfgs_minimize(loss_rec, p0, maxiters=maxiters)
    # an under-trained quick run can hand SINDy a dense, unstable model whose
    # refit diverges — keep the pre-refit coefficients in that case
    if not bool(torch.isfinite(res.value)):
        res = res._replace(params=p0, value=loss_rec(p0).detach())
    return res


def mean_period(ts, ys):
    """Mean spacing of the first component's peaks."""
    x, t = ys[:, 0].cpu().numpy(), ts.cpu().numpy()
    pk = np.nonzero((x[1:-1] > x[:-2]) & (x[1:-1] > x[2:]))[0]
    return float(np.diff(t[pk + 1]).mean())


def extrapolate(rec_rhs, p, u0):
    """The recovered model and the truth from ``u0`` to t = 50
    (``scenario_1.jl:200-207``): ``(ys_rec, period_rec, period_truth)``.
    Raises unless both solves finished: a clamped tail would pass the
    finite/period checks untested."""
    ts_ex, ys_rec, ys_truth = extrapolation_solves(rec_rhs, p, u0)
    return ys_rec, mean_period(ts_ex, ys_rec), mean_period(ts_ex, ys_truth)


def extrapolation_solves(rec_rhs, p, u0):
    """:func:`extrapolate`'s two solves on 501 points of [0, 50]: ``(ts_ex,
    ys_rec, ys_truth)``."""
    ts_ex = torch.linspace(0.0, 50.0, 501, dtype=F64, device=u0.device)
    sol_ex = ude.solve(ude.ODEProblem(rec_rhs, u0, (0.0, 50.0), p), ude.Tsit5(),
                       saveat=ts_ex, rtol=1e-8, atol=1e-8, adjoint=ude.NoAdjoint())
    if not bool(sol_ex.success):
        raise RuntimeError("recovered-model t=50 solve did not finish")
    sol_truth = ude.solve(
        ude.ODEProblem(lv.lotka_rhs, u0, (0.0, 50.0), lv.P_TRUE.to(u0.device)), ude.Tsit5(),
        saveat=ts_ex, rtol=1e-10, atol=1e-10, adjoint=ude.NoAdjoint(), max_steps=16384)
    if not bool(sol_truth.success):
        raise RuntimeError("t=50 truth solve did not converge")
    return ts_ex, sol_ex.ys, sol_truth.ys


def write_plots(ts, X_hat, X_noisy, nn_out, adam_losses, ts_ex, truth_ex, rec_ex, t1f,
                outdir=None):
    """``scenario_1.jl``'s figures (trajectory fit, missing terms, ADAM's
    losses, the t = 50 forecast) into ``outdir`` (``PLOTS``)."""
    from universal_differential_equations_torch import viz

    outdir = Path(PLOTS if outdir is None else outdir)
    P, xy = lv.P_TRUE.to(X_hat), X_hat[:, 0] * X_hat[:, 1]
    true_terms = torch.stack([-P[1] * xy, P[2] * xy], -1)
    viz.save(viz.plot_timeseries(
        ts, X_hat, labels=["x (UDE)", "y (UDE)"], data=X_noisy, data_label="noisy data",
        title="UDE approximation of the Lotka-Volterra data", ylabel="population"),
        outdir / "scenario_1_fit.pdf")
    viz.save(viz.plot_function_comparison(
        ts, nn_out, true_terms, labels=("NN", "true"), xlabel="t",
        title="learned missing interaction terms"), outdir / "scenario_1_missing_term.pdf")
    viz.save(viz.plot_loss_history(adam_losses, title="ADAM stage loss"),
             outdir / "scenario_1_loss.pdf")
    fig = viz.plot_timeseries(ts_ex, truth_ex, labels=["x (truth)", "y (truth)"],
                              title="recovered model extrapolated to t = 50",
                              ylabel="population", train_end=t1f)
    ax = fig.axes[0]
    ts_ex, rec_ex = ts_ex.cpu().numpy(), rec_ex.cpu().numpy()
    for i in range(2):
        ax.plot(ts_ex, rec_ex[:, i], linestyle="--", linewidth=1.2, color=viz.SERIES[i],
                alpha=0.9)
    viz.save(fig, outdir / "scenario_1_extrapolation.pdf")
    print(f"plots written to {outdir}")


def main(quick=False, device="cuda", plot=False, x64=False):
    if plot:
        require_viz()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    walls, lap = stopwatch(device)
    gen = torch.Generator().manual_seed(SEED)

    # -- data generation (scenario_1.jl:40-53): float64 at the reference's 1e-12
    ts64, X_true, X_noisy64 = lv.generate_data(gen, device=device)
    t1f = float(ts64[-1])
    print(f"data: {X_noisy64.shape[0]} samples on t∈[0, {t1f}]"
          + (" (float64 throughout)" if x64 else ""))
    lap("data")

    # -- UDE definition (scenario_1.jl:59-73)
    rhs, params0, net = lv.make_ude(gen, dtype=F64 if x64 else F32, device=device)

    # -- two-stage training (scenario_1.jl:111-118): ADAM in float32, then
    # BFGS in float64 at rtol = atol = 1e-8 (the reference's dtype); with
    # x64 both in float64 on ADAM's loss
    adam_loss, bfgs_loss, bfgs_kw = training_losses(rhs, ts64, X_noisy64, x64, quick)
    res1 = ude.fit(adam_loss, params0,
                   lambda ps: torch.optim.Adam(ps, lr=0.1), 100 if quick else 200,
                   callback=lambda s, l, p: print(f"  adam step {s}: loss {l:.6f}"),
                   callback_every=50)
    lap("adam")
    p64 = [{k: v.double() for k, v in layer.items()} for layer in res1.params]
    res2 = ude.bfgs_minimize(bfgs_loss, p64, maxiters=300 if quick else 2000,
                             initial_stepnorm=0.01, **bfgs_kw)
    print(f"training: adam final {res1.final_loss:.6f} → bfgs {float(res2.value):.8f} "
          f"in {int(res2.iterations)} iterations, {int(res2.num_evals)} evaluations")
    lap("bfgs")

    # -- SINDy recovery on the learned interactions (scenario_1.jl:155-172):
    # candidate supports from a cv-tolerance ladder plus exhaustive small-
    # support least squares, window re-simulation of every pair, then a
    # refit judge (see the JAX script for why statistics alone over-select)
    u0 = X_noisy64[0]
    sol_hat = ude.solve(ude.ODEProblem(rhs, u0, (0.0, t1f), res2.params), ude.Tsit5(),
                        saveat=ts64, rtol=1e-6, atol=1e-6, adjoint=ude.NoAdjoint())
    X_hat = sol_hat.ys
    nn_out = net.apply(res2.params, X_hat)
    basis = scenario_basis()
    problem = sd.DirectDataDrivenProblem(X_hat, nn_out)
    base = sd.sindy(problem, basis, sd.STLSQ(LAMS), normalize=True,
                    sampler=sd.DataSampler(n=4, shuffle=True))
    ladder = [base] + [
        sd.sindy(problem, basis, sd.STLSQ(LAMS), normalize=True,
                 sampler=sd.DataSampler(n=4, shuffle=True), cv_tolerance=tol)
        for tol in (25.0, 100.0)
    ]
    m = len(basis)
    opts = [[], []]  # (support, (m,) coefficient column) per equation
    for r in ladder:
        for e in (0, 1):
            kk = tuple(np.nonzero(r.active[:, e])[0].tolist())
            if kk and kk not in [o[0] for o in opts[e]]:
                opts[e].append((kk, r.coefficients[:, e]))
    # every 1-term least-squares fit plus the best 2-term fits, each one
    # batched least-squares call on the device
    theta_f = basis.theta(X_hat)
    for e in (0, 1):
        for k in (1, 2):
            combs = list(itertools.combinations(range(m), k))
            A = theta_f[:, torch.as_tensor(combs, device=device)].permute(1, 0, 2)
            y = nn_out[:, e].expand(len(combs), -1)[..., None]
            coef = torch.linalg.lstsq(A, y).solution
            rss = ((A @ coef - y) ** 2).sum(dim=(1, 2)).cpu().numpy()
            coef = coef[..., 0].cpu().numpy()
            ranked = sorted(zip(rss.tolist(), combs, range(len(combs))))
            # keep candidates that fit the learned term: within 9× of the best
            rss_best = max(ranked[0][0], 1e-30)
            for r_ss, comb, j in ranked[:8]:
                if r_ss <= 9.0 * rss_best and comb not in [o[0] for o in opts[e]]:
                    col = np.zeros(m)
                    col[list(comb)] = coef[j]
                    opts[e].append((comb, col))
    lap("sindy")

    # -- window simulation of every candidate pair
    data_scale = float(X_noisy64.abs().max())
    dense_rhs = candidate_rhs(basis)
    pairs = [(k1, c1, k2, c2) for k1, c1 in opts[0] for k2, c2 in opts[1]]
    Cs = torch.as_tensor(np.stack([np.stack([c1, c2], -1) for _, c1, _, c2 in pairs]),
                         dtype=F64, device=device)
    rels = []
    for C in Cs:
        sol_c = ude.solve(ude.ODEProblem(dense_rhs, u0, (0.0, t1f), C), ude.Tsit5(),
                          saveat=ts64, rtol=1e-6, atol=1e-6, adjoint=ude.NoAdjoint(),
                          max_steps=1024)
        rel = float((sol_c.ys - X_noisy64).abs().max()) / data_scale
        rels.append(rel if bool(sol_c.success) and np.isfinite(rel) else np.inf)
    lap("windows")

    # -- refit judge: one lane-batched BFGS over the shortlisted pairs, each
    # lane's coefficients masked to its support (a wrong structure stalls far
    # above the noise floor once its coefficients are fit to the data)
    order = np.argsort([(len(p[0]) + len(p[2])) + min(r, 1.0) for p, r in zip(pairs, rels)])
    short = [i for i in order if np.isfinite(rels[i])
             and len(pairs[i][0]) + len(pairs[i][2]) <= 6][:16]
    if not short:
        raise RuntimeError("no candidate pair simulated the training window — "
                           "train longer (run without --quick)")
    C0 = Cs[torch.as_tensor(short, device=device)]
    lanes_loss = judge_loss(basis, u0, X_noisy64, ts64, (C0 != 0.0).to(F64))
    judged = ude.bfgs_minimize_lanes(lanes_loss, C0, maxiters=150, initial_stepnorm=0.01)
    refit_losses = judged.value.cpu().numpy()
    lap("judge")

    scored = []
    for j, i in enumerate(short):
        k1, col1, k2, col2 = pairs[i]
        scored.append((len(k1) + len(k2), float(refit_losses[j]), float(rels[i]), (col1, col2)))
    print("shortlist (k, refit loss, window rel): "
          f"{sorted((s[0], float(f'{s[1]:.3g}'), round(s[2], 3)) for s in scored)[:10]}")
    best_loss = min(s[1] for s in scored)
    fitting = [s for s in scored if s[1] <= 3.0 * best_loss]
    k_sel, loss_sel, rel_sel, (col1, col2) = min(fitting, key=lambda s: (s[0], s[1]))
    coefs = np.stack([col1, col2], -1)
    res_sindy = dataclasses.replace(base, coefficients=coefs, active=coefs != 0.0,
                                    sparsity=(coefs != 0.0).sum(axis=0))
    print(f"selection: {k_sel} active terms, refit loss {loss_sel:.3g}, window rel "
          f"{rel_sel:.3f} ({len(pairs)} pairs, {len(short)} refit)")
    print("recovered interactions:")
    for eq in res_sindy.equations():
        print("  " + eq)

    # structure-uncertainty readout (diagnostic only, scenario_1.py:299-319):
    # subsample selection frequencies over the same (Θ(X̂), ŷ) regression, in
    # float64 like the port's other sweeps (the JAX script's is float32)
    stab_gen = torch.Generator().manual_seed(17)
    stab_lams = tuple(10.0 ** ee for ee in np.arange(-3.0, 2.0, 0.25))
    for e in (0, 1):
        freq = sd.stability_selection(theta_f, nn_out[:, e], sd.STLSQ(stab_lams), stab_gen,
                                      n_subsets=64, frac=0.7, max_support=4).cpu().numpy()
        act = np.nonzero(res_sindy.active[:, e])[0]
        tops = np.argsort(-freq)[:3]
        print(f"  eq{e + 1} subsample stability: selected "
              + ", ".join(f"{basis.names[i]}={freq[i]:.2f}" for i in act)
              + " | most stable library terms: "
              + ", ".join(f"{basis.names[i]}={freq[i]:.2f}" for i in tops))

    # -- refit the recovered parameters on the data (scenario_1.jl:183-191)
    if res_sindy.parameters().size == 0:
        raise RuntimeError("SINDy recovered an empty model — train longer "
                           "(run without --quick)")
    rec_rhs = lv.make_recovered_rhs(res_sindy)
    p_rec0 = torch.as_tensor(res_sindy.parameters(), dtype=F64, device=device)
    res3 = refit(rec_rhs, p_rec0, u0, X_noisy64, ts64, maxiters=200)
    print(f"refit: loss {float(res3.value):.8f}, params {res3.params.cpu().numpy()}")
    print(f"true interaction coefficients: [-{float(lv.P_TRUE[1])}, "
          f"+{float(lv.P_TRUE[2])}] (β, γ for the x·y terms)")
    lap("refit")

    # -- extrapolation to t = 50 (scenario_1.jl:200-207).  The identifiable
    # quantities: coefficients at the noise limit and the oscillation period
    # (the far-lobe amplitude is not identifiable from this window; see the
    # JAX script)
    ts_ex, ys_ex, truth_ex = extrapolation_solves(rec_rhs, res3.params, u0)
    per_rec, per_tru = mean_period(ts_ex, ys_ex), mean_period(ts_ex, truth_ex)
    coef_err = float(np.max(np.abs(
        res3.params[:2].cpu().numpy() / np.array([-float(lv.P_TRUE[1]),
                                                  float(lv.P_TRUE[2])]) - 1.0)))
    finite = bool(torch.isfinite(ys_ex).all())
    period_err = abs(per_rec - per_tru) / per_tru
    print(f"extrapolation to t=50 (both solves finished): finite={finite}, "
          f"coefficient err {coef_err:.3%}, period {per_rec:.2f} vs truth {per_tru:.2f} "
          f"({period_err:.2%} off)")
    lap("extrapolation")
    if not quick and not (finite and coef_err < 0.02 and period_err < 0.1):
        raise RuntimeError(f"scenario 1 gate failed: finite={finite}, coef_err={coef_err}, "
                           f"period_err={period_err}")
    if plot:
        write_plots(ts64, X_hat, X_noisy64, nn_out, res1.losses, ts_ex, truth_ex, ys_ex, t1f)
    return dict(
        device=card_name(device), quick=quick, x64=x64, walls=walls,
        total_s=sum(walls.values()),
        adam_loss=res1.final_loss, bfgs_loss=float(res2.value),
        bfgs_iterations=int(res2.iterations), bfgs_evals=int(res2.num_evals),
        pairs=len(pairs), judged=len(short), equations=res_sindy.equations(),
        refit_loss=float(res3.value), coef_err=coef_err, period_err=period_err,
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="100 ADAM steps and 300 BFGS iterations; no accuracy gate")
    ap.add_argument("--x64", action="store_true",
                    help="the whole script in float64 (ADAM included; BFGS on ADAM's loss)")
    ap.add_argument("--plot", action="store_true",
                    help="write the figures to build/plots/lotka_volterra/")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device, plot=args.plot, x64=args.x64)),
          flush=True)
