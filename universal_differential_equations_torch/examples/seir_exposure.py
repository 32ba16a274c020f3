"""SEIR exposure on the port: neural ODE vs UDE vs SINDy-recovered exposure.

    python -m universal_differential_equations_torch.examples.seir_exposure [--quick] --device cuda

The port of ``examples/seir_exposure/seir_exposure.py`` (``seir_exposure.jl``
end to end), stage by stage with the same constants: the 21-day truth at
Vern7/1e-10 with 1e-7 noise → (a) the black-box neural ODE on 5 equations
and (b) the UDE learning only the quarantine exposure term, both trained by
ADAM(0.01) then BFGS restart rounds through the interpolating adjoint in
per-state O(1) units (``rescale_problem``) → the exposure reconstruction →
the ideal-recovery SINDy (cos + sin + tensor polynomials) → the UDE arm (a
CV parsimony ladder judged by re-simulation with coefficient refits) → the
training-free weak-form arm (the same judge on weak-form rows) → both
recovered models extrapolated from day 21 to day 60.

Every stage runs on ``--device`` (default ``cuda``; it raises where there is
no card — ``--device cpu`` must be asked for).  The training, the SINDy
stages, the ladders and the judges run in float32, as the JAX script's do;
the truths run in float64.  The noise and the initial weights come from
``torch.Generator``s seeded as the JAX script's keys (10, 1, 2); they draw
other numbers than ``jax.random``.  ``train_variant(polish=True)``, off by
default as in the JAX script, finishes the BFGS in float64 on the same
device.  Left out: the plots.

The gates are the JAX script's: both truth solves succeed, and without
``--quick`` both arms' day-60 solves finish with relative error < 0.15 on
E, I, R.  The last line of the output is a JSON object with the stage wall
times and the gates.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch import sindy as sd
from universal_differential_equations_torch.examples.hudson_bay import cast
from universal_differential_equations_torch.examples.lv_scenario_1 import _card, stopwatch
from universal_differential_equations_torch.flatten_util import ravel_pytree
from universal_differential_equations_torch.models import seir
from universal_differential_equations_torch.utils import rescale_problem

F32, F64 = torch.float32, torch.float64
# E, I, R, D, C live ~5 decades below S, N after population normalization;
# solve in per-state O(1) units (an exact transform) so float32 works
SCALES = (1.0, 1e5, 1e5, 1e5, 1.0, 1e5, 1e5)
LAMS = tuple(10.0 ** e for e in np.arange(-6.0, 1.0, 0.1))
SUB = 8  # fixed Tsit5 substeps per day in the refit judge
WIDTHS = (13, 17, 21)  # the weak arm's test-function windows
SEEDS = dict(noise=10, neural_ode=1, exposure_ude=2)  # the JAX script's keys


def scales(like):
    """``SCALES`` as a tensor of ``like``'s dtype and device."""
    return torch.tensor(SCALES, dtype=like.dtype, device=like.device)


def _truth_solve(t_end, dtype, device, **kw):
    ts = torch.arange(0.0, t_end + 0.1, 1.0, dtype=dtype, device=device)
    sol = ude.solve(ude.ODEProblem(seir.corona_rhs, seir.U0_NORM.to(ts), (0.0, t_end),
                                   seir.P_SEIR.to(ts)),
                    ude.Vern7(), saveat=ts, rtol=1e-10, atol=1e-12, adjoint=ude.NoAdjoint(),
                    **kw)
    if not bool(sol.success):
        raise RuntimeError(f"SEIR truth solve to day {t_end:g} did not converge")
    return ts, sol.ys


def truth(noise, dtype=F64, device=None):
    """The 21-day truth: Vern7 at rtol 1e-10, atol 1e-12 with steps on the
    daily save grid, raising unless the solve succeeded.

    ``noise`` is a ``torch.Generator`` that draws the standard normals on the
    CPU, or an array of such draws (shape (22, 7)).  Returns ``(ts, X,
    data)`` with ``data = X + 1e-7 · draws``.
    """
    ts, X = _truth_solve(21.0, dtype, device, step_to_saveat=True)
    if isinstance(noise, torch.Generator):
        draws = torch.randn(X.shape, generator=noise, dtype=F64)
    else:
        draws = torch.tensor(np.asarray(noise))
    return ts, X, X + 1e-7 * draws.to(X)


def make_loss(rhs, ts, data, rtol=1e-6, atol=1e-7, adjoint=None):
    """The training loss (``seir_exposure.jl:77-96``): mean squared error of
    the rescaled E, I, R rows against ``data``, through the interpolating
    adjoint by default."""
    s = scales(data)
    prob = rescale_problem(ude.ODEProblem(rhs, seir.U0_NORM.to(data), (0.0, float(ts[-1]))), s)
    data_s = data * s
    adjoint = ude.InterpolatingAdjoint() if adjoint is None else adjoint

    def loss(p):
        sol = ude.solve(ude.remake(prob, args=p), ude.Tsit5(), saveat=ts, rtol=rtol,
                        atol=atol, adjoint=adjoint)
        return torch.mean((sol.ys[:, 1:4] - data_s[:, 1:4]) ** 2)

    return loss


def train_variant(tag, rhs, params0, ts, data, quick, polish=False, adam_steps=None,
                  bfgs_iters=None, rounds=None):
    """ADAM(0.01) → BFGS on the E, I, R rows (``seir_exposure.jl:77-96``).

    BFGS runs in restart rounds (a fresh Hessian at a stalled point), which
    stop once a round improves the loss by less than 1 %.  The budgets
    default to the JAX script's (``quick``: 200 ADAM steps, one round of ≤ 200
    iterations; else 500 steps and ≤ 5 rounds of ≤ 250); ``adam_steps``,
    ``bfgs_iters`` and ``rounds`` override them.  ``polish=True`` (off by
    default) replaces the rounds, without ``quick`` and for float32
    parameters, by one BFGS run in float64 at rtol 1e-8 on the same device
    (≤ 1500 iterations unless ``bfgs_iters`` says otherwise).  Returns
    ``(params, info)`` with the stage losses and walls.
    """
    dtype = ravel_pytree(params0)[0].dtype
    polish = polish and not quick and dtype == F32
    adam_steps = (200 if quick else 500) if adam_steps is None else adam_steps
    if bfgs_iters is None:
        bfgs_iters = 1500 if polish else 200 if quick else 250
    rounds = (1 if quick else 5) if rounds is None else rounds
    info = {}
    t0 = time.perf_counter()
    loss = make_loss(rhs, ts.to(dtype), data.to(dtype))
    r1 = ude.fit(loss, params0, lambda ps: torch.optim.Adam(ps, lr=0.01), adam_steps,
                 callback_every=250)
    info["adam_loss"] = r1.final_loss
    info["adam_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if polish:
        loss64 = make_loss(rhs, ts.to(F64), data.to(F64), rtol=1e-8, atol=1e-9)
        r2 = ude.bfgs_minimize(loss64, cast(r1.params, F64), maxiters=bfgs_iters,
                               initial_stepnorm=0.01, gtol=1e-14)
        params = cast(r2.params, F32)
        info.update(bfgs_loss=float(r2.value), bfgs_iterations=int(r2.iterations),
                    bfgs_evals=int(r2.num_evals), bfgs_rounds=1, bfgs_float64=True)
    else:
        params, best, iters, evals, done = r1.params, float("inf"), 0, 0, 0
        for _ in range(rounds):
            r2 = ude.bfgs_minimize(loss, params, maxiters=bfgs_iters, initial_stepnorm=0.01)
            params = r2.params
            iters += int(r2.iterations)
            evals += int(r2.num_evals)
            done += 1
            v = float(r2.value)
            if v >= 0.99 * best:
                break
            best = v
        info.update(bfgs_loss=float(r2.value), bfgs_iterations=iters, bfgs_evals=evals,
                    bfgs_rounds=done)
    info["bfgs_s"] = time.perf_counter() - t0
    print(f"{tag}: adam {info['adam_loss']:.3e} → bfgs {info['bfgs_loss']:.3e} "
          f"({info['bfgs_iterations']} iterations, {info['bfgs_evals']} evaluations; "
          f"{info['adam_s'] + info['bfgs_s']:.0f} s)", flush=True)
    return params, info


def scenario_basis():
    """The exposure library (``seir_exposure.jl:191-201``): cos and sin of the
    three features and the tensor grid of their powers ≤ 2 (33 terms)."""
    return sd.cos_basis(3) + sd.sin_basis(3) + sd.tensor_polynomial_basis(3, 2)


def exposure_features(X):
    """The model's scaled coordinates [S/N, 1e5·I, 1e5·D/N] of states (..., 7)."""
    return torch.stack([X[..., 0] / X[..., 4], 1e5 * X[..., 2], 1e5 * X[..., 5] / X[..., 4]], -1)


def reconstruct(rhs_ude, net, p_ude, ts, data):
    """The exposure reconstruction (``seir_exposure.jl:191-210``): the trained
    UDE's trajectory ``Xh``, its features, and the net's scaled exposure
    ``L_hat`` along it, beside the true scaled exposure ``L_true`` on the
    data.  Returns a dict of those tensors."""
    s = scales(data)
    sol = ude.solve(rescale_problem(ude.ODEProblem(rhs_ude, seir.U0_NORM.to(data),
                                                   (0.0, float(ts[-1])), p_ude), s),
                    ude.Tsit5(), saveat=ts, rtol=1e-6, atol=1e-7, adjoint=ude.NoAdjoint())
    Xh = sol.ys / s
    feats_h = exposure_features(Xh)
    return dict(feats=exposure_features(data), L_true=1e5 * seir.true_exposure(data),
                Xh=Xh, feats_h=feats_h, L_hat=net.apply(p_ude, feats_h)[..., 0])


def ideal_recovery(feats, L_true, basis):
    """SINDy on the true exposure (``seir_exposure.jl:222-228``), skipping the
    early zero-state samples as the reference does."""
    return sd.sindy(sd.DirectDataDrivenProblem(feats[4:], L_true[4:, None]), basis,
                    sd.STLSQ(LAMS), normalize=True, exhaustive_k=2)


def small_supports(m):
    """Every 1- and 2-term support of ``m`` features, (m + m(m−1)/2, m) bool."""
    pairs = [[i in c for i in range(m)] for c in itertools.combinations(range(m), 2)]
    return np.concatenate([np.eye(m, dtype=bool), np.asarray(pairs, dtype=bool)])


def ladder(theta, y, extra):
    """Two candidates per support size 1..4 (on this window sin(u2) nearly
    aliases the true ~0.31·u2 exposure, so the runner-up must reach the
    judge), with every 1- and 2-term support fit exhaustively."""
    return sd.cv_ladder(theta, y, sd.STLSQ(LAMS), 4, per_size=2, extra_supports=extra)


def dense_rhs(basis, like):
    """The full SEIR with the recovered exposure z = 1e-5·Θ(features)·ξ, in
    the per-state O(1) solve units, for lanes: ``u`` (L, 7), ``C`` (L, m, 1),
    one model per lane (the JAX script's ``dense_rhs`` takes one lane)."""
    s = scales(like)

    def f(t, us, C):
        u = us / s
        z = 1e-5 * torch.einsum("...m,...m->...", basis.theta(exposure_features(u)), C[..., 0])
        return seir.exposure_rhs(u, z) * s

    return f


def judge(lad, basis, ts, data, refit_iters=100):
    """The refit simulation judge (``sindy.select_by_simulation``) over a
    ``per_size=2`` ladder: every rung's coefficients refit by ≤
    ``refit_iters`` BFGS iterations against the rescaled trajectory, then the
    sparsest within 1.5× of the best refit loss (floor 1e-4, the noise's MSE
    ~7e-5).  Returns ``(C_sel, refit_loss, k_sel)``."""
    s = scales(data)
    return sd.select_by_simulation(
        [lad], dense_rhs(basis, data), seir.U0_NORM.to(data) * s, 0.0, float(ts[-1]),
        data * s, ude.Tsit5(), (len(ts) - 1) * SUB, sub=SUB, rel_factor=1.5,
        refit_iters=refit_iters, loss_floor=1e-4, max_total_support=4,
        sizes=[torch.arange(1, 5, device=data.device).repeat_interleave(2)], refit_all=True)


def known_no_z(u):
    """The known SEIR physics without the exposure z, per sample ``u`` (7,)."""
    return seir.exposure_rhs(u, torch.zeros_like(u[..., 0]))


def weak_rows(ts, data, basis):
    """The weak-form arm's regression (``seir_exposure.py:233-263``): z enters
    dE with +, every known term moves to the target side, and the E row's
    weak equations (the S row's quadrature bias dwarfs z) form the pair
    ``(G, 1e5·B_E)``."""
    G, B = sd.weak_pair(ts, data, basis, known_no_z, widths=WIDTHS, p=5,
                          features=exposure_features)
    return G, B[:, 1] * 1e5


def as_result(template, C_sel):
    """A ``SINDyResult`` carrying the judge's coefficients ``C_sel`` (m, 1)."""
    C = C_sel.detach().cpu().numpy()
    act = C[:, 0] != 0.0
    return dataclasses.replace(template, coefficients=C, active=act[:, None],
                               sparsity=np.asarray([act.sum()]))


def truth60(dtype=F64, device=None):
    """The day-60 truth ``(ts60, X60)`` (Vern7, rtol 1e-10, atol 1e-12, ≤ 16384
    steps), raising unless the solve succeeded."""
    return _truth_solve(60.0, dtype, device, max_steps=16384)


def extrapolate(res, truth60):
    """The recovered model from day 0 to day 60 (``seir_exposure.jl:248-253``)
    against ``truth60`` (``(ts60, X60)`` from :func:`truth60`): ``(ys,
    success, rel err on E, I, R)``, the error relative to the truth's
    largest E, I, R value."""
    ts60, X60 = truth60
    s = scales(X60)
    sol = ude.solve(rescale_problem(ude.ODEProblem(
        seir.make_recovered_rhs(res), seir.U0_NORM.to(X60), (0.0, 60.0),
        torch.as_tensor(res.parameters(), dtype=X60.dtype, device=X60.device)), s),
        ude.Tsit5(), saveat=ts60, rtol=1e-6, atol=1e-8, adjoint=ude.NoAdjoint())
    ys = sol.ys / s
    err = float((ys[:, 1:4] - X60[:, 1:4]).abs().max() / X60[:, 1:4].abs().max())
    return ys, bool(sol.success), err


def neural_ode_arm(ts, data, quick, device):
    """Variant (a), the black-box neural ODE, trained (its result feeds no
    later stage).  Returns ``train_variant``'s info."""
    rhs, p0, _ = seir.make_neural_ode(torch.Generator().manual_seed(SEEDS["neural_ode"]),
                                      device=device)
    return train_variant("neural ODE", rhs, p0, ts, data, quick)[1]


def exposure_ude_arm(ts, data, quick, device):
    """Variant (b), the exposure UDE, trained: ``(rhs, net, params, info)``."""
    rhs, p0, net = seir.make_exposure_ude(torch.Generator().manual_seed(SEEDS["exposure_ude"]),
                                          device=device)
    params, info = train_variant("exposure UDE", rhs, p0, ts, data, quick)
    return rhs, net, params, info


def recovery_arms(rhs_ude, net, p_ude, ts, data, lap):
    """The SINDy triad on the trained exposure UDE (``seir_exposure.jl:191-228``):
    the ideal recovery, the UDE arm and the weak-form arm, and both arms'
    day-60 extrapolations, on the float32 ``ts``, ``data``.  Returns a dict
    of the results."""
    basis = scenario_basis()
    rc = reconstruct(rhs_ude, net, p_ude, ts, data)
    print(f"exposure reconstruction (scaled units): max |L̂-L| = "
          f"{float((rc['L_hat'] - rc['L_true']).abs().max()):.2e} "
          f"(signal scale {float(rc['L_true'].abs().max()):.2e})")
    res_ideal = ideal_recovery(rc["feats"], rc["L_true"], basis)
    print("ideal-recovery:", res_ideal.equations("dz")[0][:100])
    lap("ideal_sindy")

    # the UDE arm: a CV ladder on the net's exposure, judged by re-simulation
    # with refits (see the JAX script for why statistics alone over-select)
    extra = small_supports(len(basis))
    C_sel, refit_loss, k_sel = judge(
        ladder(basis.theta(rc["feats_h"][1:]), rc["L_hat"][1:], extra), basis, ts, data)
    res_ude = as_result(res_ideal, C_sel)
    print(f"selection: k={int(k_sel)} terms, refit loss {float(refit_loss):.3g}")
    print("UDE-recovery:  ", res_ude.equations("dz")[0][:100])
    lap("ude_judge")

    # the weak-form arm: the exposure straight from the noisy observables
    G_w, y_w = weak_rows(ts, data, basis)
    C_w, refit_loss_w, k_w = judge(ladder(G_w, y_w, extra), basis, ts, data)
    res_weak = as_result(res_ideal, C_w)
    print(f"weak-form arm: k={int(k_w)} terms, refit loss {float(refit_loss_w):.3g} "
          "(training-free)")
    print("weak-recovery: ", res_weak.equations("dz")[0][:100])
    lap("weak_judge")

    # extrapolation to day 60 (seir_exposure.jl:248-253); truth60() raises
    # unless the day-60 truth converged
    t60 = truth60(device=data.device)
    _, ok, err = extrapolate(res_ude, t60)
    _, ok_w, err_w = extrapolate(res_weak, t60)
    print(f"recovered-model extrapolation to day 60: success={ok}, rel err on E,I,R = "
          f"{err:.3f}")
    print(f"weak-form-model extrapolation to day 60: success={ok_w}, rel err on E,I,R = "
          f"{err_w:.3f} (training-free vs the trained arm's {err:.3f})")
    lap("extrapolation")
    return dict(k_sel=int(k_sel), refit_loss=float(refit_loss),
                k_weak=int(k_w), refit_loss_weak=float(refit_loss_w), extrap_rel_err=err,
                extrap_rel_err_weak=err_w, extrap_success=ok, extrap_success_weak=ok_w,
                equations=dict(ideal=res_ideal.equations("dz"), ude=res_ude.equations("dz"),
                               weak=res_weak.equations("dz")))


def gates(out, quick):
    """The JAX script's gates on :func:`recovery_arms`' results: without
    ``quick``, both arms' day-60 solves finish within relative error 0.15
    (a clamped tail freezes the small late-time states and could sneak under
    the peak-normalized bound untested).  The truth solves gate by raising."""
    g = dict(truth=True, truth60=True)
    if not quick:
        g.update(ude_day60=out["extrap_success"] and out["extrap_rel_err"] < 0.15,
                 weak_day60=out["extrap_success_weak"] and out["extrap_rel_err_weak"] < 0.15)
    return g


def main(quick=False, device="cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    walls, lap = stopwatch(device)
    ts64, _, data64 = truth(torch.Generator().manual_seed(SEEDS["noise"]), device=device)
    print(f"truth: E,I,R final = {data64[-1, 1:4].cpu().numpy()}")
    ts, data = ts64.float(), data64.float()
    lap("truth")
    node = neural_ode_arm(ts, data, quick, device)
    lap("train_neural_ode")
    rhs_ude, net, p_ude, expo = exposure_ude_arm(ts, data, quick, device)
    lap("train_exposure_ude")
    out = recovery_arms(rhs_ude, net, p_ude, ts, data, lap)
    out = dict(device=_card(device), quick=quick, walls=walls, total_s=sum(walls.values()),
               neural_ode=node, exposure_ude=expo, **out, gates=gates(out, quick))
    if not all(out["gates"].values()):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"SEIR gate failed: {out['gates']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="200 ADAM steps and one round of ≤ 200 BFGS iterations per variant "
                         "(500 and ≤ 5 rounds of 250 without); no day-60 accuracy gate")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device)), flush=True)
