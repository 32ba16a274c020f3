"""Hudson Bay lynx/hare UDE on the port: real-data recovery.

    python -m universal_differential_equations_torch.examples.hudson_bay [--quick] --device cuda

The port of ``examples/lotka_volterra/hudson_bay.py`` (``hudson_bay.jl`` end
to end), stage by stage with the same constants: 21 yearly pelt counts
(Odum 1953), max-normalized → direct SINDy from the data by Gaussian-kernel
collocation → a hybrid UDE with learnable linear birth/decay rates and a
2→5→5→5→2 rbf/rbf/tanh net → ADAM(0.1) on the multiple-shooting loss in
float32 → BFGS on the shooting loss and Levenberg-Marquardt on the full
trajectory residuals, both in float64 → SINDy on the net's outputs, judged by
re-simulation with coefficient refits (``sindy.select_by_simulation``) →
post-fit of the recovered model → extrapolation to t = 50.  Seeds are tried
in the order (11, 5, 23, 37, 51) until one passes the fit and refit gates;
if none does, the best attempt carries the final checks.

Every stage runs on ``--device`` (default ``cuda``; it raises where there is
no card — ``--device cpu`` must be asked for).  The JAX script moves its
float64 stages to the host CPU because its accelerator has no fast float64;
the H100 has, so here they stay on the card.  The initial parameters come
from ``torch.Generator(seed)``, not ``jax.random``: the seeds name the same
ladder, not the same draws.  Left out: the plots.

The final checks (``hudson_bay.py``'s asserts) hold with and without
``--quick``: the recovered model has ≥ 2 terms and a refit trajectory MSE
< 0.2, its t = 50 solve finishes finite with amplitude < 10, and the UDE's
fit loss is < 0.1.  The last line of the output is a JSON object with the
stage wall times, the attempts and the gates.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

import universal_differential_equations_torch as ude
from universal_differential_equations_torch import sindy as sd
from universal_differential_equations_torch.examples.lv_scenario_1 import _card
from universal_differential_equations_torch.flatten_util import ravel_pytree
from universal_differential_equations_torch.nn import Chain, Dense

F32, F64 = torch.float32, torch.float64
DATA = (Path(__file__).resolve().parents[2] / "examples" / "lotka_volterra" / "data"
        / "hudson_bay_data.dat")
SEEDS = (11, 5, 23, 37, 51)
LAMS = tuple(10.0 ** e for e in np.arange(-7.0, 5.0, 0.1))
SUB = 8  # fixed Tsit5 substeps per year in the refit judge
GROUP, CONTINUITY = 5, 200.0  # the shooting knobs (hudson_bay.jl:115)


def load_data(dtype=F32, device=None):
    """``(t, Xn, xscale)``: years since 1900 and the max-normalized counts."""
    raw = np.loadtxt(DATA)
    t = torch.as_tensor(raw[:, 0] - raw[0, 0], dtype=dtype, device=device)
    X = torch.as_tensor(raw[:, 1:3], dtype=dtype, device=device)
    xscale = X.max(dim=0).values
    return t, X / xscale, xscale


def scenario_basis():
    """The candidate library: polynomials to degree 5 in (u1, u2), plus sin."""
    return sd.polynomial_basis(2, 5) + sd.sin_basis(2)


def make_net():
    """2→5(rbf)→5(rbf)→5(tanh)→2: the reference's layer stack."""
    return Chain((Dense(2, 5, "rbf"), Dense(5, 5, "rbf"), Dense(5, 5, "tanh"), Dense(5, 2)))


def init_params(net, seed, dtype=F32, device=None):
    """``{"lin": U(0, 1)², "nn": Glorot}`` drawn from ``torch.Generator(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    lin = torch.rand((2,), generator=gen, dtype=F64).to(dtype=dtype, device=device)
    return {"lin": lin, "nn": net.init(gen, dtype, device)}


def make_rhs(net):
    """The hybrid model: ``du1 = lin₀·u1 + NN₁(u)``, ``du2 = −lin₁·u2 + NN₂(u)``."""

    def rhs(t, u, p):
        uhat = net.apply(p["nn"], u)
        return torch.stack([p["lin"][0] * u[0] + uhat[0], -p["lin"][1] * u[1] + uhat[1]])

    return rhs


def reg(p):
    """1e-3 · mean of the squared net weights."""
    flat = ravel_pytree(p["nn"])[0]
    return 1e-3 * torch.mean(flat**2)


def shooting_loss(rhs, t, Xn):
    """The multiple-shooting loss (groups of 5 years, continuity 200) plus
    ``reg``, through the discrete adjoint of one vmapped solve."""

    def loss(p):
        return ude.multiple_shoot(p, Xn, t, rhs, group_size=GROUP,
                                  continuity_term=CONTINUITY, rtol=1e-6, atol=1e-6,
                                  max_steps=256) + reg(p)

    return loss


def full_residuals(rhs, t, Xn):
    """Whole-record residuals ``(sol − Xn)/√N`` plus the weight penalty
    ``√(1e-3/n)·w``, for Levenberg-Marquardt through forward sensitivities."""
    t_end = float(t[-1])

    def residuals(p):
        sol = ude.solve(ude.ODEProblem(rhs, Xn[0], (0.0, t_end), p), ude.Tsit5(), saveat=t,
                        rtol=1e-6, atol=1e-6, adjoint=ude.ForwardSensitivity(),
                        max_steps=512)
        flat = ravel_pytree(p["nn"])[0]
        rr = (1e-3 / flat.numel()) ** 0.5 * flat
        return torch.cat([((sol.ys - Xn) / Xn.shape[0] ** 0.5).reshape(-1), rr])

    return residuals


def direct_sindy(t, Xn, basis):
    """SINDy straight from the data, derivatives by kernel collocation
    (``hudson_bay.jl:48-67``)."""
    return sd.sindy(sd.ContinuousDataDrivenProblem(Xn, t), basis, sd.STLSQ(LAMS),
                    normalize=True, denoise=True, sampler=sd.DataSampler(4), exhaustive_k=2)


def exclusions(basis):
    """Per equation, the features the hybrid model already carries (u and its
    near-alias sin(u) on the normalized range), kept out of the ladders."""
    names = basis.names
    return ([names.index("u1"), names.index("sin(u1)")],
            [names.index("u2"), names.index("sin(u2)")])


def dense_rhs(basis, lin):
    """The recovered model with coefficients ``C``: ``u`` (2,) with ``C``
    (m, 2), or lanes ``u`` (L, 2) with ``C`` (L, m, 2), one model per lane."""
    lin0, lin1 = float(lin[0]), float(lin[1])

    def f(t, u, C):
        z = torch.einsum("...m,...md->...d", basis.theta(u), C)
        return torch.stack([lin0 * u[..., 0] + z[..., 0], -lin1 * u[..., 1] + z[..., 1]], -1)

    return f


def cast(p, dtype):
    """The parameter tree ``p`` in ``dtype``."""
    flat, unravel = ravel_pytree(p)
    return unravel(flat.to(dtype))


def train(net, seed, t, Xn, quick):
    """The three training stages (``hudson_bay.jl:142-148``): ADAM on the
    shooting loss (float32), then BFGS on it and LM on the full residuals
    (float64).  Returns ``(p32, losses, walls)``."""
    rhs = make_rhs(net)
    device = Xn.device
    walls, clock = {}, [time.perf_counter()]

    def lap(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        walls[name] = now - clock[0]
        clock[0] = now

    r1 = ude.fit(shooting_loss(rhs, t.float(), Xn.float()),
                 init_params(net, seed, F32, device),
                 lambda ps: torch.optim.Adam(ps, lr=0.1), 100, callback_every=50)
    lap("adam")
    t64, Xn64 = t.double(), Xn.double()
    r2 = ude.bfgs_minimize(shooting_loss(rhs, t64, Xn64), cast(r1.params, F64),
                           maxiters=200 if quick else 500, initial_stepnorm=0.01)
    lap("bfgs")
    r3 = ude.levenberg_marquardt(full_residuals(rhs, t64, Xn64), r2.params,
                                 maxiters=60 if quick else 200)
    lap("lm")
    losses = dict(adam=r1.final_loss, bfgs=float(r2.value), lm=float(r3.loss))
    return cast(r3.params, F32), losses, walls


def recover(net, p_tr, t, Xn, basis, fit_loss):
    """SINDy on the net's outputs along the trained trajectory, judged by
    re-simulation with coefficient refits (``hudson_bay.jl:180-193``).
    Returns ``(Xh, Yh, C_sel, refit_loss, k_sel)``."""
    rhs = make_rhs(net)
    t_end = float(t[-1])
    tsample = torch.arange(0.0, t_end + 0.25, 0.5, dtype=Xn.dtype, device=Xn.device)
    sol = ude.solve(ude.ODEProblem(rhs, Xn[0], (0.0, t_end), p_tr), ude.Tsit5(),
                    saveat=tsample, rtol=1e-6, atol=1e-6, adjoint=ude.NoAdjoint())
    Xh = sol.ys
    Yh = net.apply(p_tr["nn"], Xh)
    theta = basis.theta(Xh)
    excl1, excl2 = exclusions(basis)
    opt = sd.STLSQ(LAMS)
    floor = max(2.0 * fit_loss, 1e-3)  # the UDE's own trajectory MSE
    C_sel, refit_loss, k_sel = sd.select_by_simulation(
        [sd.cv_ladder(theta, Yh[:, 0], opt, 4, exclude=excl1),
         sd.cv_ladder(theta, Yh[:, 1], opt, 4, exclude=excl2)],
        dense_rhs(basis, p_tr["lin"]), Xn[0], 0.0, t_end, Xn, ude.Tsit5(),
        (Xn.shape[0] - 1) * SUB, sub=SUB, rel_factor=1.5, refit_iters=100,
        loss_floor=floor, max_total_support=6, refit_all=True)
    return Xh, Yh, C_sel, float(refit_loss), int(k_sel)


def recovered_rhs(res):
    """The hybrid model with the recovered terms; parameters
    ``{"lin", "coef"}`` (``hudson_bay.jl:197-210``)."""
    rec = res.rhs()

    def rhs(t, u, p):
        z = rec(t, u, p["coef"])
        return torch.stack([p["lin"][0] * u[0] + z[0], -p["lin"][1] * u[1] + z[1]])

    return rhs


def postfit(rec_rhs, p0, t, Xn, maxiters=100):
    """LM on the recovered model's trajectory residuals against the data."""
    t_end = float(t[-1])

    def resid(p):
        sol = ude.solve(ude.ODEProblem(rec_rhs, Xn[0], (0.0, t_end), p), ude.Tsit5(),
                        saveat=t, rtol=1e-6, atol=1e-6, adjoint=ude.ForwardSensitivity(),
                        max_steps=512)
        return (sol.ys - Xn).reshape(-1)

    return ude.levenberg_marquardt(resid, p0, maxiters=maxiters)


def extrapolate(rec_rhs, p, u0):
    """The recovered model from ``u0`` to t = 50 (``hudson_bay.jl:225-227``):
    ``(ys, success, finite, amplitude)``."""
    ts_long = torch.arange(0.0, 50.1, 0.25, dtype=u0.dtype, device=u0.device)
    est = ude.solve(ude.ODEProblem(rec_rhs, u0, (0.0, 50.0), p), ude.Tsit5(),
                    saveat=ts_long, rtol=1e-6, atol=1e-8, adjoint=ude.NoAdjoint())
    finite = bool(torch.isfinite(est.ys).all())
    return est.ys, bool(est.success), finite, float(est.ys.abs().max())


def main(quick=False, device="cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    walls = {}
    clock = [time.perf_counter()]

    def lap(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        dt = now - clock[0]
        walls[name] = walls.get(name, 0.0) + dt
        clock[0] = now
        print(f"[{name}] {dt:.2f} s", flush=True)
        return dt

    t, Xn, _ = load_data(F32, device)
    t_end = float(t[-1])
    print(f"data: {Xn.shape[0]} yearly measurements, t ∈ [0, {t_end}]")
    basis = scenario_basis()
    full = direct_sindy(t, Xn, basis)
    print("direct SINDy (collocation):")
    for eq in full.equations():
        print("   " + eq[:90])
    lap("direct_sindy")

    net = make_net()
    attempts, best = [], None
    for seed in SEEDS:
        p_tr, losses, t_walls = train(net, seed, t, Xn, quick)
        for k, v in t_walls.items():
            walls[k] = walls.get(k, 0.0) + v
        clock[0] = time.perf_counter()
        print(f"training[seed {seed}]: shooting-adam {losses['adam']:.4f} -> "
              f"shooting-bfgs(f64) {losses['bfgs']:.4f} -> full-LM(f64) {losses['lm']:.4f}",
              flush=True)
        Xh, Yh, C_sel, refit_loss, k_sel = recover(net, p_tr, t, Xn, basis, losses["lm"])
        t_walls["judge"] = lap("judge")
        a = dict(seed=seed, losses=losses, fit_loss=losses["lm"], refit_loss=refit_loss,
                 k_sel=k_sel, p_tr=p_tr, Xh=Xh, Yh=Yh, C_sel=C_sel)
        attempts.append({k: a[k] for k in ("seed", "losses", "refit_loss", "k_sel")})
        attempts[-1]["walls"] = t_walls
        print(json.dumps({"attempt": attempts[-1]}), flush=True)
        if best is None or (a["fit_loss"] + a["refit_loss"]
                            < best["fit_loss"] + best["refit_loss"]):
            best = a
        if a["fit_loss"] < 0.05 and a["refit_loss"] < 0.15:
            # the gate-passing attempt carries the checks even if an earlier
            # failing seed had a lower loss sum
            best = a
            break
        print(f"  seed {seed}: fit {a['fit_loss']:.3g} / refit {a['refit_loss']:.3g} — "
              f"retrying with the next seed", flush=True)
    a = best

    nn_res = sd.sindy(sd.DirectDataDrivenProblem(a["Xh"], a["Yh"]), basis, sd.STLSQ(LAMS),
                      normalize=True, denoise=True, sampler=sd.DataSampler(4),
                      exhaustive_k=2)
    C = a["C_sel"].cpu().numpy()
    act = C != 0.0
    nn_res = dataclasses.replace(nn_res, coefficients=C, active=act, sparsity=act.sum(axis=0))
    print(f"UDE SINDy recovery (refit-judged, {a['k_sel']} terms, trajectory MSE "
          f"{a['refit_loss']:.3g}):")
    for eq in nn_res.equations():
        print("   " + eq[:90])
    lap("sindy")

    rec_rhs = recovered_rhs(nn_res)
    p_rec0 = {"lin": a["p_tr"]["lin"],
              "coef": torch.as_tensor(nn_res.parameters(), dtype=F32, device=device)}
    rfit = postfit(rec_rhs, p_rec0, t, Xn)
    print(f"post-fit: loss {float(rfit.loss):.4f} lin={rfit.params['lin'].cpu().numpy()}")
    lap("postfit")
    _, done, finite, amp = extrapolate(rec_rhs, rfit.params, Xn[0])
    print(f"extrapolation to t=50: solver_done={done}, finite={finite}, max amplitude "
          f"{amp:.2f} (normalized units)")
    lap("extrapolation")
    gates = dict(terms=int(nn_res.parameters().size) >= 2, refit=a["refit_loss"] < 0.2,
                 extrapolation=done and finite and amp < 10.0, fit=a["fit_loss"] < 0.1)
    out = dict(device=_card(device), quick=quick, walls=walls, total_s=sum(walls.values()),
               attempts=attempts, seed=a["seed"], fit_loss=a["fit_loss"],
               refit_loss=a["refit_loss"], k_sel=a["k_sel"], postfit_loss=float(rfit.loss),
               amplitude=amp, equations=nn_res.equations(), gates=gates)
    if not all(gates.values()):
        print(json.dumps(out), flush=True)
        raise RuntimeError(f"Hudson Bay gate failed: {gates}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="200 shooting-BFGS and 60 LM iterations (500 and 200 without)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every stage (default cuda)")
    args = ap.parse_args()
    print(json.dumps(main(quick=args.quick, device=args.device)), flush=True)
