"""PyTorch port: the SEIR exposure slice against the JAX package (float64).

The model pieces (``corona_rhs``, ``beta_t``, ``true_exposure``, both learned
variants' right-hand sides with JAX's weights carried over by
``params_from_jax``, the recovered-exposure right-hand side, and their
``jacfwd``) agree to 1e-12; a ``rescale_problem`` solve agrees to 1e-8 at
rtol 1e-10; the training loss's interpolating-adjoint gradient
(``examples/seir_exposure.py``'s ``make_loss``) agrees with ``jax.grad`` to
1e-7 at width 8.  The slice as a whole, shrunk to width 8, 3 ADAM steps, 2
BFGS iterations and judges of 3 refit iterations, from the same data and
initial weights: the losses agree to 1e-6 relative, and the deterministic
stages (the ideal recovery, the ladders, the judges' sizes) are equal.  The
JAX side is the JAX script's computation, written here with the JAX package
(the script keeps it inside ``main``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch import sindy as tsd
from universal_differential_equations_torch.examples import seir_exposure as tse
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_torch.models import seir as tseir
from universal_differential_equations_torch.utils import rescale_problem as t_rescale
from universal_differential_equations_tpu import sindy as jsd
from universal_differential_equations_tpu.models import seir as jseir
from universal_differential_equations_tpu.train import bfgs_minimize as j_bfgs
from universal_differential_equations_tpu.train import fit as j_fit
from universal_differential_equations_tpu.utils import rescale_problem as j_rescale

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64
SCALES = jnp.asarray(tse.SCALES)
# F/S0, β0, α, κ, μ, σ, γ, d, λ as the JAX script reads them
F_N, BETA0, _, _, MU, SIGMA, GAMMA, D_, LAM = [float(v) for v in np.asarray(jseir.P_SEIR)]
F_N /= 14e6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _states(n=6, seed=0):
    """SEIR-like normalized states: S, N ~ 1, the rest ~1e-5."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.5, 2.0, size=(n, 7)) * np.array([1, 1e-5, 1e-5, 1e-5, 1, 1e-5, 1e-5])
    u[:, 4] += 0.5
    return u


def _variants(width, seed=0):
    """Both learned variants in each package, with JAX's initial weights."""
    out = {}
    for name, j_make, t_make in (("neural_ode", jseir.make_neural_ode, tseir.make_neural_ode),
                                 ("exposure_ude", jseir.make_exposure_ude,
                                  tseir.make_exposure_ude)):
        rhs_j, p_j, net_j = j_make(jax.random.PRNGKey(seed), width=width, dtype=jnp.float64)
        rhs_t, _, net_t = t_make(torch.Generator().manual_seed(0), width=width, dtype=F64)
        p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64)
        out[name] = (rhs_j, p_j, net_j, rhs_t, p_t, net_t)
    return out


def test_constants_and_truth_rhs_match_jax():
    np.testing.assert_array_equal(tseir.P_SEIR.numpy(), np.asarray(jseir.P_SEIR))
    np.testing.assert_array_equal(tseir.U0_NORM.numpy(), np.asarray(jseir.U0_NORM))
    P_j, P_t = jseir.P_SEIR, tseir.P_SEIR
    U = _states()
    for u in U:
        np.testing.assert_allclose(tseir.corona_rhs(0.0, torch.tensor(u), P_t).numpy(),
                                   np.asarray(jseir.corona_rhs(0.0, jnp.asarray(u), P_j)),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(float(tseir.true_exposure(torch.tensor(u))),
                                   float(jseir.true_exposure(jnp.asarray(u))), rtol=1e-12)
        np.testing.assert_allclose(
            float(tseir.beta_t(0.0, torch.tensor(u[5]), torch.tensor(u[4]))),
            float(jseir.beta_t(0.0, u[5], u[4])), rtol=1e-12)
    # lanes (L, 7) give the per-state values; jacfwd through (1 − D/N)^κ
    lanes = tseir.corona_rhs(0.0, torch.tensor(U), P_t)
    for i, u in enumerate(U):
        np.testing.assert_allclose(lanes[i].numpy(),
                                   tseir.corona_rhs(0.0, torch.tensor(u), P_t).numpy(),
                                   rtol=1e-15, atol=0)
    J_t = torch.func.jacfwd(lambda u: tseir.corona_rhs(0.0, u, P_t))(torch.tensor(U[0]))
    J_j = jax.jacfwd(lambda u: jseir.corona_rhs(0.0, u, P_j))(jnp.asarray(U[0]))
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-12, atol=1e-20)


def test_learned_variants_match_jax():
    U = _states(seed=1)
    for name, (rhs_j, p_j, _, rhs_t, p_t, _) in _variants(64).items():
        # the full widths: 9,157 and 4,481 parameters
        n = travel(p_t)[0].numel()
        assert n == jravel(p_j)[0].size == {"neural_ode": 9157, "exposure_ude": 4481}[name]
        for u in U:
            np.testing.assert_allclose(rhs_t(0.0, torch.tensor(u), p_t).numpy(),
                                       np.asarray(rhs_j(0.0, jnp.asarray(u), p_j)),
                                       rtol=1e-12, atol=1e-22)
        lanes = rhs_t(0.0, torch.tensor(U), p_t)
        np.testing.assert_allclose(lanes.numpy(),
                                   np.asarray(jax.vmap(lambda u: rhs_j(0.0, u, p_j))(U)),
                                   rtol=1e-12, atol=1e-22)
        J_t = torch.func.jacfwd(lambda u: rhs_t(0.0, u, p_t))(torch.tensor(U[0]))
        J_j = jax.jacfwd(lambda u: rhs_j(0.0, u, p_j))(jnp.asarray(U[0]))
        np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(J_j).max()))


def test_recovered_rhs_matches_jax():
    rng = np.random.default_rng(2)
    feats = rng.uniform(0.5, 1.5, size=(40, 3))
    z = 0.3 * feats[:, 0] ** 2 * feats[:, 1]
    basis_j, basis_t = jsd.polynomial_basis(3, 3), tsd.polynomial_basis(3, 3)
    rj = jsd.sindy(jsd.DirectDataDrivenProblem(jnp.asarray(feats), jnp.asarray(z[:, None])),
                   basis_j, jsd.STLSQ((1e-3, 1e-2)), normalize=True)
    rt = tsd.sindy(tsd.DirectDataDrivenProblem(torch.tensor(feats), torch.tensor(z[:, None])),
                   basis_t, tsd.STLSQ((1e-3, 1e-2)), normalize=True)
    assert rt.equations() == rj.equations() == ["du1/dt = +0.3*u1^2*u2"]
    fj, ft = jseir.make_recovered_rhs(rj), tseir.make_recovered_rhs(rt)
    p = np.array([0.28])
    for u in _states(seed=3):
        np.testing.assert_allclose(ft(0.0, torch.tensor(u), torch.tensor(p)).numpy(),
                                   np.asarray(fj(0.0, jnp.asarray(u), jnp.asarray(p))),
                                   rtol=1e-12, atol=1e-22)


def test_rescale_problem_solve_matches_jax():
    ts = np.arange(0.0, 21.1, 1.0)
    pj = j_rescale(jude.ODEProblem(jseir.corona_rhs, jseir.U0_NORM, (0.0, 21.0),
                                   jseir.P_SEIR), SCALES)
    pt = t_rescale(tude.ODEProblem(tseir.corona_rhs, tseir.U0_NORM, (0.0, 21.0),
                                   tseir.P_SEIR), tse.SCALES)
    np.testing.assert_array_equal(pt.u0.numpy(), np.asarray(pj.u0))
    sj = jude.solve(pj, jude.Tsit5(), saveat=jnp.asarray(ts), rtol=1e-10, atol=1e-10,
                    adjoint=jude.NoAdjoint())
    st = tude.solve(pt, tude.Tsit5(), saveat=torch.tensor(ts), rtol=1e-10, atol=1e-10,
                    adjoint=tude.NoAdjoint())
    assert bool(sj.success) and bool(st.success)
    np.testing.assert_allclose(st.ys.numpy(), np.asarray(sj.ys), rtol=1e-8, atol=1e-8)
    # the rescaled solve is the plain one in other units
    plain = tude.solve(tude.ODEProblem(tseir.corona_rhs, tseir.U0_NORM, (0.0, 21.0),
                                       tseir.P_SEIR), tude.Vern7(), saveat=torch.tensor(ts),
                       rtol=1e-12, atol=1e-14, adjoint=tude.NoAdjoint())
    np.testing.assert_allclose((st.ys / torch.tensor(tse.SCALES)).numpy(), plain.ys.numpy(),
                               rtol=1e-7, atol=1e-13)


def _jax_loss(rhs, ts, data, rtol=1e-6, atol=1e-7):
    """The JAX script's training loss (``train_variant``'s ``loss``)."""
    prob_s = j_rescale(jude.ODEProblem(rhs, jseir.U0_NORM, (0.0, 21.0)), SCALES)
    data_s = data * SCALES[None, :]

    def loss(p):
        sol = jude.solve(jude.remake(prob_s, args=p), jude.Tsit5(), saveat=ts, rtol=rtol,
                         atol=atol, adjoint=jude.InterpolatingAdjoint())
        return jnp.mean((sol.ys[:, 1:4] - data_s[:, 1:4]) ** 2)

    return loss


@pytest.fixture(scope="module")
def data():
    """The JAX truth (float64, as the JAX tests run it) with numpy noise."""
    ts = jnp.arange(0.0, 21.1, 1.0)
    sol = jude.solve(jude.ODEProblem(jseir.corona_rhs, jseir.U0_NORM, (0.0, 21.0),
                                     jseir.P_SEIR), jude.Vern7(), saveat=ts, rtol=1e-10,
                     atol=1e-12, adjoint=jude.NoAdjoint(), step_to_saveat=True)
    assert bool(sol.success)
    draws = np.random.default_rng(10).standard_normal(sol.ys.shape)
    return dict(ts=np.asarray(ts), X=np.asarray(sol.ys), draws=draws,
                data=np.asarray(sol.ys) + 1e-7 * draws)


def test_truth_stage_matches_jax(data):
    ts, X, d = tse.truth(data["draws"])
    np.testing.assert_allclose(ts.numpy(), data["ts"], rtol=0, atol=0)
    np.testing.assert_allclose(X.numpy(), data["X"], rtol=1e-10, atol=1e-16)
    np.testing.assert_allclose(d.numpy(), data["data"], rtol=1e-10, atol=1e-16)
    ts60, X60 = tse.truth60()
    assert ts60.shape == (61,) and bool(torch.isfinite(X60).all())


@pytest.mark.parametrize("variant", ["neural_ode", "exposure_ude"])
def test_loss_gradient_matches_jax_grad(data, variant):
    rhs_j, p_j, _, rhs_t, p_t, _ = _variants(8)[variant]
    ts, d = data["ts"], data["data"]
    lj, gj = jax.value_and_grad(_jax_loss(rhs_j, jnp.asarray(ts), jnp.asarray(d), 1e-8, 1e-9))(
        p_j)
    flat, unravel = travel(p_t)
    x = flat.clone().requires_grad_(True)
    lt = tse.make_loss(rhs_t, torch.tensor(ts), torch.tensor(d), rtol=1e-8, atol=1e-9)(
        unravel(x))
    (gt,) = torch.autograd.grad(lt, x)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-9)
    assert _rel(gt.numpy(), jravel(gj)[0]) <= 1e-7


def test_train_variant_polish_finishes_in_float64(data):
    # the JAX script's polish branch (off by default): float32 parameters,
    # ADAM, then BFGS on the float64 loss at rtol 1e-8; float32 back
    rhs_t, p0, _ = tseir.make_exposure_ude(torch.Generator().manual_seed(2), width=8)
    ts, d = torch.tensor(data["ts"]).float(), torch.tensor(data["data"]).float()
    p, info = tse.train_variant("polish", rhs_t, p0, ts, d, False, polish=True, adam_steps=1,
                                bfgs_iters=1)
    assert info["bfgs_float64"] and info["bfgs_iterations"] == 1
    assert travel(p)[0].dtype == torch.float32
    loss64 = tse.make_loss(rhs_t, ts.double(), d.double(), rtol=1e-8, atol=1e-9)
    p64 = tse.cast(p, F64)
    np.testing.assert_allclose(float(loss64(p64)), info["bfgs_loss"], rtol=1e-4)


def _jax_dense_rhs(basis):
    """The JAX script's ``dense_rhs`` (one lane, in the solve units)."""
    F_n, beta0, mu, sigma, gamma, d, lam = F_N, BETA0, MU, SIGMA, GAMMA, D_, LAM

    def f(t, us, C):
        u = us / SCALES
        S, E, I, R, N, D, Cc = u
        z = 1e-5 * (basis.theta(jnp.stack([S / N, 1e5 * I, 1e5 * D / N])[None, :])[0]
                    @ C[:, 0])
        imported = beta0 * S * F_n / N
        return jnp.stack([-imported - z - mu * S, imported + z - (sigma + mu) * E,
                          sigma * E - (gamma + mu) * I, gamma * I - mu * R, -mu * N,
                          d * gamma * I - lam * D, sigma * E]) * SCALES

    return f


def _jax_judge(lad, basis, ts, data, refit_iters):
    n_steps = (len(ts) - 1) * tse.SUB
    return jsd.select_by_simulation(
        [lad], _jax_dense_rhs(basis), jseir.U0_NORM * SCALES, 0.0, 21.0, data * SCALES,
        jude.Tsit5(), n_steps, sub=tse.SUB, rel_factor=1.5, refit_iters=refit_iters,
        loss_floor=1e-4, max_total_support=4, sizes=[jnp.repeat(jnp.arange(1, 5), 2)],
        refit_all=True)


def _known_no_z_jax(u):
    S, E, I, R, Nn, D, Cc = u
    F_n, beta0, mu, sigma, gamma, d, lam = F_N, BETA0, MU, SIGMA, GAMMA, D_, LAM
    imported = beta0 * S * F_n / Nn
    return jnp.stack([-imported - mu * S, imported - (sigma + mu) * E,
                      sigma * E - (gamma + mu) * I, gamma * I - mu * R, -mu * Nn,
                      d * gamma * I - lam * D, sigma * E])


def test_whole_slice_shrunk_matches_jax(data):
    rhs_j, p_j, net_j, rhs_t, p_t, net_t = _variants(8)["exposure_ude"]
    ts_j, d_j = jnp.asarray(data["ts"]), jnp.asarray(data["data"])
    ts_t, d_t = torch.tensor(data["ts"]), torch.tensor(data["data"])

    # training: 3 ADAM(0.01) steps, one round of 2 BFGS iterations
    loss_j = _jax_loss(rhs_j, ts_j, d_j)
    aj = j_fit(loss_j, p_j, optax.adam(0.01), 3, callback_every=250)
    bj = j_bfgs(loss_j, aj.params, maxiters=2, initial_stepnorm=0.01)
    pt, info = tse.train_variant("exposure UDE", rhs_t, p_t, ts_t, d_t, True, adam_steps=3,
                                 bfgs_iters=2)
    np.testing.assert_allclose(info["adam_loss"], float(aj.losses[-1]), rtol=1e-6)
    np.testing.assert_allclose(info["bfgs_loss"], float(bj.value), rtol=1e-6)
    assert info["bfgs_iterations"] == int(bj.iterations) == 2

    # the exposure reconstruction and the ideal recovery
    rc = tse.reconstruct(rhs_t, net_t, pt, ts_t, d_t)
    sol_j = jude.solve(j_rescale(jude.ODEProblem(rhs_j, jseir.U0_NORM, (0.0, 21.0), bj.params),
                                 SCALES), jude.Tsit5(), saveat=ts_j, rtol=1e-6, atol=1e-7,
                       adjoint=jude.NoAdjoint())
    Xh_j = sol_j.ys / SCALES[None, :]
    fh_j = jnp.stack([Xh_j[:, 0] / Xh_j[:, 4], 1e5 * Xh_j[:, 2], 1e5 * Xh_j[:, 5] / Xh_j[:, 4]],
                     axis=1)
    Lh_j = jax.vmap(lambda f: net_j.apply(bj.params, f)[0])(fh_j)
    f_j = jnp.stack([d_j[:, 0] / d_j[:, 4], 1e5 * d_j[:, 2], 1e5 * d_j[:, 5] / d_j[:, 4]], axis=1)
    L_j = 1e5 * jax.vmap(jseir.true_exposure)(d_j)
    np.testing.assert_allclose(rc["feats"].numpy(), np.asarray(f_j), rtol=1e-12)
    np.testing.assert_allclose(rc["L_true"].numpy(), np.asarray(L_j), rtol=1e-12)
    assert _rel(rc["L_hat"].numpy(), Lh_j) <= 1e-6
    basis_j = jsd.cos_basis(3) + jsd.sin_basis(3) + jsd.tensor_polynomial_basis(3, 2)
    basis_t = tse.scenario_basis()
    assert basis_t.names == basis_j.names
    lams = tuple(10.0 ** e for e in np.arange(-6.0, 1.0, 0.1))
    ri_j = jsd.sindy(jsd.DirectDataDrivenProblem(f_j[4:], L_j[4:, None]), basis_j,
                     jsd.STLSQ(lams), normalize=True, exhaustive_k=2)
    ri_t = tse.ideal_recovery(rc["feats"], rc["L_true"], basis_t)
    np.testing.assert_array_equal(ri_t.active, np.asarray(ri_j.active))

    # the UDE arm and the weak arm: ladders and judges of 3 refit iterations
    m = len(basis_t)
    extra = tse.small_supports(m)
    lad_j = jsd.cv_ladder(basis_j.theta(fh_j[1:]), Lh_j[1:], jsd.STLSQ(lams), 4, per_size=2,
                          extra_supports=jnp.asarray(extra))
    lad_t = tse.ladder(basis_t.theta(rc["feats_h"][1:]), rc["L_hat"][1:], extra)
    Gw_j, Bw_j = jsd.weak_pair(ts_j, d_j, basis_j, _known_no_z_jax, widths=tse.WIDTHS, p=5,
                               features=lambda u: jnp.stack([u[0] / u[4], 1e5 * u[2],
                                                             1e5 * u[5] / u[4]]))
    Gw_t, yw_t = tse.weak_rows(ts_t, d_t, basis_t)
    assert _rel(Gw_t.numpy(), Gw_j) <= 1e-10
    assert _rel(yw_t.numpy(), Bw_j[:, 1] * 1e5) <= 1e-6
    wlad_j = jsd.cv_ladder(Gw_j, Bw_j[:, 1] * 1e5, jsd.STLSQ(lams), 4, per_size=2,
                           extra_supports=jnp.asarray(extra))
    wlad_t = tse.ladder(Gw_t, yw_t, extra)
    for (xj, oj), (xt, ot) in ((lad_j, lad_t), (wlad_j, wlad_t)):
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(xt.numpy() != 0, np.asarray(xj) != 0)
        Cj, lj, kj = _jax_judge((xj, oj), basis_j, ts_j, d_j, 3)
        Ct, lt, kt = tse.judge((xt, ot), basis_t, ts_t, d_t, refit_iters=3)
        assert int(kt) == int(kj)
        np.testing.assert_array_equal(Ct.numpy() != 0, np.asarray(Cj) != 0)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)

    # the day-60 extrapolation of the ideal recovery (finished, small error)
    _, ok, err = tse.extrapolate(ri_t, tse.truth60())
    assert ok and err < 0.05
