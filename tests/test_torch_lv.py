"""PyTorch port: Lotka-Volterra scenario 1 against the JAX package (float64).

The model pieces (truth data with JAX's noise draws, the UDE right-hand side
with JAX's initial parameters, the recovered-model right-hand side) agree to
1e-9, and the slice as a whole: from the same parameters and the same noisy
data, 3 ADAM(0.1) steps and 3 BFGS iterations through the interpolating
adjoint give losses that agree to 1e-7 relative, and SINDy on the trained
UDE's interactions (X̂, NN(X̂)) recovers the same equations.  The pipeline's
own stages (``examples/lv_scenario_1.py``: the training loss, the refit
judge's lane-batched loss, the refit and the extrapolation) are held against
the same computation in the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch import sindy as tsd
from universal_differential_equations_torch.examples import lv_scenario_1 as scen
from universal_differential_equations_torch.models import lotka_volterra as tlv
from universal_differential_equations_tpu import sindy as jsd
from universal_differential_equations_tpu.core.integrate import integrate_fixed as j_fixed
from universal_differential_equations_tpu.models import lotka_volterra as jlv
from universal_differential_equations_tpu.train import bfgs_minimize as j_bfgs
from universal_differential_equations_tpu.train import fit as j_fit

torch.set_num_threads(1)

F64 = torch.float64
LAMS = tuple(10.0 ** e for e in np.arange(-3.0, 5.0, 0.05))  # the scenario's grid
assert LAMS == scen.LAMS


@pytest.fixture(scope="module")
def scenario():
    """The scenario's data and initial parameters from the JAX package."""
    kd, kn = jax.random.split(jax.random.PRNGKey(1234))
    ts, X_true, X_noisy = jlv.generate_data(kd)
    draws = np.asarray(jax.random.normal(kd, X_true.shape, jnp.float64))
    rhs_j, p_j, net_j = jlv.make_ude(kn, dtype=jnp.float64)
    rhs_t, _, net_t = tlv.make_ude(torch.Generator().manual_seed(0), dtype=F64)
    return dict(ts=np.asarray(ts), X_true=np.asarray(X_true), X_noisy=np.asarray(X_noisy),
                draws=draws, rhs_j=rhs_j, p_j=p_j, net_j=net_j, rhs_t=rhs_t, net_t=net_t,
                p_t=tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64))


def test_generate_data_matches_jax(scenario):
    ts, X_true, X_noisy = tlv.generate_data(scenario["draws"])
    np.testing.assert_allclose(ts.numpy(), scenario["ts"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(X_true.numpy(), scenario["X_true"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(X_noisy.numpy(), scenario["X_noisy"], rtol=1e-9, atol=1e-9)
    # the generator form draws the same standard normals on every device
    _, _, Xa = tlv.generate_data(torch.Generator().manual_seed(5))
    _, _, Xb = tlv.generate_data(torch.Generator().manual_seed(5))
    assert Xa.shape == (31, 2) and torch.equal(Xa, Xb)
    with pytest.raises(RuntimeError, match="truth generation failed"):
        tlv.generate_data(torch.Generator().manual_seed(5), dtype=torch.float32)


def test_rhs_pieces_match_jax(scenario):
    u = np.array([0.7, 2.3])
    P = np.asarray(jlv.P_TRUE)
    np.testing.assert_allclose(tlv.P_TRUE.numpy(), P)
    np.testing.assert_allclose(tlv.U0.numpy(), np.asarray(jlv.U0))
    np.testing.assert_allclose(tlv.lotka_rhs(0.0, torch.tensor(u), tlv.P_TRUE).numpy(),
                               np.asarray(jlv.lotka_rhs(0.0, jnp.asarray(u), jnp.asarray(P))),
                               rtol=1e-14)
    np.testing.assert_allclose(
        scenario["rhs_t"](0.0, torch.tensor(u), scenario["p_t"]).numpy(),
        np.asarray(scenario["rhs_j"](0.0, jnp.asarray(u), scenario["p_j"])), rtol=1e-12)
    # the full width of the paper's model: 2→5→5→5→2, 87 parameters
    assert sum(v.numel() for layer in scenario["p_t"] for v in layer.values()) == 87


def test_recovered_rhs_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.uniform(0.2, 5.0, size=(60, 2))
    Y = np.stack([-0.9 * X[:, 0] * X[:, 1], 0.8 * X[:, 0] * X[:, 1]], -1)
    basis_j = jsd.polynomial_basis(2, 5) + jsd.sin_basis(2)
    basis_t = tsd.polynomial_basis(2, 5) + tsd.sin_basis(2)
    rj = jsd.sindy(jsd.DirectDataDrivenProblem(jnp.asarray(X), jnp.asarray(Y)), basis_j,
                   jsd.STLSQ(LAMS), normalize=True)
    rt = tsd.sindy(tsd.DirectDataDrivenProblem(torch.tensor(X), torch.tensor(Y)), basis_t,
                   tsd.STLSQ(LAMS), normalize=True)
    assert rt.equations() == rj.equations() == ["du1/dt = -0.9*u1*u2", "du2/dt = +0.8*u1*u2"]
    fj, ft = jlv.make_recovered_rhs(rj), tlv.make_recovered_rhs(rt)
    p = np.array([-0.85, 0.75])
    np.testing.assert_allclose(ft(0.0, torch.tensor(X[0]), torch.tensor(p)).numpy(),
                               np.asarray(fj(0.0, jnp.asarray(X[0]), jnp.asarray(p))),
                               rtol=1e-12)


def _jax_loss(rhs, ts, X, tol):
    prob = jude.ODEProblem(rhs, X[0], (0.0, 3.0))

    def loss(p):
        sol = jude.solve(jude.remake(prob, args=p), jude.Tsit5(), saveat=ts, rtol=tol,
                         atol=tol, adjoint=jude.InterpolatingAdjoint())
        return jnp.mean((sol.ys - X) ** 2)

    return loss


def test_whole_slice_matches_jax(scenario):
    ts_j, X_j = jnp.asarray(scenario["ts"]), jnp.asarray(scenario["X_noisy"])
    ts_t, X_t = torch.tensor(scenario["ts"]), torch.tensor(scenario["X_noisy"])

    # 3 ADAM(0.1) steps at the scenario's 1e-6, then 3 BFGS iterations at 1e-8
    aj = j_fit(_jax_loss(scenario["rhs_j"], ts_j, X_j, 1e-6),
               scenario["p_j"], optax.adam(0.1), 3, callback_every=3)
    at = tude.fit(scen.make_loss(scenario["rhs_t"], X_t, ts_t, 1e-6),
                  scenario["p_t"], lambda ps: torch.optim.Adam(ps, lr=0.1), 3,
                  callback_every=3)
    np.testing.assert_allclose(at.losses.numpy(), np.asarray(aj.losses), rtol=1e-7)
    bj = j_bfgs(_jax_loss(scenario["rhs_j"], ts_j, X_j, 1e-8),
                aj.params, maxiters=3, initial_stepnorm=0.01, gtol=1e-12)
    bt = tude.bfgs_minimize(scen.make_loss(scenario["rhs_t"], X_t, ts_t, 1e-8),
                            at.params, maxiters=3, initial_stepnorm=0.01, gtol=1e-12)
    assert int(bt.iterations) == int(bj.iterations) == 3
    assert int(bt.num_evals) == int(bj.num_evals)
    np.testing.assert_allclose(bt.loss_history.numpy(), np.asarray(bj.loss_history),
                               rtol=1e-7)
    assert float(bt.value) < at.final_loss

    # SINDy on the learned interactions along the trained trajectory
    sj = jude.solve(jude.ODEProblem(scenario["rhs_j"], X_j[0], (0.0, 3.0), bj.params),
                    jude.Tsit5(), saveat=ts_j, rtol=1e-6, atol=1e-6, adjoint=jude.NoAdjoint())
    st = tude.solve(tude.ODEProblem(scenario["rhs_t"], X_t[0], (0.0, 3.0), bt.params),
                    tude.Tsit5(), saveat=ts_t, rtol=1e-6, atol=1e-6, adjoint=tude.NoAdjoint())
    np.testing.assert_allclose(st.ys.numpy(), np.asarray(sj.ys), rtol=1e-7, atol=1e-9)
    nn_j = jax.vmap(lambda u: scenario["net_j"].apply(bj.params, u))(sj.ys)
    nn_t = scenario["net_t"].apply(bt.params, st.ys)
    np.testing.assert_allclose(nn_t.numpy(), np.asarray(nn_j), rtol=1e-7, atol=1e-9)
    # The net has taken six steps, so its interactions are not sparse, and
    # the scenario's degree-5 library fits them with a dense, ill-conditioned
    # model: there the JAX package against itself, from inputs 1e-13 apart,
    # moves coefficients by 1 %.  Degree 3 + sin keeps the fit well posed
    # (its equations do not move under ±1e-10 input changes), so the
    # comparison tests the port and not the conditioning.  The degree-5
    # library is held against JAX on sparse targets in test_torch_sindy.py
    # and test_recovered_rhs_matches_jax.
    rj = jsd.sindy(jsd.DirectDataDrivenProblem(sj.ys, nn_j),
                   jsd.polynomial_basis(2, 3) + jsd.sin_basis(2), jsd.STLSQ(LAMS),
                   normalize=True, sampler=jsd.DataSampler(n=4, shuffle=True))
    rt = tsd.sindy(tsd.DirectDataDrivenProblem(st.ys, nn_t),
                   tsd.polynomial_basis(2, 3) + tsd.sin_basis(2), tsd.STLSQ(LAMS),
                   normalize=True, sampler=tsd.DataSampler(n=4, shuffle=True))
    np.testing.assert_array_equal(rt.active, np.asarray(rj.active))
    assert rt.equations() == rj.equations()


def _jax_dense_rhs(basis):
    alpha, delta = float(jlv.P_TRUE[0]), float(jlv.P_TRUE[3])

    def rhs(t, u, C):  # scenario_1.py's dense_rhs
        term = basis.theta(u) @ C
        return jnp.array([alpha * u[0] + term[0], -delta * u[1] + term[1]])

    return rhs


def test_pipeline_judge_loss_matches_jax(scenario):
    # three candidate pairs around the true x·y model, one with an extra u1
    # term; the lane-batched judge loss equals JAX's vmapped per-pair loss
    # (scenario_1.py's refit_pair) to 1e-12 relative, and each single lane
    # equals its lane of the batch to 1e-14
    basis_t, basis_j = scen.scenario_basis(), jsd.polynomial_basis(2, 5) + jsd.sin_basis(2)
    m, j = len(basis_t), basis_t.names.index("u1*u2")
    rng = np.random.default_rng(3)
    C0 = np.zeros((3, m, 2))
    C0[:, j] = np.array([-0.9, 0.8]) + 0.05 * rng.standard_normal((3, 2))
    C0[1, basis_t.names.index("u1")] = [0.05, -0.02]
    mask = (C0 != 0).astype(np.float64)
    ts, X = scenario["ts"], scenario["X_noisy"]
    n_sub = (len(ts) - 1) * scen.SUB
    rhs_j = _jax_dense_rhs(basis_j)

    def loss_pair(C, M):
        _, ys = j_fixed(rhs_j, jnp.asarray(X[0]), 0.0, 3.0, C * M, jude.Tsit5(), n_sub)
        return jnp.mean((ys[::scen.SUB] - X) ** 2)

    want = np.asarray(jax.vmap(loss_pair)(jnp.asarray(C0), jnp.asarray(mask)))
    X_t = torch.tensor(X)
    got = scen.judge_loss(basis_t, X_t[0], X_t, torch.tensor(ts), torch.tensor(mask))(
        torch.tensor(C0))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    for lane in range(3):
        one = scen.judge_loss(basis_t, X_t[0], X_t, torch.tensor(ts),
                              torch.tensor(mask[lane]))(torch.tensor(C0[lane]))
        np.testing.assert_allclose(float(one), float(got[lane]), rtol=1e-14)


def test_pipeline_refit_and_extrapolation_match_jax(scenario):
    # the recovered x·y model refit by 3 BFGS iterations (the pipeline's
    # refit against JAX's bfgs_minimize on scenario_1.py's loss_rec), then
    # extrapolated to t = 50: parameters and losses to 1e-8 relative, the
    # t = 50 trajectories to 1e-6, and the mean periods to 1e-12
    rng = np.random.default_rng(0)
    Xs = rng.uniform(0.2, 5.0, size=(60, 2))
    Ys = np.stack([-0.9 * Xs[:, 0] * Xs[:, 1], 0.8 * Xs[:, 0] * Xs[:, 1]], -1)
    basis_j = jsd.polynomial_basis(2, 5) + jsd.sin_basis(2)
    rj = jsd.sindy(jsd.DirectDataDrivenProblem(jnp.asarray(Xs), jnp.asarray(Ys)), basis_j,
                   jsd.STLSQ(LAMS), normalize=True)
    rt = tsd.sindy(tsd.DirectDataDrivenProblem(torch.tensor(Xs), torch.tensor(Ys)),
                   scen.scenario_basis(), tsd.STLSQ(LAMS), normalize=True)
    fj, ft = jlv.make_recovered_rhs(rj), tlv.make_recovered_rhs(rt)
    ts, X = scenario["ts"], scenario["X_noisy"]
    p0 = np.array([-0.8, 0.7])

    def loss_rec(p):
        sol = jude.solve(jude.ODEProblem(fj, jnp.asarray(X[0]), (0.0, 3.0), p), jude.Tsit5(),
                         saveat=jnp.asarray(ts), rtol=1e-6, atol=1e-6)
        return jnp.mean((sol.ys - X) ** 2)

    bj = j_bfgs(loss_rec, jnp.asarray(p0), maxiters=3)
    X_t = torch.tensor(X)
    bt = scen.refit(ft, torch.tensor(p0), X_t[0], X_t, torch.tensor(ts), maxiters=3)
    assert int(bt.iterations) == int(bj.iterations)
    np.testing.assert_allclose(bt.params.numpy(), np.asarray(bj.params), rtol=1e-8)
    np.testing.assert_allclose(float(bt.value), float(bj.value), rtol=1e-8)

    ys_t, per_rec, per_tru = scen.extrapolate(ft, bt.params, X_t[0])
    ts_ex = jnp.linspace(0.0, 50.0, 501)
    u0 = jnp.asarray(X[0])
    ex_j = jude.solve(jude.ODEProblem(fj, u0, (0.0, 50.0), bj.params), jude.Tsit5(),
                      saveat=ts_ex, rtol=1e-8, atol=1e-8, adjoint=jude.NoAdjoint())
    tr_j = jude.solve(jude.ODEProblem(jlv.lotka_rhs, u0, (0.0, 50.0), jlv.P_TRUE),
                      jude.Tsit5(), saveat=ts_ex, rtol=1e-10, atol=1e-10,
                      adjoint=jude.NoAdjoint(), max_steps=16384)
    assert bool(ex_j.success) and bool(tr_j.success)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ex_j.ys), rtol=1e-6, atol=1e-9)
    t_np = np.asarray(ts_ex)

    def period(ys):  # scenario_1.py's mean_period
        x = np.asarray(ys)[:, 0]
        pk = np.nonzero((x[1:-1] > x[:-2]) & (x[1:-1] > x[2:]))[0]
        return float(np.diff(t_np[pk + 1]).mean())

    np.testing.assert_allclose([per_rec, per_tru], [period(ex_j.ys), period(tr_j.ys)],
                               rtol=1e-12)


def test_x64_losses_match_the_jax_x64_script(scenario):
    # scenario_1.py --x64: the net, ADAM and BFGS in float64, BFGS on ADAM's
    # loss (rtol = atol = 1e-6) with gtol 1e-10 (scenario_1.py:117-120)
    ts_t, X_t = torch.tensor(scenario["ts"]), torch.tensor(scenario["X_noisy"])
    adam_t, bfgs_t, kw = scen.training_losses(scenario["rhs_t"], ts_t, X_t, x64=True)
    assert kw == dict(gtol=1e-10)
    loss_j = _jax_loss(scenario["rhs_j"], jnp.asarray(scenario["ts"]),
                       jnp.asarray(scenario["X_noisy"]), 1e-6)
    value_j, grad_j = jax.value_and_grad(loss_j)(scenario["p_j"])
    g_ref = np.concatenate([np.concatenate([np.ravel(layer[k]) for k in sorted(layer)])
                            for layer in grad_j])
    for loss_t in (adam_t, bfgs_t):
        leaves = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
                  for layer in scenario["p_t"]]
        value_t = loss_t(leaves)
        assert value_t.dtype == F64
        grads = torch.autograd.grad(value_t, [layer[k] for layer in leaves for k in sorted(layer)])
        np.testing.assert_allclose(float(value_t), float(value_j), rtol=1e-8)
        np.testing.assert_allclose(torch.cat([g.reshape(-1) for g in grads]).numpy(), g_ref,
                                   rtol=1e-6, atol=1e-6 * np.abs(g_ref).max())
    # the default run: BFGS at 1e-8 with gtol 1e-12
    _, _, kw32 = scen.training_losses(scenario["rhs_t"], ts_t, X_t, x64=False)
    assert kw32 == dict(gtol=1e-12)
