"""PyTorch port: LV scenario 2 and the Hudson Bay pipeline against the JAX package (float64).

The stages of ``examples/lv_scenario_2.py`` and ``examples/hudson_bay.py``
are held against the same computation written with the JAX package (the
JAX scripts keep theirs inside ``main``), at JAX's initial parameters carried
over by ``params_from_jax``:

* scenario 2: the data (JAX's noise draws) and segments exactly; the
  segment residuals — 5 vmapped ``ForwardSensitivity`` solves — to 1e-9
  relative; one Levenberg-Marquardt iteration through ``jacfwd`` to 1e-6
  relative; SINDy with the scenario's selection objective ``g`` picks the
  same supports;
* Hudson Bay: the data; the shooting loss and its gradient; the full-record
  residuals and their LM Jacobian; direct SINDy by collocation (the same
  supports and fitted values); and one post-fit LM iteration of a recovered
  model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch import sindy as tsd
from universal_differential_equations_torch.examples import hudson_bay as thb
from universal_differential_equations_torch.examples import lv_scenario_2 as s2
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_tpu import sindy as jsd
from universal_differential_equations_tpu.models import lotka_volterra as jlv
from universal_differential_equations_tpu.nn import MLP as JMLP
from universal_differential_equations_tpu.nn import Chain as JChain
from universal_differential_equations_tpu.nn import Dense as JDense
from universal_differential_equations_tpu.train import levenberg_marquardt as j_lm
from universal_differential_equations_tpu.train import multiple_shoot as j_shoot

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# -- LV scenario 2 ------------------------------------------------------------


@pytest.fixture(scope="module")
def scen2():
    """scenario_2.py's data, model and residuals in the JAX package (x64)."""
    kd, kn, kp = jax.random.split(jax.random.PRNGKey(s2.SEED), 3)
    ts, X, Xn = jlv.generate_data(kd, tspan=(0.0, 6.0), rtol=1e-6, atol=1e-6)
    draws = np.asarray(jax.random.normal(kd, X.shape, jnp.float64))
    net = JMLP([2, 5, 5, 5, 2], activation="rbf")
    p_j = {"delta": jax.random.uniform(kp, ()), "nn": net.init(kn)}
    alpha = float(jlv.P_TRUE[0])

    def rhs(t, u, p):
        uhat = net.apply(p["nn"], u)
        return jnp.stack([alpha * u[0] + uhat[0], -p["delta"] * u[1] + uhat[1]])

    seg_len = (len(ts) - 1) // s2.N_SEG
    starts = np.arange(s2.N_SEG) * seg_len
    seg_ts = jnp.stack([ts[s:s + seg_len + 1] for s in starts])
    seg_x = jnp.stack([Xn[s:s + seg_len + 1, 0] for s in starts])
    y_left = jnp.asarray([Xn[s, 1] for s in starts])
    y_right = jnp.asarray([Xn[s + seg_len, 1] for s in starts])
    seg_span = float(seg_ts[0, -1]) - float(seg_ts[0, 0])

    def residuals(p):
        def seg(x0, y0, tw):
            prob = jude.ODEProblem(rhs, jnp.stack([x0, y0]), (0.0, seg_span), p)
            return jude.solve(prob, jude.Tsit5(), saveat=tw - tw[0], rtol=1e-6, atol=1e-6,
                              adjoint=jude.ForwardSensitivity(), max_steps=128).ys

        flat = jravel(p["nn"])[0]
        preds = jax.vmap(seg)(seg_x[:, 0], y_left, seg_ts)
        return jnp.concatenate([(preds[:, :, 0] - seg_x).ravel(),
                                3.0 * (preds[:, -1, 1] - y_right),
                                jnp.sqrt(1e-3 / flat.size) * flat])

    ts_t, X_t, Xn_t = s2.make_data(draws, dtype=F64)
    rhs_t, p0_t, _ = s2.make_model(torch.Generator().manual_seed(0), dtype=F64)
    res_t = s2.make_residuals(rhs_t, *s2.segments(ts_t, Xn_t))
    return dict(ts=np.asarray(ts), X=np.asarray(X), Xn=np.asarray(Xn), seg_ts=seg_ts,
                seg_x=seg_x, y_left=y_left, y_right=y_right, p_j=p_j, res_j=residuals,
                ts_t=ts_t, X_t=X_t, Xn_t=Xn_t, res_t=res_t, p0_t=p0_t,
                p_t=tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64))


def test_scenario2_data_segments_and_model(scen2):
    np.testing.assert_allclose(scen2["ts_t"].numpy(), scen2["ts"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(scen2["X_t"].numpy(), scen2["X"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(scen2["Xn_t"].numpy(), scen2["Xn"], rtol=1e-12, atol=1e-12)
    seg_ts, seg_x, y_left, y_right = s2.segments(scen2["ts_t"], scen2["Xn_t"])
    for a, b in ((seg_ts, "seg_ts"), (seg_x, "seg_x"), (y_left, "y_left"),
                 (y_right, "y_right")):
        np.testing.assert_allclose(a.numpy(), np.asarray(scen2[b]), rtol=1e-12, atol=1e-12)
    assert tuple(seg_ts.shape) == (5, 13)
    # the same tree as JAX's {"delta", "nn"}: 88 parameters, delta first
    assert travel(scen2["p0_t"])[0].numel() == jravel(scen2["p_j"])[0].size == 88


def test_scenario2_residuals_match_jax(scen2):
    r_t = scen2["res_t"](scen2["p_t"])
    r_j = jax.jit(scen2["res_j"])(scen2["p_j"])
    assert r_t.shape == (5 * 13 + 5 + 87,)
    assert _rel(r_t.numpy(), r_j) <= 1e-9


def test_scenario2_lm_iteration_matches_jax(scen2):
    # one LM iteration: the Jacobian is jacfwd through the 5 vmapped
    # ForwardSensitivity solves
    r_t = tude.levenberg_marquardt(scen2["res_t"], scen2["p_t"], maxiters=1)
    r_j = j_lm(scen2["res_j"], scen2["p_j"], maxiters=1)
    assert _rel(travel(r_t.params)[0].numpy(), jravel(r_j.params)[0]) <= 1e-6
    assert abs(float(r_t.loss) - float(r_j.loss)) <= 1e-7 * float(r_j.loss)


def test_scenario2_selection_objective_matches_jax(scen2):
    # SINDy with the scenario's g on the true interactions along the truth
    def g_j(k, rss, N):
        return jnp.where(k <= 1, jnp.inf, 2.0 * k + N * jnp.log(rss / N))

    X = scen2["X"]
    xy = X[:, 0] * X[:, 1]
    Y = np.stack([-0.9 * xy, 0.8 * xy], -1) + 1e-3 * np.random.default_rng(2).standard_normal(
        X.shape)
    lams = tuple(10.0 ** e for e in np.arange(-3.0, 2.0, 0.5))
    kw = dict(normalize=True, sampler=jsd.DataSampler(4), exhaustive_k=2)
    res_j = jsd.sindy(jsd.DirectDataDrivenProblem(jnp.asarray(X), jnp.asarray(Y)),
                      jsd.polynomial_basis(2, 3) + jsd.sin_basis(2), jsd.STLSQ(lams),
                      selection=g_j, **kw)
    kw["sampler"] = tsd.DataSampler(4)
    res_t = tsd.sindy(tsd.DirectDataDrivenProblem(torch.tensor(X), torch.tensor(Y)),
                      tsd.polynomial_basis(2, 3) + tsd.sin_basis(2), tsd.STLSQ(lams),
                      selection=s2.selection_g, **kw)
    np.testing.assert_array_equal(res_t.active, res_j.active)
    np.testing.assert_allclose(res_t.coefficients, res_j.coefficients, rtol=1e-8, atol=1e-12)
    k, rss = np.array([1, 2, 3]), np.array([0.5, 0.5, 0.2])
    np.testing.assert_allclose(s2.selection_g(torch.tensor(k), torch.tensor(rss), 31).numpy(),
                               np.asarray(g_j(jnp.asarray(k), jnp.asarray(rss), 31)))


# -- Hudson Bay ---------------------------------------------------------------


@pytest.fixture(scope="module")
def hudson():
    """hudson_bay.py's data and model at seed 11 in the JAX package (x64)."""
    raw = np.loadtxt(thb.DATA)
    t = raw[:, 0] - raw[0, 0]
    Xn = raw[:, 1:3] / raw[:, 1:3].max(axis=0)
    net = JChain((JDense(2, 5, "rbf"), JDense(5, 5, "rbf"), JDense(5, 5, "tanh"),
                  JDense(5, 2)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    p_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                       {"lin": jax.random.uniform(k1, (2,)), "nn": net.init(k2)})

    def rhs(tt, u, p):
        uhat = net.apply(p["nn"], u)
        return jnp.stack([p["lin"][0] * u[0] + uhat[0], -p["lin"][1] * u[1] + uhat[1]])

    def shooting_loss(p):
        flat = jravel(p["nn"])[0]
        return j_shoot(p, jnp.asarray(Xn), jnp.asarray(t), rhs, group_size=5,
                       continuity_term=200.0, rtol=1e-6, atol=1e-6,
                       max_steps=256) + 1e-3 * jnp.mean(flat**2)

    def full_residuals(p):
        sol = jude.solve(jude.ODEProblem(rhs, jnp.asarray(Xn[0]), (0.0, float(t[-1])), p),
                         jude.Tsit5(), saveat=jnp.asarray(t), rtol=1e-6, atol=1e-6,
                         adjoint=jude.ForwardSensitivity(), max_steps=512)
        flat = jravel(p["nn"])[0]
        return jnp.concatenate([((sol.ys - Xn) / np.sqrt(Xn.shape[0])).ravel(),
                                jnp.sqrt(1e-3 / flat.size) * flat])

    rhs_t = thb.make_rhs(thb.make_net())
    t_t, Xn_t, _ = thb.load_data(F64)
    return dict(t=t, Xn=Xn, p_j=p_j, shoot_j=shooting_loss, full_j=full_residuals,
                rhs_t=rhs_t, t_t=t_t, Xn_t=Xn_t,
                p_t=tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64))


def test_hudson_data_and_model(hudson):
    np.testing.assert_array_equal(hudson["t_t"].numpy(), hudson["t"])
    np.testing.assert_allclose(hudson["Xn_t"].numpy(), hudson["Xn"], rtol=1e-15)
    assert hudson["Xn_t"].shape == (21, 2) and float(hudson["Xn_t"].max()) == 1.0
    # the model's own initial parameters have JAX's tree: 2 + 87 entries
    p0 = thb.init_params(thb.make_net(), 11, F64)
    assert travel(p0)[0].numel() == jravel(hudson["p_j"])[0].size == 89
    u = np.array([0.4, 0.7])
    np.testing.assert_allclose(hudson["rhs_t"](0.0, torch.tensor(u), hudson["p_t"]).numpy(),
                               _jax_rhs_value(hudson, u), rtol=1e-13)


def _jax_rhs_value(hudson, u):
    net = JChain((JDense(2, 5, "rbf"), JDense(5, 5, "rbf"), JDense(5, 5, "tanh"),
                  JDense(5, 2)))
    p = hudson["p_j"]
    uhat = net.apply(p["nn"], jnp.asarray(u))
    return np.asarray(jnp.stack([p["lin"][0] * u[0] + uhat[0], -p["lin"][1] * u[1] + uhat[1]]))


def test_hudson_shooting_loss_and_gradient_match_jax(hudson):
    flat, unravel = travel(hudson["p_t"])
    x = flat.clone().requires_grad_(True)
    v_t = thb.shooting_loss(hudson["rhs_t"], hudson["t_t"], hudson["Xn_t"])(unravel(x))
    (g_t,) = torch.autograd.grad(v_t, x)
    v_j, g_j = jax.jit(jax.value_and_grad(hudson["shoot_j"]))(hudson["p_j"])
    assert abs(float(v_t.detach()) - float(v_j)) <= 1e-9 * abs(float(v_j))
    assert _rel(g_t.numpy(), jravel(g_j)[0]) <= 1e-7


def test_hudson_full_residuals_and_jacobian_match_jax(hudson):
    res_t = thb.full_residuals(hudson["rhs_t"], hudson["t_t"], hudson["Xn_t"])
    flat, unravel = travel(hudson["p_t"])
    r_t = res_t(hudson["p_t"])
    flat_j, unravel_j = jravel(hudson["p_j"])
    r_j = jax.jit(hudson["full_j"])(hudson["p_j"])
    assert r_t.shape == (42 + 87,)
    assert _rel(r_t.numpy(), r_j) <= 1e-9
    J_t = torch.func.jacfwd(lambda x: res_t(unravel(x)))(flat)
    J_j = jax.jit(jax.jacfwd(lambda x: hudson["full_j"](unravel_j(x))))(flat_j)
    assert _rel(J_t.numpy(), J_j) <= 1e-7


def test_hudson_direct_sindy_matches_jax(hudson):
    basis_j = jsd.polynomial_basis(2, 5) + jsd.sin_basis(2)
    res_j = jsd.sindy(jsd.ContinuousDataDrivenProblem(jnp.asarray(hudson["Xn"]),
                                                      jnp.asarray(hudson["t"])),
                      basis_j, jsd.STLSQ(thb.LAMS), normalize=True, denoise=True,
                      sampler=jsd.DataSampler(4), exhaustive_k=2)
    res_t = thb.direct_sindy(hudson["t_t"], hudson["Xn_t"], thb.scenario_basis())
    # the same supports and residuals; Θ of the 21 collocated points has
    # condition ~6e12, so coefficients along its near-null directions differ
    # at the percent level from rounding alone, while the fitted values agree
    np.testing.assert_array_equal(res_t.active, res_j.active)
    np.testing.assert_allclose(res_t.l2_error, res_j.l2_error, rtol=1e-6)
    X, _ = jsd.collocate_data(jnp.asarray(hudson["Xn"]), jnp.asarray(hudson["t"]))
    theta = np.asarray(basis_j.theta(X))
    assert _rel(theta @ res_t.coefficients, theta @ res_j.coefficients) <= 1e-4


def test_hudson_postfit_residuals_match_jax(hudson):
    # a recovered model with x·y interactions, its LM residuals and one
    # post-fit iteration against the same written with the JAX package
    basis = thb.scenario_basis()
    j = basis.names.index("u1*u2")
    C = np.zeros((len(basis), 2))
    C[j] = [-0.9, 0.7]
    act = C != 0
    res = tsd.SINDyResult(basis=basis, coefficients=C, active=act, l2_error=np.zeros(2),
                          sparsity=act.sum(0), aicc=np.zeros(2), scores=np.zeros(2),
                          chosen_thresholds=np.zeros(2))
    rec_t = thb.recovered_rhs(res)
    p0 = {"lin": torch.tensor([0.55, 0.8], dtype=F64), "coef": torch.tensor([-0.9, 0.7],
                                                                               dtype=F64)}
    out_t = thb.postfit(rec_t, p0, hudson["t_t"], hudson["Xn_t"], maxiters=1)

    basis_j = jsd.polynomial_basis(2, 5) + jsd.sin_basis(2)

    def rec_j(tt, u, p):
        z = basis_j.theta(u[None, :])[0][j] * p["coef"]
        return jnp.stack([p["lin"][0] * u[0] + z[0], -p["lin"][1] * u[1] + z[1]])

    Xn = jnp.asarray(hudson["Xn"])

    def resid(p):
        sol = jude.solve(jude.ODEProblem(rec_j, Xn[0], (0.0, 20.0), p), jude.Tsit5(),
                         saveat=jnp.asarray(hudson["t"]), rtol=1e-6, atol=1e-6,
                         adjoint=jude.ForwardSensitivity(), max_steps=512)
        return (sol.ys - Xn).ravel()

    out_j = j_lm(resid, {k: jnp.asarray(v.numpy()) for k, v in p0.items()}, maxiters=1)
    assert _rel(travel(out_t.params)[0].numpy(), jravel(out_j.params)[0]) <= 1e-8
    assert abs(float(out_t.loss) - float(out_j.loss)) <= 1e-9 * float(out_j.loss)
