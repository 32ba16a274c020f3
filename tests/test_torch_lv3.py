"""PyTorch port: LV scenario 3 (the universal PDE with reaction recovery) against the JAX package (float64).

The stages of ``examples/lv_scenario_3.py`` are held against the JAX
script's computation written with the JAX package (the script keeps it
inside ``main``), at JAX's initial weights carried over by
``params_from_jax``: the right-hand side and the residuals (trajectory
through forward sensitivities, zero-sum penalty, weight decay) to 1e-12, a
Levenberg-Marquardt iteration to 1e-8 (at λ₀ = 30, see ROADMAP §3), the
training stage's ADAM losses to 1e-8, and the SINDy stage on the same
(state, reaction) pairs with the same selection.
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
from universal_differential_equations_torch.examples import lv_scenario_3 as s3
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_tpu import sindy as jsd
from universal_differential_equations_tpu.models import fisher_kpp as jfk
from universal_differential_equations_tpu.nn import MLP as JMLP
from universal_differential_equations_tpu.train import fit as j_fit

torch.set_num_threads(1)

F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def scen3():
    """scenario_3.py's data, model and residuals in the JAX package (x64)."""
    ts, data = jfk.generate_data(dtype=jnp.float64)
    rx = JMLP([1, 5, 5, 5, 1], activation="tanh")
    p_j = {"rx": rx.init(jax.random.PRNGKey(s3.SEED), jnp.float64),
           "w": jnp.array([1.1, -2.5, 1.0]), "D0": jnp.array(6.5)}

    def rhs(t, u, p):
        w = p["w"]
        conv = w[0] * jnp.roll(u, 1) + w[1] * u + w[2] * jnp.roll(u, -1)
        return rx.apply(p["rx"], u[:, None])[:, 0] + p["D0"] * conv

    def residuals(p):
        sol = jude.solve(jude.ODEProblem(rhs, data[0], (0.0, jfk.T_END), p), jude.Tsit5(),
                         saveat=ts, rtol=1e-4, atol=1e-6, adjoint=jude.ForwardSensitivity(),
                         max_steps=192)
        pen = jnp.sqrt(jfk.zero_sum_penalty(p) + 1e-30)
        flat_rx = jravel(p["rx"])[0]
        rr = jnp.sqrt(3e-3 / flat_rx.size) * flat_rx
        return jnp.concatenate([(sol.ys - data).ravel(), pen[None], rr])

    rhs_t, p0_t, rx_t = s3.make_model(torch.Generator().manual_seed(0), dtype=F64)
    ts_t, data_t = torch.tensor(np.asarray(ts)), torch.tensor(np.asarray(data))
    return dict(ts=ts, data=data, rx=rx, p_j=p_j, rhs_j=rhs, res_j=residuals, rhs_t=rhs_t,
                p0_t=p0_t, rx_t=rx_t, ts_t=ts_t, data_t=data_t,
                res_t=s3.make_residuals(rhs_t, ts_t, data_t),
                p_t=tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64))


def test_data_model_and_rhs_match_jax(scen3):
    ts_t, data_t = tude.models.fisher_kpp.generate_data(dtype=F64)
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(scen3["ts"]), rtol=0, atol=0)
    np.testing.assert_allclose(data_t.numpy(), np.asarray(scen3["data"]), rtol=1e-9,
                               atol=1e-9)
    # the same tree {"D0", "rx", "w"}: 76 reaction weights, 3 taps, D0
    assert travel(scen3["p0_t"])[0].numel() == jravel(scen3["p_j"])[0].size == 80
    u = np.random.default_rng(0).uniform(-0.2, 1.2, 26)
    np.testing.assert_allclose(
        scen3["rhs_t"](0.0, torch.tensor(u), scen3["p_t"]).numpy(),
        np.asarray(scen3["rhs_j"](0.0, jnp.asarray(u), scen3["p_j"])), rtol=1e-12, atol=1e-14)


def test_residuals_match_jax(scen3):
    r_t = scen3["res_t"](scen3["p_t"])
    r_j = jax.jit(scen3["res_j"])(scen3["p_j"])
    assert r_t.shape == r_j.shape == (11 * 26 + 1 + 76,)
    assert _rel(r_t.numpy(), r_j) <= 1e-12


def test_lm_iteration_matches_jax(scen3):
    kw = dict(maxiters=1, lam0=30.0)
    res_j = jude.levenberg_marquardt(scen3["res_j"], scen3["p_j"], **kw)
    res_t = tude.levenberg_marquardt(scen3["res_t"], scen3["p_t"], **kw)
    assert res_t.iterations == int(res_j.iterations) == 1
    loss0 = float(jnp.sum(scen3["res_j"](scen3["p_j"]) ** 2))
    assert float(res_t.loss) < loss0  # the step was accepted
    np.testing.assert_allclose(float(res_t.loss), float(res_j.loss), rtol=1e-8)
    x_j = np.asarray(jravel(res_j.params)[0])
    np.testing.assert_allclose(travel(res_t.params)[0].numpy(), x_j, rtol=1e-8,
                               atol=1e-8 * np.abs(x_j).max())


def test_train_stage_adam_matches_jax(scen3):
    # the training stage with 3 ADAM steps and no LM iteration: its round
    # log holds the ADAM loss and the loss at the ADAM point
    def loss_j(p):
        r = scen3["res_j"](p)
        return jnp.sum(r * r)

    aj = j_fit(loss_j, scen3["p_j"], optax.adam(0.01), 3, callback_every=150,
               early_stop_loss=0.005)
    p_t, loss_t, log = s3.train(scen3["res_t"], scen3["p_t"], True, rounds=1, adam_steps=3,
                                lm_iters=0)
    np.testing.assert_allclose(log[0][0], float(aj.losses[-1]), rtol=1e-8)
    np.testing.assert_allclose(loss_t, float(loss_j(aj.params)), rtol=1e-8)
    np.testing.assert_allclose(travel(p_t)[0].numpy(), np.asarray(jravel(aj.params)[0]),
                               rtol=1e-8, atol=1e-10)


def test_sindy_stage_matches_jax(scen3):
    # pairs from the truth states with the true reaction u(1−u) plus numpy
    # noise; and the pairs stage on the initial model
    u = np.asarray(scen3["data"]).reshape(-1, 1)
    r = u * (1 - u) + 1e-3 * np.random.default_rng(1).standard_normal(u.shape)
    basis_j = jsd.monomial_basis(1, 10) + jsd.Basis((jsd.Term("poly", exponents=(0,)),), 1)
    assert s3.scenario_basis().names == basis_j.names
    rj = jsd.sindy(jsd.DirectDataDrivenProblem(jnp.asarray(u), jnp.asarray(r)), basis_j,
                   jsd.STLSQ(s3.LAMS), normalize=True, sampler=jsd.DataSampler(4),
                   exhaustive_k=2, cv_tolerance=100.0)
    rt = s3.recover(torch.tensor(u), torch.tensor(r))
    np.testing.assert_array_equal(rt.active, np.asarray(rj.active))
    assert rt.equations() == rj.equations()
    assert s3.functional_error(rt, dtype=F64) < 0.01
    u_t, r_t = s3.reaction_pairs(scen3["rhs_t"], scen3["rx_t"], scen3["p_t"], scen3["ts_t"],
                                 scen3["data_t"])
    sol = jude.solve(jude.ODEProblem(scen3["rhs_j"], scen3["data"][0], (0.0, jfk.T_END),
                                     scen3["p_j"]), jude.Tsit5(), saveat=scen3["ts"],
                     rtol=1e-6, atol=1e-8, adjoint=jude.NoAdjoint(), max_steps=512)
    u_j = sol.ys.reshape(-1, 1)
    # to the solve's tolerance (rtol 1e-6, atol 1e-8): on this tanh front the
    # late error estimates reach round-off size, where last-bit differences
    # pick other steps (ROADMAP §3, "Round-off-sized error estimates")
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-6, atol=1e-7)
    r_j = jax.vmap(lambda v: scen3["rx"].apply(scen3["p_j"]["rx"], v))(u_j)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-7)
