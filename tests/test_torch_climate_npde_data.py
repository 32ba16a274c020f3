"""PyTorch port: the neural PDE trained on Rayleigh-Taylor averages
(``examples/climate_neural_pde_data.py``) against the JAX package.

The 32-level column built from the committed averages equals the JAX
script's; its initial loss through Tsit5 and the interpolating adjoint, and
the gradient of the reference protocol's loss through ROCK4's interpolating
adjoint (16 levels, ρ·2.5, rtol 1e-5), equal JAX's with the same weights
(float64); the script runs end to end at a tiny budget, the reference
protocol writes its bar under the output directory, and ``--data reference``
raises naming the missing file.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.convert import params_from_jax
from universal_differential_equations_torch.examples import climate_neural_pde_data as tx
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_torch.models import climate_npde as tcn
from universal_differential_equations_tpu.models import climate_npde as jcn
from universal_differential_equations_tpu.models.climate_datagen import coarse_grain as jcg

torch.set_num_threads(1)

F64 = torch.float64


def _jax_column(n_grid):
    """The JAX script's column from the committed averages, in float64."""
    with np.load(tx.DATA) as d:
        t, b = d["t"], d["b"]
    if b.shape[1] != n_grid:
        b = np.asarray(jcg(b, b.shape[1] // n_grid))
    ts = jnp.asarray(t, jnp.float32).astype(jnp.float64)
    data = jnp.asarray(b[:, 1:-1], jnp.float32).astype(jnp.float64)
    return t, b, ts, data


def _models(n_grid):
    """JAX's net, weights and RHS, and the port's RHS with those weights."""
    n = n_grid - 2
    D1, D2, eig = jcn.getops(n_grid, dtype=jnp.float64)
    net = jude.MLP([n] * 6, activation="tanh", final_activation="tanh")
    p0 = net.init(jax.random.PRNGKey(0), jnp.float64)
    rhs_j = lambda tt, u, p: D1 @ net.apply(p, u) + D2 @ u  # noqa: E731
    D1t, D2t, _ = tcn.getops(n_grid, dtype=F64)
    rhs_t, _, _ = tx.make_model(n, D1t, D2t, "cpu")
    p0_t = params_from_jax(jax.tree.map(np.asarray, p0), dtype=F64)
    return eig, p0, rhs_j, p0_t, rhs_t


def test_column_equals_the_jax_script():
    t, b, ts_j, data_j = _jax_column(32)
    with np.load(tx.DATA) as d:
        ts, data, u0 = tx.column(d["t"], d["b"], 32, "cpu")
    assert data.shape == (41, 30) and data.dtype == torch.float32
    np.testing.assert_array_equal(data.double().numpy(), np.asarray(data_j))
    np.testing.assert_array_equal(ts.double().numpy(), np.asarray(ts_j))
    np.testing.assert_array_equal(u0.numpy(), data[0].numpy())


def test_initial_loss_equals_jax():
    _, _, ts_j, data_j = _jax_column(32)
    eig, p0, rhs_j, p0_t, rhs_t = _models(32)
    tspan = (float(ts_j[0]), float(ts_j[-1]))
    sol = jude.solve(jude.ODEProblem(rhs_j, data_j[0], tspan, p0), jude.Tsit5(), saveat=ts_j,
                     rtol=1e-4, atol=1e-6, adjoint=jude.InterpolatingAdjoint(), max_steps=2048)
    l_j = float(jnp.sum((sol.ys - data_j) ** 2))
    ts, data = (torch.as_tensor(np.asarray(a)) for a in (ts_j, data_j))
    loss = tx.make_loss(rhs_t, data[0], tspan, ts, data, tude.Tsit5(), 1e-4, 1e-6, 2048)
    np.testing.assert_allclose(float(loss(p0_t)), l_j, rtol=1e-9)


def test_rock4_adjoint_gradient_of_the_reference_protocol_equals_jax():
    """The loss the reference protocol trains: ROCK4 (ρ·2.5, sized for 200
    steps) under the interpolating adjoint at rtol 1e-5, 16 levels."""
    _, _, ts_j, data_j = _jax_column(16)
    eig, p0, rhs_j, p0_t, rhs_t = _models(16)
    tspan = (float(ts_j[0]), float(ts_j[-1]))
    solver_j = jude.ROCK4.for_problem(eig * 2.5, tspan, n_steps_hint=200)

    def loss_j(p):
        sol = jude.solve(jude.ODEProblem(rhs_j, data_j[0], tspan, p), solver_j, saveat=ts_j,
                         rtol=1e-5, atol=1e-6, adjoint=jude.InterpolatingAdjoint(),
                         max_steps=8192)
        return jnp.sum((sol.ys - data_j) ** 2)

    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(p0)
    ts, data = (torch.as_tensor(np.asarray(a)) for a in (ts_j, data_j))
    solver_t = tude.ROCK4.for_problem(eig * 2.5, tspan, n_steps_hint=200)
    assert solver_t.stages == solver_j.stages
    loss = tx.make_loss(rhs_t, data[0], tspan, ts, data, solver_t, 1e-5, 1e-6, 8192)
    flat, unravel = travel(p0_t)
    x = flat.clone().requires_grad_(True)
    l_t = loss(unravel(x))
    (g_t,) = torch.autograd.grad(l_t, x)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-9)
    g_ref = np.asarray(jravel(g_j)[0])
    np.testing.assert_allclose(g_t.numpy(), g_ref, rtol=1e-6, atol=1e-6 * np.abs(g_ref).max())


def test_main_and_the_reference_bar_run_end_to_end(tmp_path):
    out = tx.main(quick=True, device="cpu", adam_steps=2, out_dir=tmp_path)
    assert out["levels"] == 16 and out["adam_steps"] == 2
    assert out["best"] < out["l0"] and out["gates"]["rkc2"]
    bar = tx.main(quick=True, device="cpu", reference_bar=True, out_dir=tmp_path)
    saved = json.loads((tmp_path / "npde_ref_protocol.json").read_text())
    assert saved["rel_l2"] == bar["reference_bar"]["rel_l2"] and saved["rollout_success"]
    assert len(saved["losses"]) == 20 and saved["losses"][-1] < saved["losses"][0]
    with pytest.raises(FileNotFoundError, match="rayleigh_taylor_instability_3d"):
        tx.main(device="cpu", source="reference")
