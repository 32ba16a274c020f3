"""PyTorch port: the public surface slice A′ adds, against the JAX package.

The four explicit RK tables (Dopri5, Bosh3, Euler, Heun) equal JAX's digit
for digit, keep their convergence orders (as ``tests/test_solver_convergence.py``
measures them) and solve Lotka-Volterra as JAX does (float64: the same step
counts, states to 1e-8 relative); ``StencilConv1D.apply`` equals JAX's to
1e-12 with the weights handed across; ``neural_ode`` and ``NeuralODE`` equal
JAX's (states to 1e-8 relative, gradients to 1e-6 relative), mirroring
``tests/test_ops_misc.py::test_neural_ode_wrapper``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.core.integrate import integrate_fixed
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_tpu.solvers.tableaus import TABLEAUS as JTABLEAUS

torch.set_num_threads(1)

F64 = torch.float64
NEW = ["Dopri5", "Bosh3", "Euler", "Heun"]


@pytest.mark.parametrize("name", NEW)
def test_tableau_equals_jax_digit_for_digit(name):
    solver = getattr(tude, name)()
    assert dataclasses.asdict(solver.tableau) == dataclasses.asdict(JTABLEAUS[name])
    assert solver.name == name
    assert solver.dense_nodes == getattr(jude, name)().dense_nodes


def _order_of(solver, expect):
    """The empirical order of ``integrate_fixed`` on y' = y·cos t over [0, 3]
    (the JAX test's problem and step counts), float64."""
    f = lambda t, y, args: y * torch.cos(t)  # noqa: E731
    y0 = torch.tensor([1.0], dtype=F64)
    exact = np.exp(np.sin(3.0))
    ns = [10, 20, 40] if expect < 6 else [10, 15, 20, 30]
    errs = []
    for n in ns:
        _, ys = integrate_fixed(f, y0, 0.0, 3.0, None, solver, n)
        errs.append(abs(float(ys[-1, 0]) - exact) + 1e-300)
    return np.log(errs[-2] / errs[-1]) / np.log(ns[-1] / ns[-2])


@pytest.mark.parametrize("name,expect", [("Bosh3", 3), ("Dopri5", 5), ("Heun", 2),
                                         ("Euler", 1)])
def test_convergence_order(name, expect):
    order = _order_of(getattr(tude, name)(), expect)
    assert order > expect - 0.45, f"{name}: measured order {order}"


def _lv(t, u, p):
    x, y = u[0], u[1]
    return [p[0] * x - p[1] * x * y, -p[2] * y + p[3] * x * y]


@pytest.mark.parametrize("name", ["Dopri5", "Bosh3", "Heun"])
def test_lotka_volterra_solve_matches_jax(name):
    p = np.array([1.3, 0.9, 0.8, 1.8])
    u0 = np.array([0.44249296, 4.6280594])
    ts = np.linspace(0.0, 3.0, 13)
    kw = dict(rtol=1e-6, atol=1e-6, max_steps=8192)
    sol_j = jude.solve(
        jude.ODEProblem(lambda t, u, a: jnp.stack(_lv(t, u, a)), jnp.asarray(u0), (0.0, 3.0),
                        jnp.asarray(p)),
        getattr(jude, name)(), saveat=jnp.asarray(ts), adjoint=jude.NoAdjoint(), **kw)
    sol_t = tude.solve(
        tude.ODEProblem(lambda t, u, a: torch.stack(_lv(t, u, a)), torch.tensor(u0), (0.0, 3.0),
                        torch.tensor(p)),
        getattr(tude, name)(), saveat=torch.tensor(ts), adjoint=tude.NoAdjoint(), **kw)
    assert bool(sol_t.success) and bool(sol_j.success)
    assert int(sol_t.num_accepted) == int(sol_j.num_accepted)
    assert int(sol_t.num_rejected) == int(sol_j.num_rejected)
    np.testing.assert_allclose(sol_t.ys.numpy(), np.asarray(sol_j.ys), rtol=1e-8, atol=0)


@pytest.mark.parametrize("taps", [3, 5])
@pytest.mark.parametrize("shape", [(26,), (4, 17)])
def test_stencil_conv1d_matches_jax(taps, shape):
    layer_j, layer_t = jude.StencilConv1D(taps), tude.StencilConv1D(taps)
    p_j = layer_j.init(jax.random.PRNGKey(taps), jnp.float64)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64)
    x = np.random.default_rng(taps).standard_normal(shape)
    out_j = np.asarray(layer_j(p_j, jnp.asarray(x)))
    out_t = layer_t(p_t, torch.tensor(x)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-12, atol=1e-12)
    # the port's own init: the JAX init's shape, scale and dtype
    w = layer_t.init(torch.Generator().manual_seed(0), F64)["w"]
    assert w.shape == (taps,) and w.dtype == F64 and float(w.abs().max()) < 1.0


@pytest.mark.parametrize("time_input", [False, True])
def test_neural_ode_matches_jax(time_input):
    sizes = [3 if time_input else 2, 8, 2]
    net_j, net_t = jude.MLP(sizes, activation="tanh"), tude.MLP(sizes, activation="tanh")
    p_j = net_j.init(jax.random.PRNGKey(0), jnp.float64)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64)
    u0 = np.array([1.0, -1.0])
    ts = np.linspace(0.0, 1.0, 5)
    sol_j = jude.neural_ode(net_j, p_j, jnp.asarray(u0), (0.0, 1.0), saveat=jnp.asarray(ts),
                            time_input=time_input)
    sol_t = tude.neural_ode(net_t, p_t, torch.tensor(u0), (0.0, 1.0), saveat=torch.tensor(ts),
                            time_input=time_input)
    assert sol_t.ys.shape == (5, 2) and bool(sol_t.success)
    np.testing.assert_allclose(sol_t.ys.numpy(), np.asarray(sol_j.ys), rtol=1e-8, atol=1e-12)


def test_neural_ode_layer_and_its_gradient_match_jax():
    net_j, net_t = jude.MLP([2, 8, 2], activation="tanh"), tude.MLP([2, 8, 2], activation="tanh")
    p_j = net_j.init(jax.random.PRNGKey(0), jnp.float64)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64)
    u0 = np.array([1.0, -1.0])
    layer_j, layer_t = jude.NeuralODE(net_j, (0.0, 0.5)), tude.NeuralODE(net_t, (0.0, 0.5))
    y_j = np.asarray(layer_j(p_j, jnp.asarray(u0)))
    y_t = layer_t(p_t, torch.tensor(u0))
    assert y_t.shape == (2,)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-8, atol=1e-12)
    # differentiable through the default (interpolating) adjoint
    g_j = jravel(jax.grad(lambda p: layer_j(p, jnp.asarray(u0)).sum())(p_j))[0]
    flat, unravel = travel(p_t)
    g_t = torch.func.grad(lambda x: layer_t(unravel(x), torch.tensor(u0)).sum())(flat)
    assert bool(torch.isfinite(g_t).all())
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-12)


# the public names of slice H.1, each against its JAX name


def test_utils_reexports_match_jax():
    import universal_differential_equations_torch.utils as tu
    import universal_differential_equations_tpu.utils as ju

    for name in ("benchmark", "StepTimer", "trace", "ravel_pytree"):
        assert name in ju.__all__ and name in tu.__all__ and callable(getattr(tu, name))
    tree = {"b": [torch.ones(2), torch.arange(3.0)], "a": torch.full((2, 2), 5.0)}
    flat_t, unravel = tu.ravel_pytree(tree)
    flat_j, _ = ju.ravel_pytree(jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    assert torch.equal(unravel(flat_t)["b"][1], tree["b"][1])
    timer = tu.StepTimer()
    timer.tick()
    stats = tu.benchmark(lambda: torch.ones(3).sum(), repeats=2, warmup=0)
    assert set(stats) == set(ju.benchmark(lambda: jnp.ones(3).sum(), repeats=2, warmup=0))


def test_gaussian_rbf_is_rbf_like_jax():
    from universal_differential_equations_torch import nn as tnn
    from universal_differential_equations_tpu import nn as jnn

    x = np.linspace(-2.0, 2.0, 9)
    assert tnn.gaussian_rbf is tnn.rbf and jnn.gaussian_rbf is jnn.rbf
    np.testing.assert_allclose(tnn.gaussian_rbf(torch.as_tensor(x)).numpy(),
                               np.asarray(jnn.gaussian_rbf(jnp.asarray(x))), rtol=1e-15)


def test_solution_stats_and_dense_span_match_jax():
    def lv(t, u, p):
        return (jnp if isinstance(u, jax.Array) else torch).stack(
            [p[0] * u[0] - p[1] * u[0] * u[1], p[2] * u[0] * u[1] - p[3] * u[1]])

    p = np.array([1.3, 0.9, 0.8, 1.8])
    u0 = np.array([0.44249296, 4.6280594])
    for span in ((0.0, 3.0), (3.0, 0.5)):
        st = tude.solve(tude.ODEProblem(lv, torch.as_tensor(u0), span, torch.as_tensor(p)),
                        tude.Tsit5(), rtol=1e-8, atol=1e-10, dense=True,
                        adjoint=tude.NoAdjoint())
        sj = jude.solve(jude.ODEProblem(lv, jnp.asarray(u0), span, jnp.asarray(p)),
                        jude.Tsit5(), rtol=1e-8, atol=1e-10, dense=True,
                        adjoint=jude.NoAdjoint())
        assert {k: int(v) for k, v in st.stats.items()} == {k: int(v)
                                                            for k, v in sj.stats.items()}
        assert float(st.dense.t0) == float(sj.dense.t0) == span[0]
        assert float(st.dense.t1) == pytest.approx(float(sj.dense.t1), rel=1e-14)
        assert float(st.dense.t1) == pytest.approx(span[1], rel=1e-12)


def test_chain_flat_view_matches_jax_layout():
    jnet = jude.MLP([2, 4, 3, 1], activation="tanh")
    tnet = tude.MLP([2, 4, 3, 1], activation="tanh")
    jflat, junravel = jnet.flat_init(jax.random.PRNGKey(0))
    tflat, tunravel = tnet.flat_init(torch.Generator().manual_seed(0), F64)
    assert tflat.shape == jflat.shape and tflat.dtype == F64
    # the same flat vector means the same network in both packages
    theta = np.random.default_rng(1).standard_normal(jflat.shape[0])
    x = np.array([0.3, -0.7])
    yt = tnet.make_apply_flat(torch.Generator(), F64)(torch.as_tensor(theta), torch.as_tensor(x))
    yj = jnet.make_apply_flat(jax.random.PRNGKey(0))(jnp.asarray(theta, jnp.float32),
                                                     jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5)
    np.testing.assert_array_equal(travel(tunravel(tflat))[0].numpy(), tflat.numpy())
