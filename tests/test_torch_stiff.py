"""PyTorch port: the implicit ODE solvers (Rosenbrock23, SDIRK3, Kvaerno3,
SDIRK4) against the JAX package.

The same float64 inputs, built in numpy from a seed, go through both
packages.  One step agrees to 1e-12 relative with the same ``nfe``; the
tableaus are the JAX ones digit for digit and satisfy the order conditions
to 1e-13; adaptive Robertson solves take JAX's accepted, rejected and RHS
counts with ``y_final`` to 1e-9 relative; ``DiscreteAdjoint`` gradients and
``ForwardSensitivity`` derivatives agree with ``jax.grad``/``jax.jacfwd`` to
1e-8, and ``torch.func.vmap`` over rate constants with ``jax.vmap`` to 1e-9.
An exactly singular iteration matrix ends the solve as it ends JAX's, with
the same counts, instead of raising.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.core.integrate import integrate_fixed as t_fixed
from universal_differential_equations_tpu.core.integrate import integrate_fixed as j_fixed

torch.set_num_threads(1)
# a batching-rule fallback (functorch's "performance drop" warning) is an error
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64
SOLVERS = ["Rosenbrock23", "SDIRK3", "Kvaerno3", "SDIRK4"]
# scipy Radau at rtol 1e-8 (tests/test_stiff_dae.py:23)
ROBER_1E4 = np.array([1.07300429e-01, 4.80016698e-07, 8.92699091e-01])


def _rober(pk):
    def f(t, y, args):
        k1, k2, k3 = 0.04, 3e7, 1e4
        return pk([
            -k1 * y[0] + k3 * y[1] * y[2],
            k1 * y[0] - k2 * y[1] ** 2 - k3 * y[1] * y[2],
            k2 * y[1] ** 2,
        ])
    return f


def _forced(pk, sin):
    """A stiff, nonlinear, time-dependent RHS with parameters in ``a``."""
    def f(t, y, a):
        return pk([
            -a[0] * y[0] + a[1] * y[1] * y[2] + sin(t),
            a[0] * y[0] - a[2] * y[1] ** 2 - a[1] * y[1] * y[2],
            a[2] * y[1] ** 2 - 0.1 * y[2] * sin(2.0 * t),
        ])
    return f


def _decay(pk):
    return lambda t, y, a: pk([-a * y[0], a * y[0] - 1e3 * y[1]])


def _rel(a, b):
    b = np.asarray(b)
    return float(np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("name", SOLVERS)
def test_one_step_equals_jax(name):
    rng = np.random.default_rng(3)
    y = rng.uniform(0.1, 1.0, 3)
    a = np.array([0.04, 10.0, 30.0]) * rng.uniform(0.5, 1.5, 3)
    t, dt = 0.3, 0.05
    fj, ft = _forced(jnp.stack, jnp.sin), _forced(torch.stack, torch.sin)
    aj, at = jnp.asarray(a), torch.tensor(a)
    tj, yj, dtj = jnp.asarray(t), jnp.asarray(y), jnp.asarray(dt)
    tt, yt, dtt = torch.tensor(t, dtype=F64), torch.tensor(y), torch.tensor(dt, dtype=F64)
    outj = getattr(jude, name)().step(fj, tj, yj, fj(tj, yj, aj), dtj, aj)
    outt = getattr(tude, name)().step(ft, tt, yt, ft(tt, yt, at), dtt, at)
    for got, want in zip(outt[:3], outj[:3]):
        assert _rel(got.numpy(), want) < 1e-12
    assert outt[3] == outj[3]


def test_tableaus_are_the_jax_ones_digit_for_digit():
    from universal_differential_equations_torch.solvers import esdirk as tes
    from universal_differential_equations_torch.solvers import sdirk as tsd
    from universal_differential_equations_tpu.solvers import esdirk as jes
    from universal_differential_equations_tpu.solvers import sdirk as jsd

    for name in ("_G", "_C", "_A21", "_B", "_BH", "_NEWTON_ITERS"):
        assert getattr(tsd, name) == getattr(jsd, name), name
    for name in ("_K3_G", "_K3_A", "_K3_B", "_K3_BH", "_K3_C",
                 "_S4_G", "_S4_A", "_S4_B", "_S4_BH", "_S4_C"):
        assert getattr(tes, name) == getattr(jes, name), name
    from universal_differential_equations_torch.solvers import rosenbrock as tro
    from universal_differential_equations_tpu.solvers import rosenbrock as jro

    assert (tro._D, tro._E32) == (jro._D, jro._E32)
    # derived gamma is the exact root of the L-stability cubic
    assert abs(tsd._G**3 - 3 * tsd._G**2 + 1.5 * tsd._G - 1.0 / 6.0) < 1e-15


@pytest.mark.parametrize("kind", ["Kvaerno3", "SDIRK4"])
def test_esdirk_order_conditions_exact(kind):
    # mirrors tests/test_stiff_dae.py::test_esdirk_order_conditions_exact on
    # the port's tableaus
    from universal_differential_equations_torch.solvers import esdirk as es

    A_t, b_t, bh_t, order = {
        "Kvaerno3": (es._K3_A, es._K3_B, es._K3_BH, 3),
        "SDIRK4": (es._S4_A, es._S4_B, es._S4_BH, 4),
    }[kind]
    A, b, bh = np.array(A_t), np.array(b_t), np.array(bh_t)
    c = A.sum(axis=1)
    Ac = A @ c
    conds = [(b.sum(), 1.0), (b @ c, 0.5), (b @ c**2, 1 / 3), (b @ Ac, 1 / 6)]
    if order >= 4:
        conds += [(b @ c**3, 0.25), (b @ (c * Ac), 0.125),
                  (b @ (A @ c**2), 1 / 12), (b @ (A @ Ac), 1 / 24)]
    for got, want in conds:
        assert abs(got - want) < 1e-13
    assert abs(bh.sum() - 1.0) < 1e-13 and abs(bh @ c - 0.5) < 1e-13
    z = -1e9  # L-stability at the stiff limit
    R = 1.0 + z * b @ np.linalg.solve(np.eye(len(b)) - z * A, np.ones(len(b)))
    assert abs(R) < 1e-6


@pytest.mark.parametrize("name,rate", [("Rosenbrock23", 1.6), ("SDIRK3", 2.6),
                                       ("Kvaerno3", 2.6), ("SDIRK4", 3.5)])
def test_integrate_fixed_convergence_rate(name, rate):
    solver = getattr(tude, name)()
    ns = [20, 40, 80] if name == "Rosenbrock23" else [10, 20, 40]
    errs = []
    for n in ns:
        _, ys = t_fixed(lambda t, y, a: y * torch.cos(t), torch.ones(1, dtype=F64),
                        0.0, 3.0, None, solver, n)
        errs.append(abs(float(ys[-1, 0]) - np.exp(np.sin(3.0))))
    assert np.log2(errs[-2] / errs[-1]) > rate
    _, yj = j_fixed(lambda t, y, a: y * jnp.cos(t), jnp.ones(1), 0.0, 3.0, None,
                    getattr(jude, name)(), ns[-1])
    assert _rel(ys[-1].numpy(), yj[-1]) < 1e-12


@pytest.mark.parametrize("name", SOLVERS)
def test_robertson_counts_equal_jax(name):
    kw = dict(rtol=1e-6, atol=1e-10, max_steps=4096)
    sj = jude.solve(jude.ODEProblem(_rober(jnp.stack), jnp.array([1.0, 0.0, 0.0]), (0.0, 1e4)),
                    getattr(jude, name)(), adjoint=jude.NoAdjoint(), **kw)
    st = tude.solve(tude.ODEProblem(_rober(torch.stack), torch.tensor([1.0, 0.0, 0.0], dtype=F64),
                                    (0.0, 1e4)), getattr(tude, name)(), adjoint=tude.NoAdjoint(),
                    **kw)
    assert bool(st.success) and bool(sj.success)
    assert (int(st.num_accepted), int(st.num_rejected), int(st.num_rhs_evals)) == (
        int(sj.num_accepted), int(sj.num_rejected), int(sj.num_rhs_evals))
    assert _rel(st.y_final.numpy(), sj.y_final) < 1e-9
    np.testing.assert_allclose(st.y_final.numpy(), ROBER_1E4, rtol=1e-4)
    assert abs(float(st.y_final.sum()) - 1.0) < 1e-9  # mass conservation


def test_sdirk4_high_order_pays_off():
    # mirrors tests/test_stiff_dae.py::test_sdirk4_high_order_pays_off
    prob = tude.ODEProblem(lambda t, y, a: -(y**3) + torch.sin(t),
                           torch.ones(1, dtype=F64), (0.0, 10.0))
    kw = dict(rtol=1e-8, atol=1e-10, adjoint=tude.NoAdjoint(), max_steps=4096)
    s4 = tude.solve(prob, tude.SDIRK4(), **kw)
    s2 = tude.solve(prob, tude.Rosenbrock23(), **kw)
    assert bool(s4.success) and bool(s2.success)
    assert int(s4.num_accepted) < 0.4 * int(s2.num_accepted)
    np.testing.assert_allclose(float(s4.y_final[0]), float(s2.y_final[0]), rtol=1e-5)


def _decay_loss_jax(name, adjoint):
    def loss(k1):
        prob = jude.ODEProblem(_decay(jnp.stack), jnp.array([1.0, 0.0]), (0.0, 1.0), k1)
        return jude.solve(prob, getattr(jude, name)(), rtol=1e-7, atol=1e-9,
                          adjoint=adjoint, max_steps=256).ys[-1, 0]
    return loss


def _decay_loss_torch(name, adjoint):
    def loss(k1):
        prob = tude.ODEProblem(_decay(torch.stack), torch.tensor([1.0, 0.0], dtype=F64),
                               (0.0, 1.0), k1)
        return tude.solve(prob, getattr(tude, name)(), rtol=1e-7, atol=1e-9,
                          adjoint=adjoint, max_steps=256).ys[-1, 0]
    return loss


@pytest.mark.parametrize("name", ["Rosenbrock23", "SDIRK3", "Kvaerno3"])
def test_discrete_adjoint_gradient_equals_jax(name):
    # the gradient reaches the rate constant through W's LU (JAX's
    # test_rosenbrock_differentiable and its siblings)
    gj = float(jax.grad(_decay_loss_jax(name, jude.DiscreteAdjoint()))(jnp.asarray(0.5)))
    k = torch.tensor(0.5, dtype=F64, requires_grad=True)
    _decay_loss_torch(name, tude.DiscreteAdjoint())(k).backward()
    assert abs(float(k.grad) / gj - 1.0) < 1e-8
    assert abs(gj + np.exp(-0.5)) < 1e-4
    if name == "Rosenbrock23":  # and under torch.func.grad (jacrev inside grad)
        g_func = torch.func.grad(_decay_loss_torch(name, tude.DiscreteAdjoint()))(
            torch.tensor(0.5, dtype=F64))
        assert abs(float(g_func) / gj - 1.0) < 1e-8


def test_forward_sensitivity_through_rosenbrock23_equals_jax():
    dj = float(jax.jacfwd(_decay_loss_jax("Rosenbrock23", jude.ForwardSensitivity()))(
        jnp.asarray(0.5)))
    dt = float(torch.func.jacfwd(_decay_loss_torch("Rosenbrock23", tude.ForwardSensitivity()))(
        torch.tensor(0.5, dtype=F64)))
    assert abs(dt / dj - 1.0) < 1e-8


@pytest.mark.parametrize("name", ["Kvaerno3", "SDIRK4"])
def test_vmap_over_rate_constants_equals_jax(name):
    def run_j(k1):
        prob = jude.ODEProblem(_decay(jnp.stack), jnp.array([1.0, 0.0]), (0.0, 1.0), k1)
        sol = jude.solve(prob, getattr(jude, name)(), rtol=1e-6, atol=1e-9,
                         adjoint=jude.NoAdjoint(), max_steps=256)
        return sol.y_final, sol.success, sol.num_accepted

    def run_t(k1):
        prob = tude.ODEProblem(_decay(torch.stack), torch.tensor([1.0, 0.0], dtype=F64),
                               (0.0, 1.0), k1)
        sol = tude.solve(prob, getattr(tude, name)(), rtol=1e-6, atol=1e-9,
                         adjoint=tude.NoAdjoint(), max_steps=256)
        return sol.y_final, sol.success, sol.num_accepted

    ks = np.linspace(0.3, 0.8, 6)
    yj, okj, nj = jax.vmap(run_j)(jnp.asarray(ks))
    yt, okt, nt = torch.func.vmap(run_t)(torch.tensor(ks))
    assert bool(okt.all()) and bool(okj.all())
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert _rel(yt.numpy(), yj) < 1e-9
    np.testing.assert_allclose(yt[:, 0].numpy(), np.exp(-ks), rtol=1e-5)


@pytest.mark.parametrize("name", SOLVERS)
def test_singular_iteration_matrix_ends_the_solve_like_jax(name):
    # y' = c·y with c chosen so that the first attempt's I − dt·γ·c is
    # exactly 0: JAX's LU solves to inf/NaN and the solve fails at its
    # budget; a raising factorization (torch.linalg.lu_factor) would throw
    from universal_differential_equations_torch.solvers import rosenbrock, sdirk

    gamma = {"Rosenbrock23": rosenbrock._D, "SDIRK3": sdirk._G, "Kvaerno3": sdirk._G,
             "SDIRK4": 0.25}[name]
    dt0 = 0.5
    c = 1.0 / (dt0 * gamma)
    assert 1.0 - (dt0 * gamma) * c == 0.0  # exactly singular
    kw = dict(rtol=1e-6, atol=1e-9, dt0=dt0, max_steps=12)
    sj = jude.solve(jude.ODEProblem(lambda t, y, a: c * y, jnp.ones(1), (0.0, 1.0)),
                    getattr(jude, name)(), adjoint=jude.NoAdjoint(), **kw)
    st = tude.solve(tude.ODEProblem(lambda t, y, a: c * y, torch.ones(1, dtype=F64), (0.0, 1.0)),
                    getattr(tude, name)(), adjoint=tude.NoAdjoint(), **kw)
    assert bool(st.success) == bool(sj.success)
    assert (int(st.num_accepted), int(st.num_rejected), int(st.num_rhs_evals)) == (
        int(sj.num_accepted), int(sj.num_rejected), int(sj.num_rhs_evals))
