"""PyTorch port: the continuous adjoints against the JAX package's (float64).

The Lotka-Volterra UDE loss of scenario 1 (the 2→5→5→5→2 RBF net with the
JAX package's initial parameters, carried over by ``params_from_jax``; the
data from JAX's ``generate_data``) is differentiated at rtol = atol = 1e-8
through each continuous adjoint, seminorm off and on.  The port's gradient
agrees with JAX's same adjoint to 1e-7 relative and with the port's
``DiscreteAdjoint`` to 1e-5 relative.  ``torch.func.grad`` through the
default adjoint agrees with ``jax.grad`` through JAX's.  The guards (the forward-success gate,
non-float ``args``, a missing cotangent) mirror ``tests/test_adjoint.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_torch.models import lotka_volterra as tlv
from universal_differential_equations_tpu.models import lotka_volterra as jlv

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-8


@pytest.fixture(scope="module")
def lv_case():
    """The scenario's loss inputs from the JAX package, as numpy (float64)."""
    ts, _, X = jlv.generate_data(jax.random.PRNGKey(1234))
    rhs_j, p_j, _ = jlv.make_ude(jax.random.PRNGKey(0), dtype=jnp.float64)
    rhs_t, _, _ = tlv.make_ude(torch.Generator().manual_seed(0), dtype=F64)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), dtype=F64)
    return dict(ts=np.asarray(ts), X=np.asarray(X), rhs_j=rhs_j, p_j=p_j,
                rhs_t=rhs_t, p_t=p_t)


def _jax_grad(case, adjoint):
    ts, X = jnp.asarray(case["ts"]), jnp.asarray(case["X"])

    def loss(p):
        sol = jude.solve(jude.ODEProblem(case["rhs_j"], X[0], (0.0, 3.0), p), jude.Tsit5(),
                         saveat=ts, rtol=TOL, atol=TOL, adjoint=adjoint)
        return jnp.mean((sol.ys - X) ** 2)

    return np.asarray(jravel(jax.jit(jax.grad(loss))(case["p_j"]))[0])


def _torch_grad(case, adjoint):
    ts, X = torch.tensor(case["ts"]), torch.tensor(case["X"])
    flat, unravel = travel(case["p_t"])
    x = flat.clone().requires_grad_(True)
    sol = tude.solve(tude.ODEProblem(case["rhs_t"], X[0], (0.0, 3.0), unravel(x)),
                     tude.Tsit5(), saveat=ts, rtol=TOL, atol=TOL, adjoint=adjoint)
    assert bool(sol.success)
    (g,) = torch.autograd.grad(torch.mean((sol.ys - X) ** 2), x)
    return g.numpy()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def discrete_grad(lv_case):
    return _torch_grad(lv_case, tude.DiscreteAdjoint())


@pytest.mark.parametrize("name,seminorm", [
    ("InterpolatingAdjoint", False), ("InterpolatingAdjoint", True),
    ("BacksolveAdjoint", False), ("BacksolveAdjoint", True),
    ("QuadratureAdjoint", False),
])
def test_lv_gradient_matches_jax_and_discrete(lv_case, discrete_grad, name, seminorm):
    g_t = _torch_grad(lv_case, getattr(tude, name)(seminorm=seminorm))
    g_j = _jax_grad(lv_case, getattr(jude, name)(seminorm=seminorm))
    assert g_t.shape == g_j.shape == (87,)
    assert _rel(g_t, g_j) <= 1e-7
    assert _rel(g_t, discrete_grad) <= 1e-5


def _torch_loss(case, adjoint=None):
    ts, X = torch.tensor(case["ts"]), torch.tensor(case["X"])
    _, unravel = travel(case["p_t"])

    def loss(x):
        sol = tude.solve(tude.ODEProblem(case["rhs_t"], X[0], (0.0, 3.0), unravel(x)),
                         tude.Tsit5(), saveat=ts, rtol=TOL, atol=TOL, adjoint=adjoint)
        return torch.mean((sol.ys - X) ** 2)

    return loss


def test_func_grad_through_the_default_adjoint_matches_jax(lv_case):
    # torch.func.grad of the loss through solve()'s default adjoint
    # (InterpolatingAdjoint) against jax.grad through JAX's default, 1e-7 relative
    g_t = torch.func.grad(_torch_loss(lv_case))(travel(lv_case["p_t"])[0]).numpy()
    assert _rel(g_t, _jax_grad(lv_case, None)) <= 1e-7


def test_func_grad_through_checkpointed_discrete_adjoint_matches_jax(lv_case, discrete_grad):
    # DiscreteAdjoint() checkpoints its attempts (checkpoint=True), whose
    # saved-tensor hooks torch.func.grad refuses; under the transform the loop
    # runs uncheckpointed and gives jax.grad's gradient (1e-9 relative) and
    # torch.autograd's checkpointed one
    assert tude.DiscreteAdjoint().checkpoint
    flat = travel(lv_case["p_t"])[0]
    g_t = torch.func.grad(_torch_loss(lv_case, tude.DiscreteAdjoint()))(flat).numpy()
    assert _rel(g_t, _jax_grad(lv_case, jude.DiscreteAdjoint())) <= 1e-9
    assert _rel(g_t, discrete_grad) <= 1e-12


@pytest.mark.parametrize("transform", ["vmap", "jacfwd"])
def test_unsupported_transforms_raise_a_named_error(lv_case, transform):
    # jacfwd: the continuous adjoints have no forward-mode rule (nor has JAX's
    # custom_vjp), and the error names the adjoint to use instead.  vmap raised
    # here too until the stepping loop and the adjoints' backward pass became
    # vmap-safe; it now holds parity: two parameter lanes through the default
    # adjoint give jax.vmap's losses (1e-9) and gradients (1e-7 relative)
    flat = travel(lv_case["p_t"])[0]
    if transform == "jacfwd":
        with pytest.raises(NotImplementedError, match="ForwardSensitivity"):
            torch.func.jacfwd(_torch_loss(lv_case))(flat)
        return
    g_t, l_t = torch.func.vmap(torch.func.grad_and_value(_torch_loss(lv_case)))(
        torch.stack([flat, 1.05 * flat]))
    ts, X = jnp.asarray(lv_case["ts"]), jnp.asarray(lv_case["X"])
    flat_j, unravel_j = jravel(lv_case["p_j"])

    def loss_j(x):
        sol = jude.solve(jude.ODEProblem(lv_case["rhs_j"], X[0], (0.0, 3.0), unravel_j(x)),
                         jude.Tsit5(), saveat=ts, rtol=TOL, atol=TOL)
        return jnp.mean((sol.ys - X) ** 2)

    l_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(loss_j)))(
        jnp.stack([flat_j, 1.05 * flat_j]))
    assert _rel(l_t.numpy(), np.asarray(l_j)) <= 1e-9
    assert _rel(g_t.numpy(), np.asarray(g_j)) <= 1e-7


ADJOINTS = ["InterpolatingAdjoint", "QuadratureAdjoint", "BacksolveAdjoint"]


def _blowup(p, t1, tol, adjoint, out):
    # du = p·u² has u(t) = 1/(1 - p t): it blows up at t = 1/p
    sol = tude.solve(tude.ODEProblem(lambda t, y, q: q * y * y, torch.ones(1, dtype=F64),
                                     (0.0, t1), p), tude.Tsit5(),
                     saveat=torch.linspace(0.0, t1, 5, dtype=F64), rtol=tol, atol=1e-2 * tol,
                     adjoint=adjoint, max_steps=256)
    return sol.ys[-1].sum() if out == "ys" else sol.y_final.sum()


@pytest.mark.parametrize("name", ADJOINTS)
def test_failed_forward_poisons_continuous_adjoint(name):
    # mirrors tests/test_adjoint.py::test_failed_forward_poisons_continuous_adjoint:
    # the forward fails before t1 = 2 > 1/p, so the backward pass never runs
    # and the gradient is NaN
    p = torch.tensor(2.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(_blowup(p, 2.0, 1e-6, getattr(tude, name)(), "ys"), p)
    assert bool(torch.isnan(g))


@pytest.mark.parametrize("out", ["ys", "y_final"])
@pytest.mark.parametrize("name", ADJOINTS)
def test_healthy_path_and_missing_cotangent_is_zero(name, out):
    # the loss reads only ys (y_final's cotangent is None) or only y_final
    # (ys' cotangent is None); analytic: du(T)/dp = T / (1 - p T)^2 = 1 at T = 1/4
    p = torch.tensor(2.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(_blowup(p, 0.25, 1e-8, getattr(tude, name)(), out), p)
    np.testing.assert_allclose(float(g), 1.0, rtol=1e-5)


def test_segment_budget_exhaustion_poisons_the_gradient():
    # a backward segment that runs out of steps returns NaN, not a silently
    # truncated gradient (the JAX package's ``ok`` poisoning)
    p = torch.tensor(2.0, dtype=F64, requires_grad=True)
    adjoint = tude.InterpolatingAdjoint(segment_max_steps=2)
    (g,) = torch.autograd.grad(_blowup(p, 0.25, 1e-10, adjoint, "ys"), p)
    assert bool(torch.isnan(g))


@pytest.mark.parametrize("name", ADJOINTS)
def test_non_float_args_raise_a_named_type_error(name):
    args = (torch.tensor(2.0, dtype=F64), torch.tensor(3))
    prob = tude.ODEProblem(lambda t, y, a: -a[0] * y, torch.ones(2, dtype=F64), (0.0, 1.0),
                           args)
    with pytest.raises(TypeError, match="floating-point"):
        tude.solve(prob, tude.Tsit5(), adjoint=getattr(tude, name)())
