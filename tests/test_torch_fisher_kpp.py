"""PyTorch port: the Fisher-KPP model and its LM training against JAX (slice A).

Parameters come from the JAX package (``make_model`` with a PRNG key) and
reach the port through ``convert.params_from_jax``; data and states are the
same numpy arrays.  Everything here runs in float64: Jacobians agree to 1e-7
and two LM iterations to 1e-6 relative.  The model on the CUDA kernel is
tested in ``tests/test_torch_cuda.py``.
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
from universal_differential_equations_torch.models import fisher_kpp as tfk
from universal_differential_equations_tpu.models import fisher_kpp as jfk

torch.set_num_threads(1)

F64 = torch.float64
VARIANTS = ["mlp", "small", "small7", "small4", "fourier", "fourier5", "fourier7"]


@pytest.fixture(scope="module")
def data():
    """Truth snapshots from the JAX package, float64: (ts, ys) as numpy."""
    ts, ys = jfk.generate_data(dtype=jnp.float64)
    return np.asarray(ts), np.asarray(ys)


def _models(variant, seed=3, dtype=F64, device=None):
    rhs_j, p_j = jfk.make_model(jax.random.PRNGKey(seed), variant, dtype=jnp.float64)
    rhs_t, _ = tfk.make_model(torch.Generator().manual_seed(seed), variant, dtype=dtype,
                              device=device)
    p_t = tude.params_from_jax(jax.tree.map(np.asarray, p_j), device=device, dtype=dtype)
    return rhs_j, p_j, rhs_t, p_t


def _residuals(pkg, fk, rhs, ts, ys, cat, where):
    """The LM residuals of examples/fisher_kpp/fisher_kpp.py:69-79."""
    def residuals(p):
        sol = pkg.solve(
            pkg.ODEProblem(rhs, ys[0], (0.0, fk.T_END), p), pkg.Tsit5(),
            saveat=ts, rtol=1e-4, atol=1e-6,
            adjoint=pkg.ForwardSensitivity(), max_steps=192,
        )
        pen = (fk.zero_sum_penalty(p) + 1e-30) ** 0.5
        r = cat([(sol.ys - ys).reshape(-1), pen[None]])
        return where(sol.success, r, float("inf"))
    return residuals


def _jax_residuals(rhs, data):
    ts, ys = (jnp.asarray(a) for a in data)
    return _residuals(jude, jfk, rhs, ts, ys, jnp.concatenate, jnp.where)


def _torch_residuals(rhs, data, device=None, dtype=F64):
    ts, ys = (torch.tensor(a, device=device, dtype=dtype) for a in data)
    return _residuals(tude, tfk, rhs, ts, ys, torch.cat, torch.where)


@pytest.mark.parametrize("variant", ["mlp", "fourier"])
def test_params_from_jax_keep_names_layouts_and_flat_order(variant):
    _, p_j, _, p_t = _models(variant)
    _, p_fresh = tfk.make_model(torch.Generator().manual_seed(0), variant, dtype=F64)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(jax.tree.map(np.asarray, p_j)) == shapes(p_t) == shapes(p_fresh)
    np.testing.assert_array_equal(travel(p_t)[0].numpy(), np.asarray(jravel(p_j)[0]))


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_rhs_matches_jax(variant):
    rhs_j, p_j, rhs_t, p_t = _models(variant)
    u = np.random.default_rng(11).uniform(size=jfk.NX)
    out_j = np.asarray(rhs_j(0.0, jnp.asarray(u), p_j))
    out_t = rhs_t(0.0, torch.tensor(u), p_t).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-12, atol=1e-12)
    assert float(tfk.zero_sum_penalty(p_t)) == pytest.approx(float(jfk.zero_sum_penalty(p_j)))


def test_generate_data_matches_jax(data):
    ts, ys = tfk.generate_data(dtype=F64)
    np.testing.assert_array_equal(ts.numpy(), data[0])
    np.testing.assert_allclose(ys.numpy(), data[1], rtol=1e-9, atol=1e-9)


def test_dispatch_takes_the_kernel_only_for_cuda_float32_states():
    assert not tfk._use_fused(torch.zeros(26))
    assert not tfk._use_fused(torch.zeros(1024, dtype=F64))
    assert not tfk._use_fused(torch.zeros(2, 26))


def test_residual_jacobian_matches_jax(data):
    # forward-mode sensitivities through the adaptive stepper: torch.func.jacfwd
    # against jax.jacfwd of the same residual function
    rhs_j, p_j, rhs_t, p_t = _models("small")
    x_j, unravel_j = jravel(p_j)
    res_j = _jax_residuals(rhs_j, data)
    J_j = np.asarray(jax.jacfwd(lambda x: res_j(unravel_j(x)))(x_j))
    x_t, unravel_t = travel(p_t)
    res_t = _torch_residuals(rhs_t, data)
    J_t = torch.func.jacfwd(lambda x: res_t(unravel_t(x)))(x_t).numpy()
    assert J_t.shape == J_j.shape == (data[1].size + 1, x_t.numel())
    assert np.isfinite(J_t).all()
    np.testing.assert_allclose(J_t, J_j, rtol=1e-7, atol=1e-7)


def test_lm_two_iterations_match_jax(data):
    # lam0=30: both iterations accept a step from this start (at the default
    # 1e-3 the first few are rejected and the iterates would not move), and
    # the damping keeps the normal equations well conditioned, so the 1e-10
    # Jacobian differences stay at that size in the iterates
    rhs_j, p_j, rhs_t, p_t = _models("small", seed=0)
    kw = dict(maxiters=2, lam0=30.0)
    res_j = jude.levenberg_marquardt(_jax_residuals(rhs_j, data), p_j, **kw)
    losses = []
    res_t = tude.levenberg_marquardt(_torch_residuals(rhs_t, data), p_t,
                                     callback=lambda k, loss: losses.append(float(loss)), **kw)
    assert res_t.iterations == int(res_j.iterations) == 2
    loss0 = float(jnp.sum(_jax_residuals(rhs_j, data)(p_j) ** 2))
    assert loss0 > losses[0] > losses[1]  # both steps accepted
    np.testing.assert_allclose(float(res_t.loss), float(res_j.loss), rtol=1e-6)
    np.testing.assert_allclose(float(res_t.lam), float(res_j.lam), rtol=1e-12)
    x_j = np.asarray(jravel(res_j.params)[0])
    x_t = travel(res_t.params)[0].numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-6, atol=1e-6 * np.abs(x_j).max())
