"""PyTorch port: the fused reaction+stencil RHS against the JAX package.

The same numpy inputs go through ``updet_rhs_xla`` / the Pallas kernels (in
interpret mode) and through the port's ``updet_rhs_torch``, the wrapper
``fused_updet_rhs`` (which takes the plain version for CPU tensors) and the
``FusedUpdetRHS`` autograd function.  Tolerances: 2e-5 in float32, the
bound of ``tests/test_ops_misc.py``.  The CUDA kernel's own tests are in
``tests/test_torch_cuda.py``, which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_differential_equations_torch.ops import stencil as tst
from universal_differential_equations_tpu.ops import (
    fused_updet_rhs as jax_fused,
    fused_updet_rhs_gridded as jax_gridded,
    updet_rhs_xla,
)

torch.set_num_threads(1)

PAPER = (1, 10, 20, 10, 1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, n, sizes=PAPER, rows=None, dtype=np.float32):
    """u, taps, d0 and [(w (h_in, h_out), b)] from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    shape = (n,) if rows is None else (rows, n)
    u = rng.uniform(size=shape).astype(dtype)
    taps = np.array([6.25, -12.5, 6.25], dtype)
    d0 = np.asarray(0.7, dtype)
    mlp = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        lim = np.sqrt(6.0 / (n_in + n_out))
        mlp.append((rng.uniform(-lim, lim, (n_in, n_out)).astype(dtype),
                    (0.1 * rng.standard_normal(n_out)).astype(dtype)))
    return u, taps, d0, mlp


def _to_jax(u, taps, d0, mlp):
    return (jnp.asarray(u), jnp.asarray(taps), jnp.asarray(d0),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in mlp])


def _to_torch(u, taps, d0, mlp, device="cpu"):
    t = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
    return t(u), t(taps), t(d0), [(t(w), t(b)) for w, b in mlp]


def _flat(mlp):
    return [x for wb in mlp for x in wb]


@pytest.mark.parametrize("n", [26, 1024])
def test_updet_rhs_torch_matches_xla(n):
    args = _inputs(0, n)
    ref = np.asarray(updet_rhs_xla(*_to_jax(*args)))
    out = tst.updet_rhs_torch(*_to_torch(*args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_updet_rhs_torch_matches_pallas_kernel_interpret():
    # K1: the single-block Pallas kernel (N % 1024 == 0), interpret mode
    args = _inputs(1, 2048)
    ref = np.asarray(jax_fused(*_to_jax(*args), interpret=True))
    out = tst.fused_updet_rhs(*_to_torch(*args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_updet_rhs_torch_matches_pallas_gridded_interpret():
    # K2: the blocked Pallas kernel with its halo table, 4 blocks of 1024
    args = _inputs(2, 4096)
    ref = np.asarray(jax_gridded(*_to_jax(*args), block_size=1024, interpret=True))
    out = tst.fused_updet_rhs(*_to_torch(*args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def _wrap_case(n, pick, device="cpu"):
    """One-hot entries at 0 and N-1, a zero MLP and a pure neighbour pick."""
    u = np.zeros(n, np.float32)
    u[0], u[-1] = 1.0, 2.0
    taps = np.array([1.0, 0.0, 0.0] if pick == "left" else [0.0, 0.0, 1.0], np.float32)
    mlp = [(np.zeros((1, 1), np.float32), np.zeros(1, np.float32))]
    expect = np.roll(u, 1 if pick == "left" else -1)
    return _to_torch(u, taps, np.float32(1.0), mlp, device), expect


@pytest.mark.parametrize("n", [26, 2048])
@pytest.mark.parametrize("pick", ["left", "right"])
def test_periodic_wrap(n, pick):
    args, expect = _wrap_case(n, pick)
    np.testing.assert_array_equal(tst.fused_updet_rhs(*args).numpy(), expect)


def test_wrapper_rows_are_independent_periodic_lines():
    u, taps, d0, mlp = _to_torch(*_inputs(3, 1024, rows=8))
    out = tst.fused_updet_rhs(u, taps, d0, mlp)
    for r in range(8):
        np.testing.assert_array_equal(out[r].numpy(),
                                      tst.updet_rhs_torch(u[r], taps, d0, mlp).numpy())


@pytest.mark.parametrize("case", ["taps", "d0", "chain", "last", "dtype", "ndim"])
def test_wrapper_rejects_bad_inputs(case):
    u, taps, d0, mlp = _to_torch(*_inputs(4, 64, sizes=(1, 3, 1)))
    if case == "taps":
        taps = taps[:2]
    elif case == "d0":
        d0 = torch.ones(2)
    elif case == "chain":
        mlp = [mlp[0], (torch.zeros(4, 1), torch.zeros(1))]
    elif case == "last":
        mlp = [mlp[0], (torch.zeros(3, 2), torch.zeros(2))]
    elif case == "dtype":
        taps = taps.double()
    elif case == "ndim":
        u = u.reshape(4, 4, 4)
    with pytest.raises((ValueError, TypeError)):
        tst.fused_updet_rhs(u, taps, d0, mlp)


def test_fused_jvp_and_grad_match_jax_fused_model():
    # mirrors test_model_rhs_fused_dispatch_is_differentiable: the JAX model
    # routed through its Pallas custom_jvp (interpret mode) against the port's
    # FusedUpdetRHS, both AD modes, same numpy inputs and weights
    from universal_differential_equations_tpu.models import fisher_kpp as jfk
    from universal_differential_equations_torch.convert import params_from_jax
    from universal_differential_equations_torch.models import fisher_kpp as tfk

    rhs_j, params_j = jfk.make_model(jax.random.PRNGKey(7), "small", dtype=jnp.float32)
    rng = np.random.default_rng(7)
    u_np = rng.uniform(size=1024).astype(np.float32)
    tan_np = rng.standard_normal(1024).astype(np.float32)
    u_j = jnp.asarray(u_np)

    def loss_j(p):
        return jnp.sum(rhs_j(0.0, u_j, p) ** 2)

    jfk._FUSED_INTERPRET = True
    try:
        g_j = jax.grad(loss_j)(params_j)
        _, jvp_j = jax.jvp(lambda uu: rhs_j(0.0, uu, params_j), (u_j,), (jnp.asarray(tan_np),))
    finally:
        jfk._FUSED_INTERPRET = False

    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    rx = tfk.MLP([1, 3, 1], activation="tanh")

    def rhs_t(u, p):
        return tst.FusedUpdetRHS.apply(u, p["w"], p["D0"], *_flat(rx.as_matmul_params(p["rx"])))

    leaves = [params_t["D0"], params_t["rx"][0]["b"], params_t["rx"][0]["w"],
              params_t["rx"][1]["b"], params_t["rx"][1]["w"], params_t["w"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    u_t = torch.tensor(u_np)
    grads = torch.autograd.grad(torch.sum(rhs_t(u_t, params_t) ** 2), leaves)
    ref = jax.tree.leaves(g_j)  # sorted-key order: D0, rx[0].b, rx[0].w, ...
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    p_plain = params_from_jax(jax.tree.map(np.asarray, params_j))
    _, jvp_t = torch.func.jvp(lambda uu: rhs_t(uu, p_plain), (u_t,), (torch.tensor(tan_np),))
    np.testing.assert_allclose(jvp_t.numpy(), np.asarray(jvp_j), rtol=1e-5, atol=1e-5)


def test_fused_autograd_function_gradcheck_f64():
    u, taps, d0, mlp = _to_torch(*_inputs(5, 32, sizes=(1, 4, 3, 1), dtype=np.float64))
    inputs = [t.requires_grad_(True) for t in (u, taps, d0, *_flat(mlp))]
    assert torch.autograd.gradcheck(tst.FusedUpdetRHS.apply, inputs,
                                    check_forward_ad=True)


def test_fused_forward_ad_matches_plain_jvp_f64():
    import torch.autograd.forward_ad as fwAD

    u, taps, d0, mlp = _to_torch(*_inputs(6, 40, sizes=(1, 5, 1), dtype=np.float64))
    rng = np.random.default_rng(60)
    tangents = [torch.tensor(rng.standard_normal(t.shape)) for t in (u, taps, d0, *_flat(mlp))]
    primals = (u, taps, d0, *_flat(mlp))
    with fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in zip(primals, tangents)]
        out = fwAD.unpack_dual(tst.FusedUpdetRHS.apply(*duals)).tangent
    plain = lambda u_, t_, d_, *f: tst.updet_rhs_torch(u_, t_, d_, tst._pairs(f))  # noqa: E731
    _, ref = torch.func.jvp(plain, primals, tuple(tangents))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def test_fused_vmap_rule_sends_a_batch_of_states_as_rows():
    u, taps, d0, mlp = _to_torch(*_inputs(8, 128, rows=5))
    out = torch.func.vmap(lambda uu: tst.FusedUpdetRHS.apply(uu, taps, d0, *_flat(mlp)))(u)
    np.testing.assert_array_equal(out.numpy(), tst.updet_rhs_torch(u, taps, d0, mlp).numpy())
    # per-row weights have no kernel: the rule refuses them
    with pytest.raises(NotImplementedError):
        torch.func.vmap(lambda tt: tst.FusedUpdetRHS.apply(u[0], tt, d0, *_flat(mlp)))(
            taps.expand(2, 3))
